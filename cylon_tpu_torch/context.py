"""CylonContext of the PyTorch port (counterpart of cylon_tpu/context.py).

The context owns the device every table of it lives on. This slice runs on
one device: ``world_size > 1`` (a communicator over several cards) is the
shuffle slice's work (ROADMAP.md, queue A).
"""
from __future__ import annotations

import torch

from .config import GPUConfig


class CylonContext:
    def __init__(self, device: torch.device):
        self.device = device

    @classmethod
    def init_distributed(cls, config: GPUConfig) -> "CylonContext":
        if not isinstance(config, GPUConfig):
            raise ValueError(
                f"init_distributed requires a GPUConfig, got {type(config)}"
            )
        if config.world_size != 1:
            raise NotImplementedError(
                "world_size > 1 is not ported yet (ROADMAP.md queue A: the "
                "shuffle slice — communicator, ops/hash.py, parallel/shuffle.py)"
            )
        return cls(config.device)

    @property
    def world_size(self) -> int:
        return 1

    def __repr__(self):
        return f"CylonContext(device={self.device}, world_size={self.world_size})"
