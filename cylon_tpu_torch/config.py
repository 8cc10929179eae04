"""Device configuration of the PyTorch port (counterpart of cylon_tpu/config.py).

``GPUConfig`` takes the place of ``TPUConfig``: it names the one device a
context runs on. ``device=None`` means the first CUDA card; when no card is
present that is an error, never a silent move to the CPU. Tests ask for the
CPU explicitly with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


class GPUConfig:
    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        world_size: int = 1,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "GPUConfig(): no CUDA device is available; pass "
                    "device='cpu' to run on the CPU"
                )
            device = "cuda:0"
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.world_size = int(world_size)

    def __repr__(self):
        return f"GPUConfig(device={self.device}, world_size={self.world_size})"
