"""CylonContext of the PyTorch port (counterpart of cylon_tpu/context.py).

One process drives ``world_size`` shards, shard ``s`` on ``devices[s]``,
as the JAX package drives a mesh from one controller. The communicator is
the single-process backend: its ``all_to_all`` is a transpose of chunks
between the shards' buffers, a plain copy across devices (or within one
card, when every shard shares it). The ``torch.distributed`` backend (one
process per card, NCCL; gloo on the CPU) is ROADMAP.md queue A.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .config import GPUConfig, shuffle_byte_budget


_REDUCE = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}


class LocalCommunicator:
    """All shards in this process; collectives are copies between them."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)

    @property
    def world_size(self) -> int:
        return len(self.devices)

    def all_to_all(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``bufs[s]`` is shard s's ``[W * rows, ...]`` send buffer, chunk d
        bound for shard d. Returns W receive buffers on their shards'
        devices: chunk s of output d is chunk d of input s."""
        w = self.world_size
        if len(bufs) != w:
            raise ValueError(f"all_to_all needs {w} buffers, got {len(bufs)}")
        rows = bufs[0].shape[0] // w
        for b in bufs:
            if b.shape[0] != rows * w or b.shape[1:] != bufs[0].shape[1:]:
                raise ValueError("all_to_all buffers must share one [W * rows, ...] shape")
        return [
            torch.cat([
                bufs[s][d * rows:(d + 1) * rows].to(self.devices[d]) for s in range(w)
            ])
            for d in range(w)
        ]

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        """``tensors[s]`` is shard s's contribution (one shape for all);
        returns the elementwise ``op`` (sum, min or max) over the shards,
        one copy on each shard's device: the JAX package's
        ``lax.psum``/``pmin``/``pmax``."""
        if op not in _REDUCE:
            raise ValueError(f"all_reduce op must be one of {sorted(_REDUCE)}, got {op!r}")
        if len(tensors) != self.world_size:
            raise ValueError(f"all_reduce needs {self.world_size} tensors, got {len(tensors)}")
        dev0 = self.devices[0]
        red = _REDUCE[op](torch.stack([t.to(dev0) for t in tensors]), dim=0)
        return [red.to(d) for d in self.devices]


class CylonContext:
    def __init__(self, devices: Sequence[torch.device]):
        self.devices: List[torch.device] = list(devices)
        self.comm = LocalCommunicator(self.devices)
        self._config: Dict[str, str] = {}

    @classmethod
    def init_distributed(cls, config: GPUConfig) -> "CylonContext":
        if not isinstance(config, GPUConfig):
            raise ValueError(
                f"init_distributed requires a GPUConfig, got {type(config)}"
            )
        return cls(config.devices)

    @property
    def device(self) -> torch.device:
        """Shard 0's device."""
        return self.devices[0]

    @property
    def world_size(self) -> int:
        return len(self.devices)

    # config KV (the JAX package's add_config / get_config)
    def add_config(self, key: str, value) -> None:
        self._config[key] = str(value)

    def get_config(self, key: str, default: str = "") -> str:
        return self._config.get(key, default)

    @property
    def shuffle_byte_budget(self) -> int:
        """Per-round chunked-shuffle byte budget (config KV
        ``shuffle_byte_budget`` > config.DEFAULT_SHUFFLE_BYTE_BUDGET)."""
        return shuffle_byte_budget(self._config.get("shuffle_byte_budget"))

    def __repr__(self):
        return f"CylonContext(world_size={self.world_size}, devices={self.devices})"
