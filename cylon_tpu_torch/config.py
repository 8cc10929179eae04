"""Device configuration of the PyTorch port (counterpart of cylon_tpu/config.py).

``GPUConfig`` takes the place of ``TPUConfig``: it names the devices of the
``world_size`` shards a context holds, one process driving them all (the
JAX package's single-controller model).

* ``devices=[...]``: one device per shard, ``world_size = len(devices)``;
* ``device=...``: every shard on that one device (``"cpu"`` in the tests,
  or ``"cuda:0"`` to put W shards on one card);
* neither: the shards go round-robin over the visible CUDA cards. Without
  a card that is an error, never a silent move to the CPU.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

Device = Union[str, torch.device]

# chunked-shuffle byte budget (parallel/shuffle.py plan_rounds): per round
# and per shard, the engine sizes bucket_cap so that
# ``world * bucket_cap * row_bytes <= budget`` and drains the table over
# ceil(hottest bucket / bucket_cap) rounds. Override per context with
# ``ctx.add_config("shuffle_byte_budget", n)`` or per call with the
# ``byte_budget=`` argument of ``Table.shuffle``.
DEFAULT_SHUFFLE_BYTE_BUDGET = 32 * 1024 * 1024


def shuffle_byte_budget(configured: Optional[object] = None) -> int:
    """The effective per-round shuffle byte budget: an explicit value wins,
    else the module default."""
    if configured:
        return int(configured)
    return DEFAULT_SHUFFLE_BYTE_BUDGET


def _resolve(device: Device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class GPUConfig:
    def __init__(
        self,
        device: Optional[Device] = None,
        world_size: Optional[int] = None,
        devices: Optional[Sequence[Device]] = None,
    ):
        if devices is not None:
            if device is not None:
                raise ValueError("pass either device= or devices=, not both")
            if world_size is not None and int(world_size) != len(devices):
                raise ValueError(
                    f"world_size={world_size} but {len(devices)} devices given"
                )
            if not devices:
                raise ValueError("devices= must name at least one device")
            self.devices: List[torch.device] = [_resolve(d) for d in devices]
        else:
            world = 1 if world_size is None else int(world_size)
            if world < 1:
                raise ValueError(f"world_size must be >= 1, got {world_size}")
            if device is None:
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "GPUConfig(): no CUDA device is available; pass "
                        "device='cpu' to run on the CPU"
                    )
                n_cards = torch.cuda.device_count()
                self.devices = [torch.device("cuda", s % n_cards) for s in range(world)]
            else:
                self.devices = [_resolve(device)] * world
        self.world_size = len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first shard's device."""
        return self.devices[0]

    def __repr__(self):
        return f"GPUConfig(world_size={self.world_size}, devices={self.devices})"
