"""Device configuration of the PyTorch port (counterpart of cylon_tpu/config.py).

``GPUConfig`` takes the place of ``TPUConfig``. Without a coordinator it
names the devices of the ``world_size`` shards one process drives (the
JAX package's single-controller model):

* ``devices=[...]``: one device per shard, ``world_size = len(devices)``;
* ``device=...``: every shard on that one device (``"cpu"`` in the tests,
  or ``"cuda:0"`` to put W shards on one card);
* neither: the shards go round-robin over the visible CUDA cards. Without
  a card that is an error, never a silent move to the CPU.

With ``coordinator_address`` the process is one rank of a
``torch.distributed`` group (the ``mpirun -np N`` model of the reference,
and the JAX package's ``coordinator_address`` / ``num_processes`` /
``process_id``): it owns exactly one shard, shard ``process_id`` of
``num_processes``, on ``device=`` if given, else on
``cuda:(process_id % torch.cuda.device_count())``.

* ``coordinator_address``: ``"host:port"`` (rank 0 listens there), any
  ``torch.distributed`` init URL (``"tcp://..."``, ``"file://..."``), or
  ``"env://"`` for torch's launcher (``torchrun``), where ``num_processes``
  and ``process_id`` default to ``WORLD_SIZE`` and ``RANK`` and the card
  to ``LOCAL_RANK``;
* ``backend``: ``"nccl"`` (the default on a card) or ``"gloo"`` (the only
  one for ``device="cpu"``; on a card it stages each collective through
  the host). Nothing switches one for the other.

``mesh_shape="OxI"`` declares a logical 2-D topology over the W shards,
in both forms (outer x inner = W, or = ``num_processes``): shard ``p`` is
outer group ``p // inner``, inner index ``p % inner``, so an inner group
is a contiguous range of shards. Under ``torchrun`` a node's ranks are
consecutive, so inner is the GPUs per node and outer the nodes. Every
shuffle then runs as the two-hop exchange of parallel/topo.py. Unset, the
context reads ``CYLON_TPU_TORCH_MESH``; unset there too, it is flat.

Several shards per process (``devices=`` with a coordinator) are not
ported (ROADMAP.md A1).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .utils import envgate as _envgate

Device = Union[str, torch.device]

BACKENDS = ("nccl", "gloo")

# chunked-shuffle byte budget (parallel/shuffle.py plan_rounds): per round
# and per shard, the engine sizes bucket_cap so that
# ``world * bucket_cap * row_bytes <= budget`` and drains the table over
# ceil(hottest bucket / bucket_cap) rounds. Override per context with
# ``ctx.add_config("shuffle_byte_budget", n)``, per process with
# CYLON_TPU_TORCH_SHUFFLE_BUDGET, or per call with the ``byte_budget=``
# argument of ``Table.shuffle``.
DEFAULT_SHUFFLE_BYTE_BUDGET = 32 * 1024 * 1024


def shuffle_byte_budget(configured: Optional[object] = None) -> int:
    """The effective per-round shuffle byte budget: an explicit value wins,
    then CYLON_TPU_TORCH_SHUFFLE_BUDGET, then the module default."""
    if configured:
        return int(configured)
    env = _envgate.SHUFFLE_BUDGET.get()
    if env:
        return int(env)
    return DEFAULT_SHUFFLE_BYTE_BUDGET


# semi-join sketch filter (ops/sketch.py; table._shuffle_pair). The cap on
# one key sketch's blocked-Bloom size, in bits: 2 Mi bits = 256 KiB of
# uint32 words, the bound on what each side injects into the one sketch
# collective. The engine sizes the sketch from the build side's row count
# (sketch.BITS_PER_KEY a key) up to this cap; a saturated sketch only
# misses pruning. Override per context with ``ctx.add_config("sketch_bits",
# n)`` or per process with CYLON_TPU_TORCH_SKETCH_BITS.
DEFAULT_SKETCH_BITS = 1 << 21

# size gate: build sketches only when the filtered sides' per-shard
# exchange bytes (rows x row_bytes / world) are at least this multiple of
# the sketch collective's own bytes
SEMI_FILTER_MIN_PAYOFF = 2


def sketch_bits(configured: Optional[object] = None) -> int:
    """The semi-join sketch bit cap: an explicit value wins, then
    CYLON_TPU_TORCH_SKETCH_BITS, then the module default."""
    if configured:
        return int(configured)
    env = _envgate.SKETCH_BITS.get()
    if env:
        return int(env)
    return DEFAULT_SKETCH_BITS


def _resolve(device: Device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _need_card(what: str) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.cuda.device_count()


def init_method(address: str) -> str:
    """``"host:port"`` as a TCP init URL; an init URL as it is."""
    return address if "://" in address else f"tcp://{address}"


class GPUConfig:
    def __init__(
        self,
        device: Optional[Device] = None,
        world_size: Optional[int] = None,
        devices: Optional[Sequence[Device]] = None,
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        backend: Optional[str] = None,
        mesh_shape: Optional[str] = None,
    ):
        self.coordinator_address = coordinator_address
        self.num_processes = self.process_id = self.backend = None
        self.mesh_shape = mesh_shape
        if coordinator_address is not None:
            self._init_rank(device, world_size, devices, num_processes, process_id, backend)
        else:
            self._init_local(device, world_size, devices, num_processes, process_id, backend)
        if mesh_shape:
            from .parallel.topo import parse_mesh

            parse_mesh(str(mesh_shape), self.world_size)

    def _init_local(self, device, world_size, devices, num_processes, process_id, backend):
        """The W shards of one process: their devices, checked."""
        if num_processes is not None or process_id is not None or backend is not None:
            raise ValueError(
                "num_processes=, process_id= and backend= need a coordinator_address"
            )
        if devices is not None:
            if device is not None:
                raise ValueError("pass either device= or devices=, not both")
            if world_size is not None and int(world_size) != len(devices):
                raise ValueError(
                    f"world_size={world_size} but {len(devices)} devices given"
                )
            if not devices:
                raise ValueError("devices= must name at least one device")
            self.devices: List[Optional[torch.device]] = [_resolve(d) for d in devices]
        else:
            world = 1 if world_size is None else int(world_size)
            if world < 1:
                raise ValueError(f"world_size must be >= 1, got {world_size}")
            if device is None:
                n_cards = _need_card("GPUConfig()")
                self.devices = [torch.device("cuda", s % n_cards) for s in range(world)]
            else:
                self.devices = [_resolve(device)] * world
        self.world_size = len(self.devices)

    def _init_rank(self, device, world_size, devices, num_processes, process_id, backend):
        """One rank of a process group: its one shard's device, the group's
        size and this process's rank, and the backend, checked."""
        if devices is not None or world_size is not None:
            raise ValueError(
                "with coordinator_address each process owns one shard: the world "
                "is num_processes; devices= and world_size= do not apply"
            )
        from_env = self.coordinator_address == "env://"
        if num_processes is None and from_env:
            num_processes = os.environ.get("WORLD_SIZE")
        if process_id is None and from_env:
            process_id = os.environ.get("RANK")
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes= and process_id=")
        world, rank = int(num_processes), int(process_id)
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"process_id={rank} is not a rank of num_processes={world}")
        if device is None:
            n_cards = _need_card("GPUConfig(coordinator_address=...)")
            local = int(os.environ.get("LOCAL_RANK", rank)) if from_env else rank
            dev = torch.device("cuda", local % n_cards)
        else:
            dev = _resolve(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if backend == "nccl":
            if dev.type != "cuda":
                raise ValueError(f"backend='nccl' needs a CUDA device, got {dev}; use 'gloo'")
            if not dist.is_nccl_available():
                raise RuntimeError("backend='nccl': this PyTorch build has no NCCL")
        self.num_processes, self.process_id, self.backend = world, rank, backend
        self.devices = [dev if s == rank else None for s in range(world)]
        self.world_size = world

    @property
    def device(self) -> torch.device:
        """The first shard's device that this process owns."""
        return next(d for d in self.devices if d is not None)

    def __repr__(self):
        mesh = f", mesh_shape={self.mesh_shape!r}" if self.mesh_shape else ""
        if self.coordinator_address is not None:
            return (
                f"GPUConfig(coordinator_address={self.coordinator_address!r}, "
                f"num_processes={self.num_processes}, process_id={self.process_id}, "
                f"device={self.device}, backend={self.backend!r}{mesh})"
            )
        return f"GPUConfig(world_size={self.world_size}, devices={self.devices}{mesh})"
