"""CylonContext of the PyTorch port (counterpart of cylon_tpu/context.py).

A context holds ``world_size`` shards, shard ``s`` on ``devices[s]``, and a
communicator that carries every cross-shard step. Two backends share one
interface, and both take and return the tensors of the shards this
process owns (``local_shards``) only:

* ``LocalCommunicator``: one process owns every shard, as the JAX package
  drives a mesh from one controller; a collective is a copy between the
  shards' buffers.
* ``DistCommunicator``: one process per shard under ``torch.distributed``
  (the reference's ``mpirun -np N``): NCCL on the cards, gloo on the CPU
  (or on a card, through the host). ``devices[s]`` is None for a shard
  another process owns.

The interface: ``all_to_all(bufs)`` (the shuffle's exchange),
``all_reduce(tensors, op)``, ``all_gather(tensors)`` (every shard's tensor
stacked on every shard: the semi-join sketches, which NCCL cannot
OR-reduce, so each rank ORs the gathered words itself, as the JAX package
does), ``all_gather_counts(local_counts)`` (host
integers that decide control flow, so that every rank takes the same
branch), ``relay_exchange(mats, relay)`` (the skew split's host relay,
parallel/spill.py: host rows regrouped by destination), ``gather_host(obj)``
(host output) and ``barrier()``. Under a 2-D topology (parallel/topo.py)
two more: ``all_to_all_grouped(bufs, groups)``, an all_to_all among each
group's members only (the two hops), and ``ppermute(bufs, perm)``, every
shard's buffer to its ring neighbour (the skew relay's ring).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .config import GPUConfig, init_method, shuffle_byte_budget, sketch_bits


_REDUCE = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}
_DIST_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _check_op(op: str) -> None:
    if op not in _REDUCE:
        raise ValueError(f"all_reduce op must be one of {sorted(_REDUCE)}, got {op!r}")


class LocalCommunicator:
    """All shards in this process; collectives are copies between them."""

    rank = 0

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

    def all_to_all_grouped(self, bufs: Sequence[torch.Tensor], groups) -> List[torch.Tensor]:
        """:meth:`all_to_all` inside each group of shards: ``bufs[s]`` holds
        ``len(group)`` chunks, chunk a bound for the group's member at
        position a; chunk b of member a's output is chunk a of member b's
        input (the JAX package's ``all_to_all`` with
        ``axis_index_groups``)."""
        if len(bufs) != self.world_size:
            raise ValueError(f"all_to_all_grouped needs {self.world_size} buffers, got {len(bufs)}")
        out: List[Optional[torch.Tensor]] = [None] * self.world_size
        for g in groups:
            rows = bufs[g[0]].shape[0] // len(g)
            for a, d in enumerate(g):
                out[d] = torch.cat([bufs[s][a * rows:(a + 1) * rows].to(self.devices[d]) for s in g])
        return out

    def ppermute(self, bufs: Sequence[torch.Tensor], perm) -> List[torch.Tensor]:
        """``perm`` ((src, dst) pairs): shard dst receives shard src's
        buffer; a shard that no pair names receives zeros (the JAX
        package's ``lax.ppermute``)."""
        if len(bufs) != self.world_size:
            raise ValueError(f"ppermute needs {self.world_size} buffers, got {len(bufs)}")
        out = [torch.zeros_like(b) for b in bufs]
        for src, dst in perm:
            out[dst] = bufs[src].to(self.devices[dst])
        return out

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        """``tensors[s]`` is shard s's contribution (one shape for all);
        returns the elementwise ``op`` (sum, min or max) over the shards,
        one copy on each shard's device: the JAX package's
        ``lax.psum``/``pmin``/``pmax``."""
        _check_op(op)
        if len(tensors) != self.world_size:
            raise ValueError(f"all_reduce needs {self.world_size} tensors, got {len(tensors)}")
        dev0 = self.devices[0]
        red = _REDUCE[op](torch.stack([t.to(dev0) for t in tensors]), dim=0)
        return [red.to(d) for d in self.devices]

    def all_gather(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``tensors[s]`` is shard s's tensor (one shape for all); returns
        them stacked ``[W, ...]``, one copy on each shard's device: the JAX
        package's ``lax.all_gather``."""
        if len(tensors) != self.world_size:
            raise ValueError(f"all_gather needs {self.world_size} tensors, got {len(tensors)}")
        dev0 = self.devices[0]
        stacked = torch.stack([t.to(dev0) for t in tensors])
        return [stacked.to(d) for d in self.devices]

    def all_gather_counts(self, local_counts) -> np.ndarray:
        """Host integers, one entry (a count or a row of counts) per shard,
        as one int64 array ``[W]`` or ``[W, ...]``."""
        out = np.asarray(local_counts, np.int64)
        if out.shape[:1] != (self.world_size,):
            raise ValueError(f"all_gather_counts needs {self.world_size} entries")
        return out

    def relay_exchange(self, mats: Dict[int, np.ndarray], relay: np.ndarray) -> Dict[int, np.ndarray]:
        """The skew relay's host regroup: ``mats[s]`` is source s's relay
        rows, destination-major (``relay[s, d]`` rows for shard d); returns
        for every shard d the ``[relay[:, d].sum(), L]`` rows bound for it,
        in source order. Slicing here, as the JAX package's ``fetch_relay``."""
        w = self.world_size
        offs = np.concatenate([np.zeros((w, 1), np.int64), np.cumsum(relay, 1)], 1)
        return {
            d: np.concatenate([mats[s][offs[s, d]:offs[s, d + 1]] for s in range(w)])
            for d in range(w)
        }

    def gather_host(self, obj: Any) -> List[Any]:
        """Every process's ``obj``, in rank order: here only this one's."""
        return [obj]

    def barrier(self) -> None:
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def finalize(self) -> None:
        pass


class DistCommunicator:
    """One shard per process over a ``torch.distributed`` process group.

    ``all_to_all`` is one ``all_to_all_single`` of the equal-chunk
    ``[W * rows, L]`` buffer; ``all_reduce`` one ``dist.all_reduce`` (bool
    through int32: NCCL has no bool). Host integers and objects go over
    the group itself under gloo, and over a gloo side group made once
    under NCCL (NCCL moves device memory only). Under a 2-D ``topology``
    one process group per inner and per outer group is made at init, every
    rank making the same ``new_group`` calls in the same order, as NCCL
    and gloo both require."""

    def __init__(self, config: GPUConfig, topology=None):
        self.rank, self.world_size = config.process_id, config.num_processes
        self.device, self.backend = config.device, config.backend
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self._owns_group = not dist.is_initialized()
        if self._owns_group:
            dist.init_process_group(
                self.backend, init_method=init_method(config.coordinator_address),
                world_size=self.world_size, rank=self.rank,
            )
        elif (dist.get_world_size(), dist.get_rank(), dist.get_backend()) != (
            self.world_size, self.rank, self.backend
        ):
            raise ValueError(
                f"the process group of this process (world {dist.get_world_size()}, rank "
                f"{dist.get_rank()}, {dist.get_backend()}) is not the one {config!r} names"
            )
        self._host_group = dist.new_group(backend="gloo") if self.backend == "nccl" else None
        self._groups: Dict[tuple, Any] = {}
        if topology is not None and topology.outer > 1 and topology.inner > 1:
            from .parallel.topo import inner_groups, outer_groups

            for g in inner_groups(topology) + outer_groups(topology):
                self._groups[g] = dist.new_group(ranks=list(g))

    def _one(self, tensors: Sequence[torch.Tensor], what: str) -> torch.Tensor:
        if len(tensors) != 1:
            raise ValueError(f"{what}: this process owns one shard, got {len(tensors)} tensors")
        return tensors[0]

    def all_to_all(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This shard's ``[W * rows, ...]`` send buffer, chunk d bound for
        shard d -> its receive buffer, chunk s from shard s."""
        buf = self._one(bufs, "all_to_all").contiguous()
        if buf.shape[0] % self.world_size:
            raise ValueError(f"all_to_all: {buf.shape[0]} rows are not W = {self.world_size} chunks")
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf)
        return [out]

    def all_to_all_grouped(self, bufs: Sequence[torch.Tensor], groups) -> List[torch.Tensor]:
        """This shard's ``[len(group) * rows, ...]`` buffer -> its receive
        buffer: one ``all_to_all_single`` on the process group of the group
        holding this rank (its ranks in ascending order, as torch orders a
        group's ranks)."""
        buf = self._one(bufs, "all_to_all_grouped").contiguous()
        g = next(tuple(g) for g in groups if self.rank in g)
        if g not in self._groups:
            raise ValueError(f"all_to_all_grouped: no process group for ranks {g}")
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=self._groups[g])
        return [out]

    def ppermute(self, bufs: Sequence[torch.Tensor], perm) -> List[torch.Tensor]:
        """This shard's buffer to its ``perm`` destination, and its
        source's buffer back (zeros where no pair names this rank as a
        destination): one ``batch_isend_irecv``, since a ring of blocking
        sends and receives deadlocks."""
        buf = self._one(bufs, "ppermute").contiguous()
        out = torch.zeros_like(buf)
        ops = [dist.P2POp(dist.isend, buf, dst) for src, dst in perm if src == self.rank]
        ops += [dist.P2POp(dist.irecv, out, src) for src, dst in perm if dst == self.rank]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [out]

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        _check_op(op)
        t = self._one(tensors, "all_reduce")
        x = t.to(torch.int32) if t.dtype == torch.bool else t.clone()
        x = x.contiguous()
        dist.all_reduce(x, op=_DIST_OPS[op])
        if t.dtype == torch.bool:
            x = x.to(torch.int64) if op == "sum" else x.to(torch.bool)
        return [x]

    def all_gather(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This shard's tensor -> every shard's, stacked ``[W, ...]``: one
        ``all_gather_into_tensor``."""
        t = self._one(tensors, "all_gather").contiguous()
        out = torch.empty(self.world_size * t.numel(), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.reshape(-1))
        return [out.view((self.world_size,) + tuple(t.shape))]

    def all_gather_counts(self, local_counts) -> np.ndarray:
        mine = torch.from_numpy(np.ascontiguousarray(np.asarray(local_counts, np.int64)))
        if mine.shape[:1] != (1,):
            raise ValueError("all_gather_counts: this process owns one shard")
        parts = [torch.empty_like(mine) for _ in range(self.world_size)]
        dist.all_gather(parts, mine, group=self._host_group)
        return torch.cat(parts).numpy()

    def relay_exchange(self, mats: Dict[int, np.ndarray], relay: np.ndarray) -> Dict[int, np.ndarray]:
        """This rank's relay rows (destination-major, ``relay[rank, d]``
        rows for shard d) -> the rows every source relays to this rank, in
        source order: one host ``all_to_all_single`` over gloo (the group
        itself, or the side group under NCCL), the relay matrix giving the
        split sizes."""
        send = torch.from_numpy(np.ascontiguousarray(mats[self.rank]))
        out = torch.empty((int(relay[:, self.rank].sum()), send.shape[1]), dtype=send.dtype)
        dist.all_to_all_single(
            out, send, output_split_sizes=[int(x) for x in relay[:, self.rank]],
            input_split_sizes=[int(x) for x in relay[self.rank]], group=self._host_group,
        )
        return {self.rank: out.numpy()}

    def gather_host(self, obj: Any) -> List[Any]:
        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self._host_group)
        return out

    def barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dist.barrier(group=self._host_group)

    def finalize(self) -> None:
        """Destroy the groups this communicator made."""
        for g in self._groups.values():
            dist.destroy_process_group(g)
        self._groups = {}
        if self._host_group is not None:
            dist.destroy_process_group(self._host_group)
            self._host_group = None
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self._owns_group = False


def _mesh_spec(mesh_shape) -> str:
    """The mesh request: the config's, else CYLON_TPU_TORCH_MESH."""
    from .parallel.topo import MESH_ENV

    return str(mesh_shape) if mesh_shape else MESH_ENV.get()


class CylonContext:
    def __init__(self, devices: Sequence[Optional[torch.device]], comm=None, mesh_shape=None):
        self.devices: List[Optional[torch.device]] = list(devices)
        self._config: Dict[str, str] = {}
        if mesh_shape:
            self._config["mesh_shape"] = str(mesh_shape)
        from .parallel.topo import parse_mesh

        #: the declared logical 2-D topology (``mesh_shape`` >
        #: CYLON_TPU_TORCH_MESH > None, flat), validated against the world
        #: size and resolved once, here; a shuffle's decision (the kill
        #: switch, the degenerate 1xN / Nx1 shapes) is
        #: ``parallel.topo.effective(ctx)``
        self.topology = parse_mesh(_mesh_spec(mesh_shape), len(self.devices))
        self.comm = LocalCommunicator(self.devices) if comm is None else comm
        #: the shard indices this process owns
        self.local_shards: List[int] = [s for s, d in enumerate(self.devices) if d is not None]
        self._finalized = False
        # reclaim tier-2 spill directories orphaned by dead processes of
        # this host (pid-stamped, age-guarded; never raises)
        from .parallel.spill import reap_stale_spill

        reap_stale_spill()

    @classmethod
    def init_distributed(cls, config: GPUConfig) -> "CylonContext":
        if not isinstance(config, GPUConfig):
            raise ValueError(
                f"init_distributed requires a GPUConfig, got {type(config)}"
            )
        if config.coordinator_address is not None:
            from .parallel.topo import parse_mesh

            topo = parse_mesh(_mesh_spec(config.mesh_shape), config.world_size)
            return cls(config.devices, DistCommunicator(config, topo), config.mesh_shape)
        return cls(config.devices, mesh_shape=config.mesh_shape)

    @property
    def device(self) -> torch.device:
        """The device of the first shard this process owns."""
        return self.devices[self.local_shards[0]]

    @property
    def world_size(self) -> int:
        return len(self.devices)

    def get_world_size(self) -> int:
        return self.world_size

    @property
    def rank(self) -> int:
        """This process's rank: 0 when one process owns every shard."""
        return self.comm.rank

    def get_rank(self) -> int:
        return self.rank

    def get_neighbours(self, include_self: bool = False) -> List[int]:
        """Reference GetNeighbours (ctx/cylon_context.cpp:87)."""
        return [i for i in range(self.world_size) if include_self or i != self.rank]

    def is_distributed(self) -> bool:
        return self.world_size > 1

    def barrier(self) -> None:
        """Reference Barrier: waits for this process's cards, then for every
        process."""
        self.comm.barrier()

    def finalize(self) -> None:
        self.comm.finalize()
        self._finalized = True

    def is_finalized(self) -> bool:
        return self._finalized

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

    @property
    def sketch_bits(self) -> int:
        """Semi-join sketch bit cap (config KV ``sketch_bits`` >
        CYLON_TPU_TORCH_SKETCH_BITS > config.DEFAULT_SKETCH_BITS)."""
        return sketch_bits(self._config.get("sketch_bits"))

    @property
    def quant_tol(self) -> float:
        """Effective lossy-wire tolerance of this context (config KV
        ``quant_tol`` > CYLON_TPU_TORCH_QUANT_TOL > 0.0, the exact wire;
        the CYLON_TPU_TORCH_NO_QUANT kill switch forces 0.0). See
        ops/quant.py for the codecs the tolerance engages."""
        from .ops.quant import tolerance

        return tolerance(self._config.get("quant_tol"))

    def __repr__(self):
        return (
            f"CylonContext(world_size={self.world_size}, rank={self.rank}, "
            f"devices={self.devices}, topology={self.topology})"
        )
