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

import atexit
import threading
import weakref
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
    """The shards of this process over a ``torch.distributed`` process group.

    Process ``p`` of ``P`` owns ``L`` shards, ``[p L, (p + 1) L)``, of the
    ``W = P L`` (``GPUConfig(devices=...)``; ``L = 1`` by default). Every
    method takes and returns one tensor per owned shard, in shard order.

    ``all_to_all`` is one ``all_to_all_single`` among the processes: with
    ``L = 1`` of the equal-chunk ``[W * rows, ...]`` buffer itself, with
    ``L > 1`` of the ``L`` send buffers laid out ``[P, L_src, L_dst, rows]``
    (the chunks between this process's own shards are the block the
    collective copies locally). ``all_reduce``, ``all_gather`` and
    ``all_gather_counts`` reduce or stack the ``L`` shards' inputs first,
    then run one collective among the processes; ``all_reduce`` moves bool
    through int32 (NCCL has no bool). Host integers and objects go over
    the group itself under gloo, and over a gloo side group made once
    under NCCL (NCCL moves device memory only).

    Under a 2-D topology an inner or outer group is a set of shards that
    may lie inside one process (then its exchange is a local transpose)
    or span several: every grouped exchange, the ring's ``ppermute`` and
    the relay route their chunks through one ``all_to_all_single`` on the
    whole process group (one exchange carries every group), the chunks
    between this process's own shards by a local copy.

    A rank that leaves by an exception (a collective op's ValueError)
    destroys its groups at interpreter exit (``atexit``), before
    torch's own teardown runs, and tolerates a peer that has already gone:
    it exits with the error, not with the abort of a process group
    destroyed under a closed connection."""

    def __init__(self, config: GPUConfig):
        self.rank, self.n_procs = config.process_id, config.num_processes
        self.local = [s for s, d in enumerate(config.devices) if d is not None]
        self.devices = [config.devices[s] for s in self.local]
        self.per = len(self.local)
        self.world_size = self.n_procs * self.per
        self.device, self.backend = config.device, config.backend
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self._owns_group = not dist.is_initialized()
        if self._owns_group:
            dist.init_process_group(
                self.backend, init_method=init_method(config.coordinator_address),
                world_size=self.n_procs, rank=self.rank,
            )
        elif (dist.get_world_size(), dist.get_rank(), dist.get_backend()) != (
            self.n_procs, self.rank, self.backend
        ):
            raise ValueError(
                f"the process group of this process (world {dist.get_world_size()}, rank "
                f"{dist.get_rank()}, {dist.get_backend()}) is not the one {config!r} names"
            )
        self._host_group = dist.new_group(backend="gloo") if self.backend == "nccl" else None
        self._exit_hook = _teardown_at_exit(self)
        per_proc = self.gather_host(self.per)
        if len(set(per_proc)) != 1:
            self.finalize()
            raise ValueError(
                f"every process must own the same number of shards (len(devices=)); "
                f"the processes give {per_proc}"
            )

    def _proc(self, shard: int) -> int:
        return shard // self.per

    def _owned(self, tensors: Sequence[torch.Tensor], what: str) -> List[torch.Tensor]:
        if len(tensors) != self.per:
            owns = "one shard" if self.per == 1 else f"{self.per} shards"
            raise ValueError(f"{what}: this process owns {owns}, got {len(tensors)} tensors")
        return list(tensors)

    def _route(self, chunks, expect, crosses: bool, like: torch.Tensor, group=None):
        """Point-to-point chunks between shards: ``chunks`` (src, dst,
        tensor) from this process's shards, ``expect`` (src, dst, rows)
        into them, all of ``like``'s trailing shape and dtype. A chunk
        between two of this process's shards is a local copy; the rest ride one
        ``all_to_all_single`` on ``group`` when ``crosses`` (a fact of the
        pattern, the same on every rank), each process's chunks in (src,
        dst) order. Returns {(src, dst): tensor}."""
        got: Dict[tuple, torch.Tensor] = {}
        send: List[List[torch.Tensor]] = [[] for _ in range(self.n_procs)]
        for src, dst, t in sorted(chunks, key=lambda c: c[:2]):
            if self._proc(dst) == self.rank:
                got[(src, dst)] = t.clone()
            else:
                send[self._proc(dst)].append(t)
        if not crosses:
            return got
        remote = [e for e in sorted(expect) if self._proc(e[0]) != self.rank]
        tail = tuple(like.shape[1:])
        sizes_in = [sum(t.shape[0] for t in ts) for ts in send]
        sizes_out = [0] * self.n_procs
        for src, _dst, rows in remote:
            sizes_out[self._proc(src)] += int(rows)
        flat = [t for ts in send for t in ts]
        inp = torch.cat(flat) if flat else like.new_empty((0,) + tail)
        out = like.new_empty((sum(sizes_out),) + tail)
        dist.all_to_all_single(out, inp, output_split_sizes=sizes_out,
                               input_split_sizes=sizes_in, group=group)
        off = 0
        for src, dst, rows in remote:
            got[(src, dst)] = out[off:off + int(rows)]
            off += int(rows)
        return got

    def all_to_all(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each owned shard's ``[W * rows, ...]`` send buffer, chunk d bound
        for shard d -> its receive buffer, chunk s from shard s."""
        bufs = [b.contiguous() for b in self._owned(bufs, "all_to_all")]
        w, per = self.world_size, self.per
        if bufs[0].shape[0] % w or any(b.shape != bufs[0].shape for b in bufs):
            raise ValueError(f"all_to_all: buffers must share one [W = {w} chunks, ...] shape")
        if per == 1:
            out = torch.empty_like(bufs[0])
            dist.all_to_all_single(out, bufs[0])
            return [out]
        rows, tail = bufs[0].shape[0] // w, tuple(bufs[0].shape[1:])
        x = torch.stack([b.to(self.device) for b in bufs]).view((per, self.n_procs, per, rows) + tail)
        x = x.transpose(0, 1).contiguous()  # [P, L_src, L_dst, rows, ...]
        out = torch.empty_like(x)
        dist.all_to_all_single(out.view((-1,) + tail), x.view((-1,) + tail))
        # receive buffer of local shard j: chunks in global source order
        return [out[:, :, j].reshape((w * rows,) + tail).to(d) for j, d in enumerate(self.devices)]

    def all_to_all_grouped(self, bufs: Sequence[torch.Tensor], groups) -> List[torch.Tensor]:
        """Each owned shard's ``[len(group) * rows, ...]`` buffer, chunk a
        bound for the group's shard a -> its receive buffer, chunk a from
        the group's shard a."""
        bufs = [b.contiguous() for b in self._owned(bufs, "all_to_all_grouped")]
        of = {s: tuple(g) for g in groups for s in g}
        chunks, expect = [], []
        for s, b in zip(self.local, bufs):
            g = of[s]
            rows = b.shape[0] // len(g)
            chunks += [(s, d, b[a * rows:(a + 1) * rows]) for a, d in enumerate(g)]
            expect += [(src, s, rows) for src in g]
        crosses = any(len({self._proc(s) for s in g}) > 1 for g in groups)
        got = self._route(chunks, expect, crosses, bufs[0])
        return [torch.cat([got[(src, d)] for src in of[d]]).to(dev)
                for d, dev in zip(self.local, self.devices)]

    def ppermute(self, bufs: Sequence[torch.Tensor], perm) -> List[torch.Tensor]:
        """Each owned shard's buffer to its ``perm`` destination, and its
        source's buffer back (zeros where no pair names the shard as a
        destination)."""
        bufs = [b.contiguous() for b in self._owned(bufs, "ppermute")]
        mine = dict(zip(self.local, bufs))
        rows = bufs[0].shape[0]
        chunks = [(src, dst, mine[src]) for src, dst in perm if src in mine]
        expect = [(src, dst, rows) for src, dst in perm if dst in mine]
        crosses = any(self._proc(src) != self._proc(dst) for src, dst in perm)
        got = self._route(chunks, expect, crosses, bufs[0])
        src_of = {dst: src for src, dst in perm}
        return [got[(src_of[d], d)].to(b.device) if d in src_of else torch.zeros_like(b)
                for d, b in zip(self.local, bufs)]

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        _check_op(op)
        ts = self._owned(tensors, "all_reduce")
        is_bool = ts[0].dtype == torch.bool
        xs = [t.to(torch.int32) if is_bool else t for t in ts]
        if len(xs) == 1:
            x = xs[0].clone()
        else:  # this process's shards first, in the input's own dtype
            x = _REDUCE[op](torch.stack([t.to(self.device) for t in xs]), dim=0).to(xs[0].dtype)
        x = x.contiguous()
        dist.all_reduce(x, op=_DIST_OPS[op])
        if is_bool:
            x = x.to(torch.int64) if op == "sum" else x.to(torch.bool)
        return [x.to(d) for d in self.devices]

    def all_gather(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The owned shards' tensors -> every shard's, stacked ``[W, ...]``:
        one ``all_gather_into_tensor`` of this process's stacked shards."""
        ts = self._owned(tensors, "all_gather")
        mine = torch.stack([t.to(self.device) for t in ts]).contiguous()
        out = torch.empty(self.n_procs * mine.numel(), dtype=mine.dtype, device=mine.device)
        dist.all_gather_into_tensor(out, mine.reshape(-1))
        stacked = out.view((self.world_size,) + tuple(ts[0].shape))
        return [stacked.to(d) for d in self.devices]

    def all_gather_counts(self, local_counts) -> np.ndarray:
        """Host integers, one entry (a count or a row of counts) per owned
        shard -> every shard's, ``[W]`` or ``[W, ...]``, over gloo."""
        mine = torch.from_numpy(np.ascontiguousarray(np.asarray(local_counts, np.int64)))
        if mine.shape[:1] != (self.per,):
            owns = "one shard" if self.per == 1 else f"{self.per} shards"
            raise ValueError(f"all_gather_counts: this process owns {owns}, got "
                             f"{tuple(mine.shape)[:1]} entries")
        parts = [torch.empty_like(mine) for _ in range(self.n_procs)]
        dist.all_gather(parts, mine, group=self._host_group)
        return torch.cat(parts).numpy()

    def relay_exchange(self, mats: Dict[int, np.ndarray], relay: np.ndarray) -> Dict[int, np.ndarray]:
        """The owned shards' relay rows (``mats[s]`` destination-major,
        ``relay[s, d]`` rows for shard d) -> the rows every source relays
        to each owned shard, in source order: one host
        ``all_to_all_single`` over gloo (the group itself, or the side
        group under NCCL), the relay matrix giving the split sizes."""
        w = self.world_size
        offs = np.concatenate([np.zeros((w, 1), np.int64), np.cumsum(relay, 1)], 1)
        chunks = [(s, d, torch.from_numpy(np.ascontiguousarray(mats[s][offs[s, d]:offs[s, d + 1]])))
                  for s in self.local for d in range(w)]
        expect = [(s, d, int(relay[s, d])) for d in self.local for s in range(w)]
        got = self._route(chunks, expect, self.n_procs > 1, chunks[0][2], group=self._host_group)
        return {d: torch.cat([got[(s, d)] for s in range(w)]).numpy() for d in self.local}

    def gather_host(self, obj: Any) -> List[Any]:
        out: List[Any] = [None] * self.n_procs
        dist.all_gather_object(out, obj, group=self._host_group)
        return out

    def barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dist.barrier(group=self._host_group)

    def finalize(self) -> None:
        """Destroy the groups this communicator made."""
        if self._exit_hook is not None:
            atexit.unregister(self._exit_hook)
            self._exit_hook = None
        if self._host_group is not None:
            dist.destroy_process_group(self._host_group)
            self._host_group = None
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self._owns_group = False


def _teardown_at_exit(comm: DistCommunicator):
    """Register ``comm.finalize`` to run at interpreter exit (unregistered
    by ``finalize`` itself). The hook holds a weak reference, and any
    error it meets (a peer that has already closed its connections) is
    dropped: the process keeps the exit code its own error gave it."""
    ref = weakref.ref(comm)

    def hook():
        c = ref()
        if c is None:
            return
        try:
            c.finalize()
        except Exception:  # the peers may be gone; the exit code stands
            pass

    atexit.register(hook)
    return hook


def _mesh_spec(mesh_shape) -> str:
    """The mesh request: the config's, else CYLON_TPU_TORCH_MESH."""
    from .parallel.topo import MESH_ENV

    return str(mesh_shape) if mesh_shape else MESH_ENV.get()


_POOL_LOCK = threading.Lock()  # first use of a context's memory_pool


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
        self._memory_pool = None  # the native arena pool, made on first use
        # reclaim tier-2 spill directories orphaned by dead processes of
        # this host (pid-stamped, age-guarded; never raises)
        from .parallel.spill import reap_stale_spill

        reap_stale_spill()
        # the ops endpoint, where CYLON_TPU_TORCH_METRICS_PORT asks for it
        # (idempotent; a failed bind is reported once, never raised)
        from .obs.export import ensure_ops_server

        ensure_ops_server()

    @classmethod
    def init_distributed(cls, config: GPUConfig) -> "CylonContext":
        if not isinstance(config, GPUConfig):
            raise ValueError(
                f"init_distributed requires a GPUConfig, got {type(config)}"
            )
        if config.coordinator_address is not None:
            from .parallel.topo import parse_mesh

            # a mesh that does not fit raises before the process group is made
            parse_mesh(_mesh_spec(config.mesh_shape), config.world_size)
            return cls(config.devices, DistCommunicator(config), config.mesh_shape)
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

    @property
    def memory_pool(self):
        """The context's native arena pool for host staging buffers
        (reference ToArrowPool(ctx), ctx/arrow_memory_pool_utils.hpp; here
        native/runtime.cpp), made on first use; None under
        CYLON_TPU_TORCH_NO_NATIVE. A failed native build raises.
        ``write_csv`` resets it at the start of each native write and
        carves that write's typed staging copies from it."""
        from . import native

        if not native.enabled():
            return None
        with _POOL_LOCK:
            if self._memory_pool is None:
                self._memory_pool = native.MemoryPool()
        return self._memory_pool

    def __repr__(self):
        return (
            f"CylonContext(world_size={self.world_size}, rank={self.rank}, "
            f"devices={self.devices}, topology={self.topology})"
        )
