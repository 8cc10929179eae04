"""Spill tiers and the skew-adaptive round schedule (counterpart of
cylon_tpu/parallel/spill.py): one budget-driven planner for every table
that does not fit a single padded exchange.

tier 0 (device)
    The K bounded rounds of ``table._shuffle_many``; every round's
    compacted output stays on the device until the result is assembled.
    Chosen while the measured received rows fit the device spill budget.
tier 1 (host RAM)
    The same K rounds, but round r's compacted output is copied to a host
    :class:`HostArena` once round r+1 is dispatched (a pinned buffer and a
    side stream on a card), so at most two staged outputs are ever on the
    device, never the whole table.
tier 2 (disk)
    Tier 1 with ``np.memmap``-backed arenas under
    ``CYLON_TPU_TORCH_SPILL_DIR`` (or a tempdir); engaged when forced or
    when the live arena bytes pass the host budget.

The tier is chosen per shuffle from the counts the count phase already
fetched (:func:`choose_tier`).

The skew split (:func:`plan_schedule`) rides the same counts. An
equal-chunk all_to_all ships ``K x W^2 x bucket_cap`` rows however empty
the cold buckets are, so a one-hot key pays a W-fold padding tax. Where
one bucket is over 4x the mean, the schedule sizes the collective rounds
for the COLD buckets and sends each heavy bucket's rows past the quota
``K * bucket_cap`` through a host relay: extracted once on the device
(``shuffle.relay_send_slots``), copied to the host, regrouped by
destination (the communicator's ``relay_exchange``), restaged on their
owner shard. A one-hot shuffle then ships O(rows) bytes instead of
O(W x hottest bucket); the ``shuffle.skew_split`` counter fires, and a
non-skewed plan is ``plan_rounds``' own.

The host side is numpy, as in the JAX package; the device side takes
torch tensors on the table's device. Left out: the feedback re-coster's
tuned trigger and tier (A9), a caller-owned sink and the out-of-core
layers that stream through it (A7, next).
"""
from __future__ import annotations

import errno
import os
import shutil
import tempfile
import threading
import time as _time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fault import inject as _fault
from ..fault.errors import SpillIOError
from ..ops import gather as _g
from ..ops import quant as _q
from ..utils import envgate as _envgate
from ..utils.tracing import bump, gauge
from . import shuffle as _sh

TIER_HBM = 0
TIER_HOST = 1
TIER_DISK = 2

# the skew split's kill switch, the padded-plan oracle
skew_enabled, skew_disabled = _envgate.env_gate(
    "CYLON_TPU_TORCH_NO_SKEW_SPLIT",
    keyed_via="host round planning only: the schedule's (bucket_cap, K) and "
    "the relay matrix ride the call's plan; the plan fingerprint carries the "
    "gate (spill.gate_state in plan/lazy.gated_fingerprint)",
    note="=1 disables skew-adaptive round splitting (padded-plan oracle)",
)

#: a heavy bucket exceeds this multiple of the mean bucket count
SKEW_MIN_RATIO = 4
#: apply the adaptive schedule only when it cuts the decision cost >= 25%
SKEW_MIN_SAVINGS = 0.25
#: relayed bytes cross the host link twice (fetch and restage), so they
#: count double against the collective bytes they replace
RELAY_COST_FACTOR = 2.0


def forced_tier() -> Optional[int]:
    """The CYLON_TPU_TORCH_SPILL_TIER override (None: the measured decision)."""
    v = _envgate.SPILL_TIER.get()
    if v == "":
        return None
    t = int(v)
    if t not in (TIER_HBM, TIER_HOST, TIER_DISK):
        raise ValueError(f"CYLON_TPU_TORCH_SPILL_TIER must be 0/1/2, got {v!r}")
    return t


def device_spill_budget() -> Optional[int]:
    """Per-shard staged-output bytes above which a shuffle spills its rounds
    off the device (None: never, tier 0 unless forced)."""
    v = _envgate.SPILL_DEVICE_BUDGET.get()
    return int(v) if v else None


def host_spill_budget() -> Optional[int]:
    """Live host-arena bytes above which new arena growth goes to disk
    (None: unlimited host RAM)."""
    v = _envgate.SPILL_HOST_BUDGET.get()
    return int(v) if v else None


def spill_dir() -> Optional[str]:
    return _envgate.SPILL_DIR.get() or None


#: every engine spill directory is <prefix><host>-<pid>_<random>: the host
#: and pid stamp make dead-owner reclamation provable, and a shared volume
#: is reaped only by processes of the same host
SPILL_DIR_PREFIX = "cylon_spill_"
#: a dead-pid spill dir must be at least this stale before it is reaped
REAP_MIN_AGE_S = 60.0


def _host_tag() -> str:
    """This host's stamp: alphanumeric only, at most 32 characters."""
    import platform

    node = platform.node() or "host"
    tag = "".join(c for c in node if c.isalnum()).lower()
    return (tag or "host")[:32]


def reap_stale_spill(directory: Optional[str] = None, min_age_s: Optional[float] = None) -> int:
    """Remove spill directories orphaned by dead processes of this host:
    every ``<SPILL_DIR_PREFIX><host>-<pid>_*`` entry whose pid no longer
    exists and whose mtime is older than the age guard. Live pids, other
    hosts' dirs, unparseable names, fresh dirs and anything ``os.kill(pid,
    0)`` cannot prove dead stay. Called best-effort at context creation;
    returns the number removed."""
    root = directory or spill_dir() or tempfile.gettempdir()
    if min_age_s is None:
        min_age_s = REAP_MIN_AGE_S
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    reaped = 0
    now = _time.time()
    own = os.getpid()
    host = _host_tag()
    for name in names:
        if not name.startswith(SPILL_DIR_PREFIX):
            continue
        owner = name[len(SPILL_DIR_PREFIX):].split("_", 1)[0]
        if "-" not in owner:
            continue
        dir_host, pid_s = owner.rsplit("-", 1)
        if dir_host != host or not pid_s.isdigit() or int(pid_s) == own:
            continue
        try:
            os.kill(int(pid_s), 0)
            continue  # alive (or recycled): never touch it
        except ProcessLookupError:
            pass
        except OSError:
            continue  # cannot prove it dead
        path = os.path.join(root, name)
        try:
            if not os.path.isdir(path) or now - os.path.getmtime(path) < min_age_s:
                continue
        except OSError:
            continue
        shutil.rmtree(path, ignore_errors=True)
        reaped += 1
    if reaped:
        bump("shuffle.spill.reaped_dirs", rows=reaped)
    return reaped


def spill_retries() -> int:
    """Bounded-backoff retries of a failed spill write or read before the
    degradation ladder engages (CYLON_TPU_TORCH_SPILL_RETRIES, default 2)."""
    v = _envgate.SPILL_RETRIES.get()
    try:
        return max(int(v), 0) if v else 2
    except ValueError:
        return 2


#: first-retry backoff; doubles per attempt
RETRY_BACKOFF_S = 0.01


def _retry_io(what: str, fn, sink=None):
    """The spill I/O degradation ladder:

    1. retry ``fn`` up to ``spill_retries()`` times with doubling backoff
       (``shuffle.spill.io_retries``): a transient ENOSPC or EIO heals here;
    2. exhausted: where ``sink`` can move its disk arenas onto the host-RAM
       tier within the host budget (:meth:`ShardArenaSink.degrade_to_host`,
       ``shuffle.spill.tier_degraded``), do so and try once more;
    3. still failing: raise :class:`SpillIOError`, the typed query-scoped
       failure (``shuffle.spill.io_failures``). The engine closes the
       arenas, so the ledger returns to its baseline.

    Only ``OSError`` rides the ladder: a real volume failure and an
    injected seam fault look the same here."""
    retries = spill_retries()
    delay = RETRY_BACKOFF_S
    attempt = 0
    while True:
        try:
            return fn()
        except SpillIOError:
            raise  # already typed (a nested ladder gave up)
        except OSError as e:
            attempt += 1
            if attempt <= retries:
                bump("shuffle.spill.io_retries")
                _time.sleep(delay)
                delay *= 2
                continue
            if sink is not None and sink.degrade_to_host():
                bump("shuffle.spill.tier_degraded")
                try:
                    return fn()
                except OSError as e2:
                    e = e2
            bump("shuffle.spill.io_failures")
            raise SpillIOError(what, e) from e


def gate_state() -> tuple:
    """The spill component of the plan fingerprint: the forced tier and the
    skew gate (a cached executor built under one must not serve the other)."""
    return (_envgate.SPILL_TIER.get(), skew_enabled())


def choose_tier(staged_bytes: int) -> int:
    """The tier of a shuffle whose received rows stage ``staged_bytes`` per
    shard: the forced knob wins; else tier 0 while the device spill budget
    (unset: unlimited) holds, tier 1 beyond it. Tier-1 arenas promote
    themselves to disk past the host budget (:meth:`HostArena._alloc`)."""
    f = forced_tier()
    if f is not None:
        return f
    budget = device_spill_budget()
    return TIER_HBM if budget is None or staged_bytes <= budget else TIER_HOST


# ----------------------------------------------------------------------
# the skew-adaptive round schedule
# ----------------------------------------------------------------------

class RoundSchedule(NamedTuple):
    """One shuffle's planned rounds. ``relay=None`` is the uniform padded
    plan, ``plan_rounds``' own. With ``relay`` ([src, dst] rows), each
    bucket ships its first ``quota = n_rounds * bucket_cap`` rows through
    the rounds and the rest through the host relay."""

    bucket_cap: int
    n_rounds: int
    relay: Optional[np.ndarray]

    @property
    def adaptive(self) -> bool:
        return self.relay is not None

    @property
    def quota(self) -> int:
        return self.bucket_cap * self.n_rounds

    def coll_row_slots(self, world: int) -> int:
        """Global collective row slots shipped: K x W^2 x bucket_cap."""
        return self.n_rounds * world * world * self.bucket_cap

    def relay_rows(self) -> int:
        return 0 if self.relay is None else int(self.relay.sum())

    def relay_cap(self) -> int:
        """The JAX package's static per-source relay buffer rows (a power of
        two, at least 8); the port's relay buffers are exact-length."""
        if self.relay is None:
            return 0
        from ..engine import round_cap

        return round_cap(int(self.relay.sum(axis=1).max()))


def plan_schedule(
    send_counts: np.ndarray,
    row_bytes: int,
    world: int,
    byte_budget: int,
    max_rounds: int = _sh.DEFAULT_MAX_ROUNDS,
    trigger: Optional[int] = None,
) -> RoundSchedule:
    """The round schedule of a measured [src, dst] count matrix. A
    non-skewed matrix gives exactly ``plan_rounds``' (bucket_cap, K) with
    no relay. Heavy buckets (over ``SKEW_MIN_RATIO`` x the mean bucket)
    re-plan the rounds against the cold histogram and relay their tails,
    but only where that cuts the cost (collective slots +
    ``RELAY_COST_FACTOR`` x relayed rows) by ``SKEW_MIN_SAVINGS``.
    ``trigger`` (the feedback re-coster's tuned ratio) is A9's."""
    if trigger is not None:
        raise NotImplementedError(
            "plan_schedule(trigger=...): the feedback re-coster is not ported yet (ROADMAP.md: A9)")
    cap0, k0 = _sh.plan_rounds(send_counts, row_bytes, world, byte_budget, max_rounds)
    base = RoundSchedule(cap0, k0, None)
    if not skew_enabled():
        return base
    m = np.asarray(send_counts, np.int64).reshape(-1, world)
    if m.size == 0 or m.max() == 0:
        return base
    mean_bucket = -(-int(m.sum()) // m.size)
    heavy_thresh = max(SKEW_MIN_RATIO * mean_bucket, 8)
    heavy_cols = m.max(axis=0) > heavy_thresh
    if not heavy_cols.any() or heavy_cols.all():
        return base  # all heavy is uniformly large: nothing to rebalance
    cold_max = int(m[:, ~heavy_cols].max())
    clipped = np.minimum(m, max(cold_max, 1))
    cap_c, k_c = _sh.plan_rounds(clipped, row_bytes, world, byte_budget, max_rounds)
    relay = np.maximum(m - cap_c * k_c, 0)
    if int(relay.sum()) == 0:
        return base
    adaptive = RoundSchedule(cap_c, k_c, relay)
    cost_base = base.coll_row_slots(world)
    cost_adapt = adaptive.coll_row_slots(world) + RELAY_COST_FACTOR * adaptive.relay_rows()
    if cost_adapt > (1.0 - SKEW_MIN_SAVINGS) * cost_base:
        return base
    return adaptive


# ----------------------------------------------------------------------
# host and disk arenas
# ----------------------------------------------------------------------

_arena_lock = threading.Lock()
_ARENA_LIVE_BYTES = 0
_ARENA_PEAK_BYTES = 0
_ARENA_DISK_BYTES = 0
_ARENA_DISK_PEAK = 0


def _arena_adjust(delta: int) -> None:
    """Track the live arena bytes of the process; the peak is kept too."""
    global _ARENA_LIVE_BYTES, _ARENA_PEAK_BYTES
    with _arena_lock:
        _ARENA_LIVE_BYTES += delta
        _ARENA_PEAK_BYTES = max(_ARENA_PEAK_BYTES, _ARENA_LIVE_BYTES)
        live = _ARENA_LIVE_BYTES
    gauge("shuffle.spill.host_bytes", live)


def _disk_adjust(delta: int) -> None:
    """Track the memmap-backed (tier-2) part of the live arena bytes."""
    global _ARENA_DISK_BYTES, _ARENA_DISK_PEAK
    with _arena_lock:
        _ARENA_DISK_BYTES += delta
        _ARENA_DISK_PEAK = max(_ARENA_DISK_PEAK, _ARENA_DISK_BYTES)
        disk = _ARENA_DISK_BYTES
    gauge("shuffle.spill.disk_bytes", disk)


def arena_bytes() -> tuple:
    """(live, peak, disk_live, disk_peak) arena bytes of the process."""
    with _arena_lock:
        return _ARENA_LIVE_BYTES, _ARENA_PEAK_BYTES, _ARENA_DISK_BYTES, _ARENA_DISK_PEAK


class HostArena:
    """Preallocated columnar arena for spilled rows.

    ``schema``: ``[(name, np_dtype, has_valid)]``. Growth is by explicit
    :meth:`reserve` (sized from the count phase, so the steady state never
    copies) with doubling as the fallback. RAM-backed by default; buffers
    are ``np.memmap`` files under the spill dir when ``backing=TIER_DISK``
    or once the live arena bytes pass the host budget (tier 1 -> tier 2).
    Object columns stay in RAM: only fixed-width columns go to disk."""

    def __init__(self, schema: Sequence[Tuple[str, np.dtype, bool]], backing: int = TIER_HOST,
                 directory: Optional[str] = None) -> None:
        self.schema = [(n, np.dtype(d), bool(v)) for n, d, v in schema]
        self.backing = backing
        self.rows = 0
        self._cap = 0
        self._dir = directory
        self._owns_dir = False
        self._nfiles = 0
        self._bytes = 0
        self._disk = 0
        # set by to_host(): this arena left a failing volume and never
        # allocates (or budget-promotes) onto disk again
        self._no_disk = False
        # per column: [data buffer, valid buffer or None]
        self._bufs: List[List[Optional[np.ndarray]]] = [[None, None] for _ in self.schema]

    # -- allocation ----------------------------------------------------
    def _ensure_dir(self) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(
                prefix=f"{SPILL_DIR_PREFIX}{_host_tag()}-{os.getpid()}_", dir=spill_dir())
            self._owns_dir = True
        return self._dir

    def _alloc(self, dtype: np.dtype, n: int) -> np.ndarray:
        _fault.check("arena.alloc")
        if self._no_disk:
            want_disk = False
            hb = host_spill_budget()
            if hb is not None and _ARENA_LIVE_BYTES >= hb:
                # the disk escape is gone and the host budget is spent:
                # growing anyway would trade a typed query failure for a
                # host OOM, so fail through the same OSError ladder
                raise OSError(
                    errno.ENOSPC,
                    "host spill budget exhausted on a disk-degraded arena "
                    f"(CYLON_TPU_TORCH_SPILL_HOST_BUDGET={hb}, live {_ARENA_LIVE_BYTES})",
                )
        else:
            want_disk = self.backing == TIER_DISK
            if not want_disk:
                hb = host_spill_budget()
                if hb is not None and _ARENA_LIVE_BYTES >= hb:
                    want_disk = True
                    bump("shuffle.spill.tier2_promotions")
        if want_disk and dtype != np.dtype(object):
            self._nfiles += 1
            path = os.path.join(self._ensure_dir(), f"col{self._nfiles}.bin")
            return np.memmap(path, dtype=dtype, mode="w+", shape=(n,))
        return np.empty((n,), dtype)

    @staticmethod
    def _release_buf(buf) -> None:
        """Unlink a superseded memmap's file (the mapping dies with the last
        reference), so dead generations do not pile up on the volume."""
        if isinstance(buf, np.memmap):
            try:
                os.unlink(buf.filename)
            except OSError:
                pass

    def _recount_bytes(self) -> None:
        """Re-derive the live bytes from the buffers themselves."""
        total = disk = 0
        for (_name, dtype, _hv), (d, v) in zip(self.schema, self._bufs):
            if d is not None:
                total += self._cap * 8 if dtype == np.dtype(object) else d.nbytes
                if isinstance(d, np.memmap):
                    disk += d.nbytes
            if v is not None:
                total += v.nbytes
                if isinstance(v, np.memmap):
                    disk += v.nbytes
        _arena_adjust(total - self._bytes)
        _disk_adjust(disk - self._disk)
        self._bytes = total
        self._disk = disk

    def reserve(self, extra: int) -> None:
        """Ensure room for ``extra`` more rows (with the exact incoming
        total, no growth copy happens)."""
        target = self.rows + int(extra)
        if target <= self._cap:
            return
        new_cap = max(target, 2 * self._cap)
        for ci, (_name, dtype, has_valid) in enumerate(self.schema):
            old_d, old_v = self._bufs[ci]
            d = self._alloc(dtype, new_cap)
            if old_d is not None:
                d[: self.rows] = old_d[: self.rows]
                self._release_buf(old_d)
            self._bufs[ci][0] = d
            if has_valid:
                v = self._alloc(np.dtype(bool), new_cap)
                if old_v is not None:
                    v[: self.rows] = old_v[: self.rows]
                    self._release_buf(old_v)
                self._bufs[ci][1] = v
        self._cap = new_cap
        self._recount_bytes()

    def promote(self, ci: int, new_dtype) -> None:
        """Widen one column's buffer dtype in place (a later batch that
        decodes wider)."""
        name, old, has_valid = self.schema[ci]
        new_dtype = np.dtype(new_dtype)
        if new_dtype == old:
            return
        self.schema[ci] = (name, new_dtype, has_valid)
        buf = self._bufs[ci][0]
        if buf is not None:
            nb = self._alloc(new_dtype, self._cap)
            nb[: self.rows] = buf[: self.rows]
            self._release_buf(buf)
            self._bufs[ci][0] = nb
            self._recount_bytes()

    def touches_disk(self) -> bool:
        """Does this arena hold, or would its next allocation target,
        disk-backed buffers? The spill.write and spill.read seams fire only
        here: a RAM write cannot ENOSPC."""
        return self._disk > 0 or (self.backing == TIER_DISK and not self._no_disk)

    def to_host(self) -> bool:
        """Move every disk-backed buffer into RAM and pin this arena off
        disk (the tier 2 -> tier 1 degradation). False where the move
        itself fails."""
        try:
            for pair in self._bufs:
                for j in (0, 1):
                    buf = pair[j]
                    if isinstance(buf, np.memmap):
                        pair[j] = np.array(buf)
                        self._release_buf(buf)
        except OSError:
            return False
        self.backing = TIER_HOST
        self._no_disk = True
        self._recount_bytes()
        return True

    # -- data path -----------------------------------------------------
    def append_batch(self, cols: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]]) -> None:
        """Append one batch of physical columns in schema order."""
        n = len(cols[0][0]) if cols else 0
        if n == 0:
            return
        if self.touches_disk():
            _fault.check("spill.write")
        self.reserve(n)
        lo, hi = self.rows, self.rows + n
        for ci, (data, valid) in enumerate(cols):
            self._bufs[ci][0][lo:hi] = data
            vb = self._bufs[ci][1]
            if vb is not None:
                vb[lo:hi] = True if valid is None else valid
        self.rows = hi

    def columns(self) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Zero-copy live views, schema order."""
        if self._disk > 0:
            _fault.check("spill.read")
        out = []
        for ci, (_n, _d, _hv) in enumerate(self.schema):
            d, v = self._bufs[ci]
            if d is None:
                d = self._alloc(self.schema[ci][1], 0)
            out.append((d[: self.rows], v[: self.rows] if v is not None else None))
        return out

    @property
    def nbytes(self) -> int:
        return self._bytes

    def close(self) -> None:
        _arena_adjust(-self._bytes)
        _disk_adjust(-self._disk)
        self._bytes = self._disk = 0
        for pair in self._bufs:
            self._release_buf(pair[0])
            self._release_buf(pair[1])
        self._bufs = [[None, None] for _ in self.schema]
        self._cap = 0
        self.rows = 0
        if self._owns_dir and self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None
            self._owns_dir = False

    def __del__(self):  # pragma: no cover - best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


class ShardArenaSink:
    """The engine's tier-1/2 sink: one physical-encoding arena per
    destination shard; :func:`arena_result` rebuilds the device table at
    the end with the input table's dtypes and dictionaries, so a spilled
    shuffle's result equals the in-device one.

    ``quant``: ``{col_index: original np.dtype}`` of the q8 columns
    (ops/quant.py). They live in the arenas as uint8 codes, one block
    scale recorded per appended batch, and decode at rebuild. Staged
    rounds arrive encoded (codes and scales); float batches (the relay's
    decoded tails) are encoded here under their own max-abs."""

    def __init__(self, world: int, schema, backing: int, quant=None) -> None:
        self.arenas = [HostArena(schema, backing) for _ in range(world)]
        self.quant = dict(quant) if quant else {}
        #: per (shard, col): [(row_end, scale)] quantized-batch segments
        self.qsegs = [{ci: [] for ci in self.quant} for _ in range(world)]

    def accept(self, shard_cols, counts, scales=None) -> None:
        """``shard_cols[s]``: physical (data, valid) pairs of shard s's rows
        (host arrays), or None for a shard this process does not hold. A
        q8 column's data is uint8 codes with ``scales[s][ci]`` (a staged
        round) or float values to encode here (the relay).

        Runs under the degradation ladder (:func:`_retry_io`): a failed
        append rolls the arenas back to the batch boundary and retries,
        then moves the arenas to host RAM, then fails typed."""
        rows0 = [a.rows for a in self.arenas]
        qsegs0 = [{ci: len(segs) for ci, segs in per.items()} for per in self.qsegs]

        def attempt():
            for s, a in enumerate(self.arenas):
                a.rows = rows0[s]
                for ci, nseg in qsegs0[s].items():
                    del self.qsegs[s][ci][nseg:]
            self._accept_once(shard_cols, counts, scales)

        _retry_io("spill arena write", attempt, sink=self)

    def _accept_once(self, shard_cols, counts, scales=None) -> None:
        for s, cols in enumerate(shard_cols):
            if cols is None or not int(counts[s]):
                continue
            if self.quant:
                cols = list(cols)
                for ci in self.quant:
                    data, valid = cols[ci]
                    if data.dtype == np.uint8:
                        scale = float(scales[s][ci])
                    else:
                        scale = _q.np_maxabs(data)
                        data = _q.np_encode_q8(data, scale)
                        bump("shuffle.quant.spill_reencoded")
                    cols[ci] = (data, valid)
                    self.qsegs[s][ci].append((self.arenas[s].rows + int(counts[s]), scale))
            self.arenas[s].append_batch(cols)

    def dequantized_columns(self, s: int):
        """Shard ``s``'s physical columns, q8 columns decoded back to their
        float dtype segment by segment, each under its recorded scale."""
        cols = self.arenas[s].columns()
        if not self.quant:
            return cols
        out = list(cols)
        for ci, dt in self.quant.items():
            codes, valid = out[ci]
            data = np.empty(codes.shape, dt)
            lo = 0
            for end, scale in self.qsegs[s][ci]:
                data[lo:end] = _q.np_decode_q8(codes[lo:end], scale, dt)
                lo = end
            assert lo == len(codes), "quantized segment bookkeeping hole"
            out[ci] = (data, valid)
        return out

    def counts(self) -> np.ndarray:
        return np.asarray([a.rows for a in self.arenas], np.int64)

    def degrade_to_host(self) -> bool:
        """Move every disk-backed arena onto host RAM (the ladder's middle
        rung), only where the host budget can take it. True when an arena
        moved (a retry is worth making)."""
        hb = host_spill_budget()
        if hb is not None and arena_bytes()[0] > hb:
            return False
        moved = False
        for a in self.arenas:
            if a.touches_disk():
                if not a.to_host():
                    return False
                moved = True
        return moved

    def close(self) -> None:
        for a in self.arenas:
            a.close()


# ----------------------------------------------------------------------
# device -> host copies
# ----------------------------------------------------------------------

class HostCopy:
    """Device tensors on their way to the host. On a card: pinned buffers
    filled on a side stream once the producing stream reaches this point,
    so the copy overlaps the work queued behind it; the device tensors are
    held until :meth:`wait`. A CPU tensor is its own host copy."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._src = list(tensors)
        self._event = None
        dev = self._src[0].device if self._src else torch.device("cpu")
        if dev.type != "cuda":
            self._host = self._src
            return
        side = torch.cuda.Stream(device=dev)  # from torch's pool of streams
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in self._src]
            for h, t in zip(self._host, self._src):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(side)

    def wait(self) -> List[np.ndarray]:
        """The host arrays (blocks until the copy is done); the device
        tensors are released."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        self._src = []
        return [h.numpy() for h in self._host]


# ----------------------------------------------------------------------
# staging a round into the arenas, the relay, the result
# ----------------------------------------------------------------------

def _quant_parts(plan, qspec):
    """(qplan, q_cols) of the q8 host-crossing layout, or (plan, ())."""
    if qspec is None or not any(c == "q8" for c in qspec):
        return tuple(plan), ()
    return _g.quant_lane_parts(plan, qspec)


def _q8_saved(q_cols) -> int:
    """Bytes a row saves with its q8 columns as codes: 3 for a 4-byte
    column, 7 for float64."""
    return sum((8 if dt == "float64" else 4) - 1 for _ci, dt in q_cols)


def _pack_host_bound(cols, q_cols) -> List[torch.Tensor]:
    """[lane matrix [n, L] int32, q8 codes [n, nq] uint8, q8 scales [nq]]
    of one shard's device columns (the q8 layout's scales over all ``n``
    rows)."""
    lanes, codes, scales = _g.pack_cols_quant(cols, q_cols)
    n = cols[0][0].shape[0]
    mat = torch.stack(lanes, 1) if lanes else torch.zeros((n, 0), dtype=torch.int32,
                                                          device=cols[0][0].device)
    return [mat, codes, scales]


def _host_shard(qplan, q_cols, mat, codes, scales, decode: bool):
    """One shard's physical host columns from its fetched parts: q8 columns
    decoded (``decode``) or left as codes, with their scales."""
    lanes = [np.ascontiguousarray(mat[:, j]) for j in range(mat.shape[1])]
    if not q_cols:
        return _g.host_unpack_cols(qplan, lanes), {}
    pos = {ci: k for k, (ci, _dt) in enumerate(q_cols)}
    sc = {ci: float(scales[k]) for k, (ci, _dt) in enumerate(q_cols)}

    def quant(ci, dt):
        c = np.ascontiguousarray(codes[:, pos[ci]])
        return _q.np_decode_q8(c, sc[ci], dt) if decode else c

    return _g.host_unpack_cols_quant(qplan, lanes, quant), sc


class PendingStage:
    """One staged round on its way into the arenas (:func:`stage_table`);
    :meth:`land` waits for the copy and appends."""

    def __init__(self, sink, plan, q_cols, copies, counts, row_bytes):
        self.sink, self.plan, self.q_cols = sink, plan, q_cols
        self.copies, self.counts, self.row_bytes = copies, counts, row_bytes

    def land(self) -> None:
        world = len(self.sink.arenas)
        shard_cols: List[Optional[list]] = [None] * world
        scales: List[dict] = [{} for _ in range(world)]
        bump("host_sync")
        for s, copy in self.copies.items():
            mat, codes, sc = copy.wait()
            shard_cols[s], scales[s] = _host_shard(self.plan, self.q_cols, mat, codes, sc,
                                                   decode=False)
        staged = int(sum(int(self.counts[s]) for s in self.copies))
        bump("shuffle.spill.staged_rounds")
        bump("shuffle.spill.staged_bytes", rows=staged * self.row_bytes)
        if self.q_cols:
            # a q8 column stages 1 byte a row where the plain lanes take 4 or 8
            bump("shuffle.quant.spill_bytes_saved", rows=staged * _q8_saved(self.q_cols))
        self.sink.accept(shard_cols, self.counts, scales=scales if self.q_cols else None)


def stage_table(sink, plan, shard_cols: Dict[int, list], counts: np.ndarray, row_bytes: int,
                qspec=None) -> PendingStage:
    """Start staging one round: ``shard_cols[s]`` are this process's shards'
    received device columns (``counts[s]`` rows each). Each shard's
    columns leave as ONE packed ``[rows, L]`` int32 lane matrix; under the
    quantized tier (``qspec``, its 'q8' entries) a q8 column leaves as
    uint8 codes under one block scale per (shard, column), and lives in
    the arena as codes. Returns the pending copy; :meth:`PendingStage.land`
    decodes it on the host and appends it to ``sink``."""
    qplan, q_cols = _quant_parts(plan, qspec)
    copies = {s: HostCopy(_pack_host_bound(cols, q_cols)) for s, cols in shard_cols.items()}
    return PendingStage(sink, qplan, q_cols, copies, counts, row_bytes)


#: unsigned dtypes torch gathers through their signed views
_SIGNED = {torch.uint64: torch.int64, torch.uint32: torch.int32, torch.uint16: torch.int16}


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.index_select(0, idx)`` for every column dtype."""
    signed = _SIGNED.get(x.dtype)
    if signed is None:
        return x.index_select(0, idx)
    return x.view(signed).index_select(0, idx).view(x.dtype)


def relay_extract(cols, lane: torch.Tensor, base: torch.Tensor, relay_row: np.ndarray,
                  quota: int, qspec=None) -> Optional[HostCopy]:
    """Extract one source shard's relay rows (its rows past the quota of
    each heavy bucket, destination-major: ``shuffle.relay_send_slots``)
    and start their copy to the host: one packed int32 lane matrix, plus
    uint8 q8 codes under one block scale for this source under the
    quantized tier (the relay then crosses the host link at 1 byte a row
    for those columns). None where the source relays nothing."""
    n_rel = int(relay_row.sum())
    if n_rel == 0:
        return None
    slots = _sh.relay_send_slots(lane, base, relay_row, quota, n_rel).to(torch.int64)
    # each row's id at its slot; the other rows land on spare slots behind
    # (distinct ones, so their writes do not all hit one address)
    ids = torch.arange(lane.shape[0], device=lane.device)
    slots = torch.where(slots < n_rel, slots, n_rel + ids % _sh.DROP_ROWS)
    rows = torch.zeros(n_rel + _sh.DROP_ROWS, dtype=torch.int64, device=lane.device)
    idx = rows.scatter_(0, slots, ids)[:n_rel]
    sel = [(_take(d, idx), None if v is None else v.index_select(0, idx)) for d, v in cols]
    _qplan, q_cols = _quant_parts(_g.lane_plan(cols), qspec)
    return HostCopy(_pack_host_bound(sel, q_cols))


def fetch_relay(comm, plan, copies: Dict[int, HostCopy], relay: np.ndarray, local: Sequence[int],
                qspec=None):
    """Fetch the relay extractions of this process's sources and regroup the
    rows by destination shard (``comm.relay_exchange``: slicing in one
    process, one host all_to_all across processes). Q8 columns decode here,
    so a relayed row pays one lossy crossing. Returns ``(per_dst_cols,
    per_dst_counts)``: ``per_dst_cols[d]`` holds the physical (data, valid)
    pairs of every row relayed to shard d (None for a shard without rows
    or not held here), in source order."""
    qplan, q_cols = _quant_parts(plan, qspec)
    bump("host_sync")
    mats: Dict[int, np.ndarray] = {}
    for s in local:
        n_s = int(relay[s].sum())
        if copies.get(s) is None:
            mats[s] = np.zeros((n_s, sum(nl + hv for _dt, nl, hv in plan)), np.int32)
            continue
        mat, codes, sc = copies[s].wait()
        if q_cols:
            cols, _sc = _host_shard(qplan, q_cols, mat, codes, sc, decode=True)
            mat = _g.host_pack_cols(cols)
        mats[s] = mat
    if q_cols:
        bump("shuffle.quant.relay_bytes_saved", rows=int(relay.sum()) * _q8_saved(q_cols))
    got = comm.relay_exchange(mats, relay)
    per_dst: List[Optional[list]] = [None] * len(relay)
    for d, mat in got.items():
        if len(mat):
            per_dst[d] = _g.host_unpack_cols(
                plan, [np.ascontiguousarray(mat[:, j]) for j in range(mat.shape[1])])
    counts = relay.sum(axis=0).astype(np.int64)
    bump("shuffle.skew_split", rows=int(counts.sum()))
    return per_dst, counts


def shards_to_table(template, per_shard_cols, counts: np.ndarray):
    """A device table from per-destination physical host columns, with
    ``template``'s dtypes and dictionaries (the relay and the arenas both
    land here). ``per_shard_cols[s]`` None: shard s has no rows here."""
    from collections import OrderedDict

    from ..table import Table

    ctx = template.ctx
    names = template.column_names
    ref = template._ref
    shards: List[Optional[dict]] = [None] * ctx.world_size
    for s in ctx.local_shards:
        od = OrderedDict()
        got = per_shard_cols[s]
        for ci, name in enumerate(names):
            meta = ref[name]
            if got is None:
                data, valid = np.empty((0,), meta.dtype.physical_dtype), None
            else:
                data, valid = got[ci]
            od[name] = (data, valid, meta.dtype, meta.dictionary)
        shards[s] = od
    return Table.from_encoded_shards(ctx, shards, counts=np.asarray(counts, np.int64))


def arena_result(sink: ShardArenaSink, template, counts: Optional[np.ndarray] = None):
    """A spilled shuffle's device table rebuilt from the sink's arenas (the
    tier-1/2 counterpart of the round concatenation; ``counts``: the
    global rows a shard, the sink's own where one process holds every
    shard). Q8 columns decode here. The read rides the degradation ladder;
    the sink is closed on every exit, so the arena bytes return to the
    ledger's baseline."""

    def read():
        per_shard = [sink.dequantized_columns(s) if a.rows else None
                     for s, a in enumerate(sink.arenas)]
        return shards_to_table(template, per_shard, sink.counts() if counts is None else counts)

    try:
        return _retry_io("spill arena read", read, sink=sink)
    finally:
        sink.close()
