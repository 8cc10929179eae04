"""Critical-path profiler: per-stage, per-shard stage clocks, the
straggler ledger, and longest-path attribution over span trees
(counterpart of cylon_tpu/obs/prof.py).

HOW THE CLOCKS WORK. The engine already holds on the host everything a
stage clock needs:

- the per-shard, per-stage WORK each stage performed: the measured
  ``[src, dst]`` count matrix of the shuffle's count phase (B2a/B2b's
  pack scans ``local_rows`` a round, the collective ships ``K x world x
  cap`` slots a shard, B3's compact front-packs ``received_rows``, the
  skew relay crosses the host with its tail), fetched once before any
  round;
- the WINDOW the stages ran in: on a card, the device milliseconds
  between two CUDA events recorded on the stream at the
  exchange's start and just before its one deferred count read (that
  read passes the end event, so reading it adds no sync); on the CPU,
  the host window between the same two points. Sort and fused-join
  stages attach PENDING and resolve from the owning query's events when
  it finishes (:func:`finalize`).

A stage clock is the window apportioned over the weighted work units:
``t[stage][shard] = window * W[stage] * units[stage][shard] / total``.
The per-stage weights are calibration constants (:data:`STAGE_WEIGHTS`);
the RATIOS the ledger publishes (straggler ``max/mean`` within a stage,
stage shares along the critical path) are exact functions of the
measured counts and do not depend on them.

SURFACE:

- gauges ``prof.stage_ms.<stage>`` / ``prof.straggler_ratio[.<stage>]``
  in the rollup (exported on ``/metrics``);
- ``prof_<stage>_ms`` / ``prof_straggler`` annotations on the owning
  exchange span (rendered by ``explain(analyze=True)`` and Perfetto);
- per-shard stage tracks in the Chrome export (``obs/export.py``);
- straggler evidence journaled into the observation store
  (``obs.store.note_stages``);
- :func:`critical_path`: longest self-time root-to-leaf attribution over
  ``plan.node.*`` span trees, the ``explain(analyze=True)`` "crit %"
  column.

A two-hop shuffle (parallel/topo.py) splits the collective clock per
axis: ``coll_inner`` (the grouped inner all_to_all) and ``coll_outer``
(the combined-chunk outer all_to_all).

FAILURE DOMAIN: profiling never fails a query. Every record path runs
under the ``obs.prof`` fault seam (``fault/inject.py``) and a broad
except: a failure counts ``prof.degraded`` and turns profiling OFF for
the process (:func:`reset` re-arms).

DISABLED COST: one env read per shuffle (``profiling_active()``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..utils import envgate as _eg
from . import metrics as _metrics

#: relative per-work-unit cost of each stage (calibration constants: the
#: straggler ratios and critical-path SHARES are weight-independent within
#: a stage; the weights only arbitrate BETWEEN stages):
#:
#: - ``pack``:       2.0 per locally scanned row per round (kernel B2a's
#:                   hash and histogram pass, kernel B2b's rank-and-slot
#:                   pass);
#: - ``collective``: 1.0 per collective row slot (the all_to_all moves
#:                   every slot whether live or not, which is why a hot
#:                   bucket inflates this stage);
#: - ``compact``:    1.0 per received row (kernel B3's front-pack);
#: - ``relay``:      4.0 per relayed row: the skew tail crosses the host
#:                   twice (device->host fetch, host->device upload).
STAGE_WEIGHTS: Dict[str, float] = {
    "pack": 2.0,
    "collective": 1.0,
    "coll_inner": 1.0,
    "coll_outer": 1.0,
    "compact": 1.0,
    "relay": 4.0,
}

#: render/lay-out order of the stage tracks (pipeline order); flat
#: shuffles keep the merged ``collective`` track, so the ledger compares
#: across the CYLON_TPU_TORCH_NO_TOPO differential.
STAGE_ORDER: Tuple[str, ...] = (
    "pack", "collective", "coll_inner", "coll_outer", "compact", "relay"
)

#: the key under which a QueryTrace carries its attached StageProfiles
#: (``__``-prefixed: the exporters exclude it from plain attr rendering
#: and expand it into per-shard stage tracks instead)
PROF_ATTR = "__prof__"

_DEGRADED = [False]  # flipped by _degrade(); reset() re-arms


def profiling_active() -> bool:
    """Profiler gate: ``CYLON_TPU_TORCH_PROF`` truthy and not degraded. One
    env read — the whole disabled cost per shuffle or fused step."""
    return not _DEGRADED[0] and _eg.PROF.truthy()


def _degrade(exc: BaseException) -> None:
    """A profiler failure degrades to profiling-off for the process —
    counted, never propagated: a query must be unaffected."""
    _DEGRADED[0] = True
    _metrics.rollup_count("prof.degraded")


def degraded() -> bool:
    """Has a profiler failure flipped profiling off for the process?"""
    return _DEGRADED[0]


def reset() -> None:
    """Re-arm a degraded profiler (tests)."""
    _DEGRADED[0] = False


# ----------------------------------------------------------------------
# the stage-clock record
# ----------------------------------------------------------------------
class StageProfile:
    """One profiled execution's stage clocks: per-stage per-shard
    weighted work units plus the measured window. ``window_s`` is the
    host window (``None`` for a sort or fused profile until its query
    finishes, :func:`finalize`); ``ev0``/``ev1`` are the CUDA events
    around the stages where they ran on a card, whose device window
    wins once it can be read (:meth:`window`)."""

    __slots__ = ("kind", "world", "t0", "window_s", "units", "ev0", "ev1")

    def __init__(
        self,
        kind: str,
        world: int,
        t0: float,
        window_s: Optional[float],
        units: Dict[str, np.ndarray],
        events=(None, None),
    ):
        self.kind = kind
        self.world = int(world)
        self.t0 = float(t0)
        self.window_s = window_s
        self.units = units
        self.ev0, self.ev1 = events

    def window(self, wait: bool = False) -> Optional[float]:
        """The window in seconds: the device window of the events where
        they are readable (``wait``: wait for them, at export only), else
        the host window; None while unresolved."""
        from .trace import event_ms

        dev = event_ms(self.ev0, self.ev1, wait)
        if dev is not None:
            return dev / 1e3
        return self.window_s

    def on_device(self) -> bool:
        return self.ev0 is not None and self.ev1 is not None

    # -- derived clocks -------------------------------------------------
    def _total_units(self) -> float:
        return float(sum(u.sum() for u in self.units.values())) or 1.0

    def seconds(self, wait: bool = False) -> Dict[str, float]:
        """Global per-stage seconds: the window apportioned over the
        weighted units ({} until the window resolves)."""
        win = self.window(wait)
        if win is None:
            return {}
        tot = self._total_units()
        return {
            s: win * float(u.sum()) / tot
            for s, u in self.units.items()
        }

    def shard_seconds(self, wait: bool = False) -> Dict[str, np.ndarray]:
        """Per-stage per-shard seconds ({} until the window resolves)."""
        win = self.window(wait)
        if win is None:
            return {}
        tot = self._total_units()
        return {
            s: win * u / tot for s, u in self.units.items()
        }

    def stragglers(self) -> Dict[str, float]:
        """Per-stage ``max/mean`` shard-time ratio (weight-independent:
        the per-unit cost cancels within a stage). A perfectly balanced
        stage reads 1.0; a one-hot 8-way compact reads ~8."""
        out: Dict[str, float] = {}
        for s, u in self.units.items():
            mean = float(u.mean())
            if mean > 0:
                out[s] = float(u.max()) / mean
        return out

    def straggler_ratio(self) -> float:
        return max(self.stragglers().values(), default=1.0)


def shuffle_units(
    parts: Iterable[Tuple[Any, int, int, Optional[np.ndarray]]],
    world: int,
) -> Dict[str, np.ndarray]:
    """Per-shard weighted work units of one ``_shuffle_many`` call from
    its host-known plan: ``parts`` is one ``(send_counts [src, dst],
    n_rounds, bucket_cap, relay-or-None, topo_plan-or-None)`` tuple per
    shuffled table (``topo_plan`` = the two-hop ``(outer, inner, cap_o,
    n_header)`` when the 2-D topology decomposed the exchange). Pure
    numpy over counts the count phase already returned."""
    units = {s: np.zeros(world, np.float64) for s in STAGE_ORDER}
    for part in parts:
        send_counts, n_rounds, bucket_cap, relay, topo_plan = part[:5]
        m = np.asarray(send_counts, np.float64).reshape(-1, world)
        k = max(int(n_rounds), 1)
        # pack scans the local table once per round
        units["pack"] += STAGE_WEIGHTS["pack"] * k * m.sum(axis=1)
        # the collective ships K x world x cap slots per shard, uniform
        # by construction (the padding IS the skew cost). A
        # two-hop plan splits the clock per axis: the inner grouped
        # all_to_all still moves world x cap slots, the outer hop moves
        # outer x cap_o COMBINED slots (the decomposition's saving
        # reads directly off this track vs the flat world x cap).
        if topo_plan is not None:
            outer, inner, cap_o = (
                int(topo_plan[0]), int(topo_plan[1]), int(topo_plan[2])
            )
            units["coll_inner"] += (
                STAGE_WEIGHTS["coll_inner"] * k * world * int(bucket_cap)
            )
            units["coll_outer"] += (
                STAGE_WEIGHTS["coll_outer"] * k * outer * cap_o
            )
        else:
            units["collective"] += (
                STAGE_WEIGHTS["collective"] * k * world * int(bucket_cap)
            )
        # compact front-packs what each shard received
        units["compact"] += STAGE_WEIGHTS["compact"] * m.sum(axis=0)
        if relay is not None:
            r = np.asarray(relay, np.float64).reshape(-1, world)
            units["relay"] += STAGE_WEIGHTS["relay"] * r.sum(axis=0)
    return {s: u for s, u in units.items() if u.sum() > 0}


def fused_units(
    world: int,
    bucket_cap: int,
    rounds: int,
    rows_l: int,
    rows_r: int,
    join_cap: int,
) -> Dict[str, np.ndarray]:
    """Per-shard units of one fused step (the fused join, the q3
    pushdown). Only SHAPE-derived work is host-known before the step's
    read: per-shard attribution is uniform, but the stage SPLIT still
    feeds the critical path."""
    ones = np.ones(max(world, 1), np.float64)
    rows_local = float(rows_l + rows_r) / max(world, 1)
    k = max(int(rounds), 1)
    return {
        "pack": STAGE_WEIGHTS["pack"] * k * rows_local * ones,
        "collective": (
            STAGE_WEIGHTS["collective"] * k * world * int(bucket_cap) * ones
        ),
        # the fused compact + probe/emit work over the joined capacity
        "compact": STAGE_WEIGHTS["compact"] * float(join_cap) * ones,
    }


# ----------------------------------------------------------------------
# recording (the engine-facing surface; no host sync anywhere)
# ----------------------------------------------------------------------
def _attach(profile: StageProfile) -> None:
    from . import trace as _trace

    q = _trace.current()
    if q is None:
        return
    profs = q.attrs.get(PROF_ATTR)
    if profs is None:
        profs = q.attrs[PROF_ATTR] = []
    profs.append(profile)


def _emit(profile: StageProfile, q, journal: bool) -> None:
    """Publish a window-resolved profile: rollup gauges, annotations on
    the OWNING trace ``q`` (passed explicitly: a pending profile resolves
    when its query finishes), and on the inline path only (``journal``,
    where the owning exec-observation record is still the active one)
    the observation-store straggler evidence. Host dict/file work
    only."""
    from . import store as _obsstore

    secs = profile.seconds()
    ratios = profile.stragglers()
    attrs: Dict[str, float] = {}
    for s, v in secs.items():
        _metrics.rollup_value(f"prof.stage_ms.{s}", v * 1e3)
        attrs[f"prof_{s}_ms"] = round(v * 1e3, 3)
    for s, v in ratios.items():
        _metrics.rollup_value(f"prof.straggler_ratio.{s}", v)
    overall = profile.straggler_ratio()
    _metrics.rollup_value("prof.straggler_ratio", overall)
    attrs["prof_straggler"] = round(overall, 3)
    if q is not None:
        target = q._stack[-1].attrs if q._stack else q.attrs
        target.update(attrs)
    if journal:
        _obsstore.note_stages(
            {
                s: (secs.get(s, 0.0), ratios.get(s, 1.0))
                for s in profile.units
            },
        )


def record_stages(kind, units, world, t0, t_dev, events=(None, None)) -> None:
    """Stage clocks for one execution whose window ``[t0, t_dev]`` is
    ALREADY host-known (its owning host read returned before this call;
    ``events``, where the stages ran on a card, were recorded on the
    stream before that read, so they have completed): pure arithmetic,
    no fetch."""
    if not profiling_active():
        return
    try:
        from .. import fault as _fault
        from . import trace as _trace

        _fault.inject.check("obs.prof")
        units = {
            s: np.asarray(u, np.float64)
            for s, u in units.items()
            if float(np.asarray(u).sum()) > 0
        }
        if not units:
            return
        profile = StageProfile(
            kind, world, t0, max(t_dev - t0, 1e-9), units, events,
        )
        # inline: the current trace IS the owning query and the active
        # exec-observation record is its own — annotate AND journal
        _emit(profile, _trace.current(), journal=True)
        _attach(profile)
    except Exception as e:  # profiling must never fail a query
        _degrade(e)


def record_shuffle(parts, world, t0, t_dev, events=(None, None)) -> None:
    """Stage clocks for one eager K-round shuffle, called by
    ``table._shuffle_many_rounds`` AFTER its one deferred round-count
    read returned: the window ``[t0, t_dev]`` (and the events around the
    rounds, which that read passed) and the count matrices are all
    host-known."""
    if not profiling_active():
        return
    try:
        units = shuffle_units(parts, world)
    except Exception as e:
        _degrade(e)
        return
    record_stages("shuffle", units, world, t0, t_dev, events)


def record_fused(units: Dict[str, np.ndarray], world: int, t0: float, ev0=None) -> None:
    """Stage clocks for one fused step (the q3 pushdown). Its window is
    not known here; the profile attaches to the active query trace
    PENDING and :func:`finalize` resolves it when the query finishes
    (``ev0``: the CUDA event recorded at ``t0``, on a card). No active
    trace, no resolution point: the record is skipped."""
    if not profiling_active():
        return
    try:
        from .. import fault as _fault
        from . import trace as _trace

        _fault.inject.check("obs.prof")
        if _trace.current() is None:
            return
        units = {
            s: np.asarray(u, np.float64)
            for s, u in units.items()
            if float(np.asarray(u).sum()) > 0
        }
        if not units:
            return
        _attach(StageProfile("fused", world, t0, None, units, (ev0, None)))
    except Exception as e:
        _degrade(e)


def record_sort(
    impl: str, passes: int, rows: int, world: int, t0: float, ev0=None
) -> None:
    """Per-pass stage clocks for one sort: work units are ``passes x
    rows`` of kernel K1's one-sweep passes (stage key ``sort.<impl>``,
    ``prof.stage_ms.sort.radix``), pending like :func:`record_fused`
    until the query finishes. Per-shard attribution is uniform."""
    if not profiling_active():
        return
    try:
        from .. import fault as _fault
        from . import trace as _trace

        _fault.inject.check("obs.prof")
        if _trace.current() is None:
            return
        if passes <= 0 or rows <= 0:
            return
        units = {
            f"sort.{impl}": float(passes) * float(rows)
            * np.ones(max(world, 1), np.float64)
        }
        _attach(StageProfile("sort", world, t0, None, units, (ev0, None)))
    except Exception as e:
        _degrade(e)


def finalize(q) -> None:
    """Resolve any window-pending profiles on a finishing query trace
    (called from ``obs.trace._maybe_finish`` before the trace is
    exported): the host window runs from the profile's start to the
    query's resolution; on a card the device window from the profile's
    start event to the query's end event, read once it has completed.
    The clocks annotate ``q`` itself; no store journaling (the owning
    exec record has closed, and the per-shard units are uniform)."""
    profs = q.attrs.get(PROF_ATTR)
    if not profs:
        return
    try:
        end = q.resolved if q.resolved is not None else q.t1
        for p in profs:
            if p.window_s is not None or end is None:
                continue
            p.window_s = max(end - p.t0, 1e-9)
            if p.ev0 is not None:
                p.ev1 = q.ev1
            _emit(p, q, journal=False)
    except Exception as e:
        _degrade(e)


# ----------------------------------------------------------------------
# critical-path analysis over span trees
# ----------------------------------------------------------------------
def _node_children(sp) -> List:
    """Direct ``plan.node.*`` descendants of a span, stopping at the
    first nested node level (each node owns its own subtree)."""
    out: List = []
    stack = list(sp.children)
    while stack:
        c = stack.pop()
        if c.name.startswith("plan.node."):
            out.append(c)
        else:
            stack.extend(c.children)
    return out


def critical_path(roots) -> Dict[str, Any]:
    """Longest-path attribution over a span forest's ``plan.node.*``
    tree: the root-to-leaf chain maximizing summed SELF time (node wall
    minus its direct child nodes' wall — concurrent-dispatch overlap is
    already collapsed into the parent's wall by the nesting).

    Returns ``{"total_s", "path": [(span, self_s)], "shares":
    {id(span): self_s / total_s for EVERY node span}}`` — off-path nodes
    carry share 0.0. Empty dict when no node spans exist."""
    top: List = []
    stack = list(roots)
    while stack:
        sp = stack.pop()
        if sp.name.startswith("plan.node."):
            top.append(sp)
        else:
            stack.extend(sp.children)
    if not top:
        return {}

    def chain(sp) -> Tuple[float, List[Tuple[Any, float]]]:
        kids = _node_children(sp)
        self_s = max(sp.dur_s() - sum(k.dur_s() for k in kids), 0.0)
        best_t, best_p = 0.0, []
        for k in kids:
            t, pth = chain(k)
            if t > best_t:
                best_t, best_p = t, pth
        return self_s + best_t, [(sp, self_s)] + best_p

    total, path = max((chain(sp) for sp in top), key=lambda tp: tp[0])
    total = max(total, 1e-12)
    shares = {id(sp): self_s / total for sp, self_s in path}
    # every node OFF the path gets an explicit 0 share
    stack = list(top)
    while stack:
        sp = stack.pop()
        shares.setdefault(id(sp), 0.0)
        stack.extend(_node_children(sp))
    return {"total_s": total, "path": path, "shares": shares}


def node_crit_shares(q) -> Dict[int, float]:
    """{id(span): critical-path share} over a live QueryTrace's node
    spans — the ``explain(analyze=True)`` "crit %" substrate."""
    cp = critical_path(q.spans)
    return cp.get("shares", {}) if cp else {}
