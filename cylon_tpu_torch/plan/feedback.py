"""Telemetry-driven gate re-costing: the feedback re-coster (counterpart of
cylon_tpu/plan/feedback.py).

Every adaptive gate of the engine runs on a static guess: the 32 MiB
shuffle budget (``config.DEFAULT_SHUFFLE_BYTE_BUDGET``), the semi-filter
size gate (``SEMI_FILTER_MIN_PAYOFF``), the serve batch bucket, the spill
tier's budget line, the 4x-mean skew trigger, two hops on any declared
topology. The observation store (``obs/store.py``) holds, per gated plan
fingerprint, what those guesses approximate: the hottest bucket, row
bytes, semi-filter selectivity, staged bytes, the stage clocks' straggler
ratios, the per-axis bytes and the serving latencies. At optimize time
:func:`decisions_for` reads the fingerprint's profile and returns a
:class:`Decisions` record that overrides the statics, under HYSTERESIS: a
decision flips only after ``CYLON_TPU_TORCH_AUTOTUNE_MIN_OBS`` consecutive
observations agree, and, where a cost model exists, only when the
incumbent's modeled cost exceeds the candidate's by
``CYLON_TPU_TORCH_AUTOTUNE_MARGIN``, so noisy evidence never oscillates.

FINGERPRINT: every tuned decision rides the plan fingerprint.
:func:`fingerprint_component` returns the ``(active, Decisions)`` tuple
``plan/lazy.gated_fingerprint`` appends beside the other gates, so a flip
re-enters the plan cache (exactly one new executor,
``engine.plan_executable``) and never aliases an executor built under the
other decision. Profiles are keyed by the BASE fingerprint
(:func:`base_key`, everything but this component), so a flip keeps
feeding one profile. Under ``torch.distributed`` each rank journals its
own evidence; :func:`agree` gives every rank the decisions of the process
that owns shard 0 (one host gather, only while the store is on), so the
ranks' shuffle schedules match.

APPLICATION: the decisions chosen at optimize time reach the execution
sites through :func:`applying` (a contextvar ``collect`` and the serving
scheduler open around execution): ``table._shuffle_many`` reads
:func:`tuned_shuffle_budget`, :func:`tuned_skew_trigger`,
:func:`tuned_hop_mode` and :func:`tuned_spill_tier`, the fused join
:func:`tuned_shuffle_budget`, ``table._shuffle_pair``
:func:`tuned_semi_mode`, and the scheduler caps its group size with
``Decisions.serve_bucket`` and leases ``Decisions.footprint``. Every
decision is policy, never semantics: results are bit-identical to the
static run (``CYLON_TPU_TORCH_NO_AUTOTUNE=1``, the differential oracle).

``sort_impl`` and ``codec_impl`` choose between two engines in the JAX
package (the radix and bitonic sorts, the Pallas and XLA codecs). The
port has one sort engine (kernel K1) and one codec (kernels B2/B3) and
journals them as ``note_sort("radix", ..., alt_passes=0)`` and
``note_codec("cuda" | "plain", ...)``, so the proposers, ported whole,
find no alternative and leave both fields None; no execution site reads
them (ROADMAP.md C3).

The semi decision measures, then decides: a shape with no selectivity
evidence runs in ``"explore"`` mode (the sketch builds past the static
size gate, so the count pass measures selectivity); after ``MIN_OBS``
observations it settles to ``"on"`` (low selectivity), ``"off"`` (high:
skip even building the sketch) or static (mid band: the payoff gate).
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
from contextvars import ContextVar
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

from ..obs import store as _store
from ..utils import envgate as _eg

# the autotune kill switch: the static-heuristic oracle of the
# differentials, threaded into the executable identity through
# fingerprint_component below
autotune_enabled, autotune_disabled = _eg.env_gate(
    "CYLON_TPU_TORCH_NO_AUTOTUNE",
    keyed_via="plan/lazy.gated_fingerprint appends this module's (active, "
    "Decisions) component to every plan fingerprint: the plan cache, the "
    "serving batch cache and the latency histograms key through it, so a "
    "gate flip (or any tuned decision flip) builds a new executor",
    note="=1 disables telemetry-driven gate re-costing (the static-heuristic "
    "differential oracle)",
)

#: selectivity bands of the semi decision (hysteresis lives in the gap)
SEL_FORCE_ON = 0.6
SEL_FORCE_OFF = 0.9
#: tuned-budget clamp (bytes)
BUDGET_FLOOR = 1 << 20
BUDGET_CEIL = 1 << 28
#: promote the spill tier when observed staged bytes reach this fraction
#: of the device budget; release the promotion under the low-water mark
SPILL_HIGH_WATER = 0.8
SPILL_LOW_WATER = 0.6
#: tuned admission footprints never lease below this (the scheduler's
#: _EST_FLOOR: zero-size queries stay countable)
FOOTPRINT_FLOOR = 1024
#: skew-trigger tuning: the engagement ratio the relay drops to when the
#: stage clocks show a straggler the static 4x-mean trigger ignores, the
#: hot/mean band that counts as mild skew, and the straggler-ratio floor
#: (max/mean per-stage shard time, obs/prof.py) below which nothing flips
SKEW_TRIGGER_TUNED = 2
SKEW_MILD_MIN = 1.5
STRAGGLER_ENGAGE = 2.0


class Decisions(NamedTuple):
    """The tuned overrides of one plan shape. ``None`` keeps the static
    heuristic. Hashable and repr-stable: this tuple IS the fingerprint
    component (and the explain annotation's source)."""

    shuffle_budget: Optional[int] = None
    semi_mode: Optional[str] = None   # "explore" | "on" | "off" | None
    serve_bucket: Optional[int] = None
    spill_tier: Optional[int] = None
    #: observed per-query device footprint (power-of-two p95 bytes of the
    #: resource ledger's evidence): the serving scheduler leases this in
    #: place of the static input-bytes estimate
    footprint: Optional[int] = None
    #: skew-split engagement ratio (x mean bucket) replacing the static
    #: SKEW_MIN_RATIO=4 when the straggler ledger shows a shard-time
    #: straggler on a mildly skewed shape; ``table._plan_state`` threads it
    #: into ``spill.plan_schedule(trigger=)``
    skew_trigger: Optional[int] = None
    #: topology hop mode (parallel/topo.py): ``"1hop"`` forces the flat
    #: exchange on a declared 2-D mesh when the per-axis bytes show the
    #: two-hop decomposition saves nothing cross-outer; None = two hops
    #: whenever a topology is declared. Both modes are row-exact
    hop_mode: Optional[str] = None
    #: sort engine (the JAX package's radix | bitonic); the port has one
    #: engine, so its profiles never propose one
    sort_impl: Optional[str] = None
    #: shuffle codec (the JAX package's pallas | xla); the port has one
    #: codec, so its profiles never propose one
    codec_impl: Optional[str] = None


DECISIONS_OFF = Decisions()
#: dec-dict sentinel: the decision was MADE and it is "keep the static"
#: (distinct from not yet decided, which keeps the semi explore mode on)
STATIC = "static"


def min_observations() -> int:
    try:
        return max(int(_eg.AUTOTUNE_MIN_OBS.get()), 1)
    except ValueError:
        return 8


def margin() -> float:
    try:
        return max(float(_eg.AUTOTUNE_MARGIN.get()), 0.0)
    except ValueError:
        return 0.2


def p99_target_s() -> Optional[float]:
    raw = _eg.SERVE_P99_TARGET_MS.get()
    if not raw:
        return None
    try:
        return float(raw) / 1e3
    except ValueError:
        return None


def _batch_max() -> int:
    try:
        return int(_eg.SERVE_BATCH_MAX.get())
    except ValueError:
        return 16


# ----------------------------------------------------------------------
# fingerprint plumbing
# ----------------------------------------------------------------------
_key_lock = threading.Lock()
_KEY_MEMO: Dict[tuple, str] = {}
_KEY_MEMO_CAP = 1024


def base_key(base: tuple) -> str:
    """Stable short key of a BASE gated fingerprint (the full tuple minus
    the feedback component): the store's profile identity. Memoized, so
    a cached collect never re-walks the deep tuple; hashed with its own
    blake2s, not ``obs.metrics.fingerprint_key``, so the
    ``plan.fingerprint.hash`` counter stays flat."""
    k = _KEY_MEMO.get(base)
    if k is None:
        k = hashlib.blake2s(repr(base).encode(), digest_size=6).hexdigest()
        with _key_lock:
            if len(_KEY_MEMO) >= _KEY_MEMO_CAP:
                _KEY_MEMO.pop(next(iter(_KEY_MEMO)))
            _KEY_MEMO[base] = k
    return k


def fingerprint_component(base: tuple) -> tuple:
    """The ``(active, Decisions)`` element ``gated_fingerprint`` appends.
    ``active`` is True only when the kill switch is off AND a store is
    configured: flipping either re-keys every plan, like the gates beside
    it."""
    active = autotune_enabled() and _store.store() is not None
    if not active:
        return (False, DECISIONS_OFF)
    return (True, decisions_for(base))


def decisions_for(base: tuple) -> Decisions:
    """The current tuned decisions of a base fingerprint: a lock-free read
    of the profile's cached decision tuple (updated under the store lock
    as observations arrive). A shape with no profile yet starts in semi
    explore mode."""
    s = _store.store()
    if s is None:
        return DECISIONS_OFF
    tup = s.dec_tuple(base_key(base))
    if tup is None:
        return Decisions(semi_mode="explore")
    return Decisions(*tup)


def decisions_of(fingerprint: tuple) -> Decisions:
    """The Decisions embedded in a FULL gated fingerprint (its trailing
    feedback component), for holders of the fingerprint itself: the
    serving scheduler's group-size cap and admission lease."""
    comp = fingerprint[-1]
    if (isinstance(comp, tuple) and len(comp) == 2
            and isinstance(comp[1], Decisions) and comp[0]):
        return comp[1]
    return DECISIONS_OFF


# the wire form of a Decisions record for agree(): one int64 a field, -1
# for None, strings by their index in the field's vocabulary
_VOCAB = {
    "semi_mode": ("explore", "on", "off", STATIC),
    "hop_mode": ("1hop", "2hop"),
    "sort_impl": ("bitonic", "radix", "radix_pallas", STATIC),
    "codec_impl": ("xla", "pallas", STATIC),
}


def _encode(d: Decisions) -> np.ndarray:
    out = []
    for field, v in zip(Decisions._fields, d):
        if v is None:
            out.append(-1)
        elif field in _VOCAB:
            out.append(_VOCAB[field].index(v))
        else:
            out.append(int(v))
    return np.asarray(out, np.int64)


def _decode(vec) -> Decisions:
    vals = []
    for field, x in zip(Decisions._fields, vec):
        x = int(x)
        if x < 0:
            vals.append(None)
        elif field in _VOCAB:
            vals.append(_VOCAB[field][x])
        else:
            vals.append(x)
    return Decisions(*vals)


def agree(ctx, component: tuple) -> tuple:
    """The component every rank of ``ctx`` uses: under ``torch.distributed``
    with the store on, the decisions of the process that owns shard 0,
    shared through one host gather (each rank journals only its own
    evidence, and ranks that planned their shuffles under different
    decisions would hang in the collectives or mix rows). One process, or
    the store off (the component's constant ``(False, DECISIONS_OFF)``),
    gathers nothing."""
    if not component[0] or getattr(ctx.comm, "n_procs", 1) <= 1:
        return component
    vec = _encode(component[1])
    rows = ctx.comm.all_gather_counts(np.tile(vec, (len(ctx.local_shards), 1)))
    return (True, _decode(rows[0]))


# ----------------------------------------------------------------------
# application context: optimize-time decisions -> execution sites
# ----------------------------------------------------------------------
_APPLIED: "ContextVar[Optional[Decisions]]" = ContextVar(
    "cylon_tpu_torch_autotune_applied", default=None
)


@contextlib.contextmanager
def applying(component: tuple):
    """Make a fingerprint's decisions visible to the execution sites for
    the block. ``component`` is what :func:`fingerprint_component` returned
    for the key the executor was cached under, so application and
    identity never disagree."""
    if not (isinstance(component, tuple) and len(component) == 2 and component[0]):
        yield
        return
    token = _APPLIED.set(component[1])
    try:
        yield
    finally:
        _APPLIED.reset(token)


def tuned_shuffle_budget() -> Optional[int]:
    d = _APPLIED.get()
    return d.shuffle_budget if d is not None else None


def tuned_semi_mode() -> Optional[str]:
    d = _APPLIED.get()
    return d.semi_mode if d is not None else None


def tuned_spill_tier() -> Optional[int]:
    d = _APPLIED.get()
    return d.spill_tier if d is not None else None


def tuned_skew_trigger() -> Optional[int]:
    d = _APPLIED.get()
    return d.skew_trigger if d is not None else None


def tuned_hop_mode() -> Optional[str]:
    d = _APPLIED.get()
    return d.hop_mode if d is not None else None


def tuned_sort_impl() -> Optional[str]:
    d = _APPLIED.get()
    return d.sort_impl if d is not None else None


def tuned_codec_impl() -> Optional[str]:
    d = _APPLIED.get()
    return d.codec_impl if d is not None else None


# ----------------------------------------------------------------------
# proposers + hysteresis (called by the store as observations absorb)
# ----------------------------------------------------------------------
def effective_decisions(p: Dict[str, Any]) -> tuple:
    """Profile -> the Decisions field tuple the fingerprint carries. A
    pure function of the profile: the store caches its result per profile
    for the lock-free hot-path read."""
    dec = p.get("dec", {})
    sm = dec.get("semi_mode")
    if sm is None:
        # undecided: explore until the DECISION lands (switching on raw
        # observation counts would build two executors a flip)
        sm = "explore"
    elif sm == STATIC:
        sm = None
    si = dec.get("sort_impl")
    if si == STATIC:
        si = None
    ci = dec.get("codec_impl")
    if ci == STATIC:
        ci = None
    return (
        dec.get("shuffle_budget"),
        sm,
        dec.get("serve_bucket"),
        dec.get("spill_tier"),
        dec.get("footprint"),
        dec.get("skew_trigger"),
        dec.get("hop_mode"),
        si,
        ci,
    )


def update_profile_decisions(p: Dict[str, Any], kind: str = "exec") -> None:
    """Re-cost the tuned decisions the arriving record kind carries
    evidence for (``exec``: shuffle budget, semi, spill tier, skew
    trigger, hop mode, footprint; ``lat``: serve bucket), flipping under
    hysteresis: a candidate that differs from the incumbent must win
    ``min_observations()`` CONSECUTIVE relevant observations (alternating
    evidence resets the streak) and, where a cost model exists, beat the
    incumbent by ``margin()``. Runs under the store lock."""
    m = min_observations()
    dec = p.setdefault("dec", {})
    pend = p.setdefault("pend", {})
    flipped = False
    for field, (cand, margin_ok) in _proposals(p, kind).items():
        cur = dec.get(field)
        if cand == cur:
            pend.pop(field, None)
            continue
        enc = repr(cand)
        pe = pend.get(field)
        if pe is not None and pe[0] == enc:
            pe[1] += 1
        else:
            pe = pend[field] = [enc, 1]
        if pe[1] >= m and margin_ok and not flipped:
            # at most ONE re-keying flip an observation, so a flip builds
            # exactly one executor even when two streaks mature on the
            # same record (the runner-up flips on the next one). A
            # decision that leaves the EFFECTIVE tuple unchanged (an impl
            # field settling to STATIC: both read None) is recorded so
            # re-judging stops, but is not a flip
            before = effective_decisions(p)
            dec[field] = cand
            pend.pop(field, None)
            if effective_decisions(p) == before:
                continue
            flipped = True
            p["flips"] = p.get("flips", 0) + 1
            if field == "serve_bucket":
                # the latency evidence was gathered under the OLD bucket:
                # a fresh window judges the new one
                p["serve_lat"] = _store._new_lat()
    p["_dec"] = effective_decisions(p)


def _proposals(p: Dict[str, Any], kind: str = "exec") -> Dict[str, Tuple[Any, bool]]:
    out: Dict[str, Tuple[Any, bool]] = {}
    mg = margin()
    m = min_observations()

    if kind == "exec":
        # -- semi filter: engage or skip from observed selectivity -------
        if p.get("sel_n", 0) >= m:
            mean_sel = p["sel_sum"] / p["sel_n"]
            if mean_sel <= SEL_FORCE_ON:
                out["semi_mode"] = ("on", True)
            elif mean_sel >= SEL_FORCE_OFF:
                out["semi_mode"] = ("off", True)
            else:
                out["semi_mode"] = (STATIC, True)

        # -- shuffle byte budget: size to the measured hottest bucket ----
        if p.get("n", 0) >= m and p.get("hot", 0) > 0 and p.get("world", 0) > 1:
            out["shuffle_budget"] = _budget_proposal(p, mg)

        # -- spill tier: promote before the budget line ------------------
        from ..parallel import spill as _spill

        budget = _spill.device_spill_budget()
        if budget is not None and p.get("n", 0) >= m:
            if p.get("staged_max", 0) >= SPILL_HIGH_WATER * budget:
                out["spill_tier"] = (_spill.TIER_HOST, True)
            elif p.get("staged_max", 0) < SPILL_LOW_WATER * budget:
                out["spill_tier"] = (None, True)

        # -- skew trigger: engage the relay on mild skew the static
        # 4x-mean ratio ignores, from the stage clocks' straggler evidence
        if (p.get("strag_n", 0) >= m and p.get("hot", 0) > 0
                and p.get("mean_bucket", 0) > 0 and p.get("world", 0) > 1):
            out["skew_trigger"] = _skew_trigger_proposal(p, mg)

        # -- topology hop mode from the per-axis bytes: every observation
        # on a 2-D shape carries both modes' cross-outer bytes, so the
        # comparison needs no exploratory flip
        if p.get("hop_n", 0) >= m and p.get("topo"):
            out["hop_mode"] = _hop_mode_proposal(p, mg)

        # -- sort and codec engines (one of each in the port: nothing to
        # propose, see the module docstring)
        if p.get("sort_ev"):
            cand, ok = _sort_impl_proposal(p, mg, m)
            if ok is not None:
                out["sort_impl"] = (cand, ok)
        if p.get("codec_ev"):
            cand, ok = _codec_impl_proposal(p, mg, m)
            if ok is not None:
                out["codec_impl"] = (cand, ok)

        # -- admission footprint: lease the observed bytes. The p95 of the
        # ledger's per-query device bytes, rounded to a power of two so
        # the candidate repeats under run-to-run noise
        foot = p.get("foot") or {}
        if foot.get("n", 0) >= m:
            p95 = _store.lat_quantile(foot, 0.95)
            cand = 1 << max(int(p95) - 1, 1).bit_length()
            out["footprint"] = (max(cand, FOOTPRINT_FLOOR), True)

    elif kind == "lat":
        # -- serve batch bucket against the p99 target, judged only on the
        # serving latency window (samples that carried a batch size)
        target = p99_target_s()
        if target is not None and p.get("serve_lat", {}).get("n", 0) >= m:
            out["serve_bucket"] = _serve_bucket_proposal(p, target, mg)

    return out


def _round_cost(p: Dict[str, Any], budget: int) -> int:
    """Modeled collective row slots (cap x K) of this shape under a byte
    budget, from the engine's own planner (``shuffle.plan_rounds``) over a
    synthetic histogram with the observed hottest and mean buckets."""
    from ..parallel import shuffle as _sh

    world = max(int(p.get("world", 1)), 1)
    counts = np.full((world, world), max(int(p.get("mean_bucket", 0)), 0), np.int64)
    counts[0, 0] = int(p["hot"])
    cap, k = _sh.plan_rounds(counts, max(int(p["row_bytes"]), 1), world, int(budget))
    return cap * k


def _budget_proposal(p: Dict[str, Any], mg: float) -> Tuple[Any, bool]:
    """The byte budget that clears the hottest observed bucket in one
    round (``2 * world * cap_full * row_bytes``), clamped to
    [BUDGET_FLOOR, BUDGET_CEIL]. GROW only when the modeled collective
    slots shrink by the margin; SHRINK whenever the slots stay equal (a
    pure peak-memory win)."""
    from ..config import shuffle_byte_budget
    from ..engine import round_cap

    # the baseline is the budget this shape runs with untuned, as the
    # execution site journaled it (a context's own budget, not the
    # process default)
    static = p.get("static_budget") or shuffle_byte_budget()
    incumbent = p.get("dec", {}).get("shuffle_budget") or static
    cap_full = round_cap(int(p["hot"]))
    needed = 2 * int(p["world"]) * cap_full * int(p["row_bytes"])
    cand = int(min(max(needed, BUDGET_FLOOR), BUDGET_CEIL))
    if cand == static:
        return (None, True)
    cost_inc = _round_cost(p, incumbent)
    cost_cand = _round_cost(p, cand)
    if cand > incumbent:
        return (cand, cost_cand <= cost_inc * (1.0 - mg))
    return (cand, cost_cand <= cost_inc)


def _skew_trigger_proposal(p: Dict[str, Any], mg: float) -> Tuple[Any, bool]:
    """The skew-split engagement ratio from the straggler ledger. The
    static trigger relays only buckets past 4x the mean, so a 2-3x hot
    bucket still pads every round to its cap. When the shape sits in that
    mild band, the stage clocks measured a straggler
    (``STRAGGLER_ENGAGE``), and re-planning the observed histogram under
    the tuned trigger cuts the modeled shipped cost (collective slots +
    relay factor x relayed rows) by the margin, propose
    ``SKEW_TRIGGER_TUNED``; anything else keeps the static trigger.
    Results are identical either way."""
    from ..parallel import spill as _spill

    ratio = p["hot"] / max(p["mean_bucket"], 1)
    strag = p.get("strag_sum", 0.0) / max(p.get("strag_n", 1), 1)
    if ratio >= _spill.SKEW_MIN_RATIO or ratio < SKEW_MILD_MIN or strag < STRAGGLER_ENGAGE:
        return (None, True)
    from ..config import shuffle_byte_budget

    world = max(int(p["world"]), 1)
    counts = np.full((world, world), max(int(p["mean_bucket"]), 0), np.int64)
    counts[0, 0] = int(p["hot"])
    budget = int(p.get("dec", {}).get("shuffle_budget") or p.get("static_budget")
                 or shuffle_byte_budget())
    rb = max(int(p["row_bytes"]), 1)
    s_static = _spill.plan_schedule(counts, rb, world, budget)
    s_tuned = _spill.plan_schedule(counts, rb, world, budget, trigger=SKEW_TRIGGER_TUNED)
    if not s_tuned.adaptive:
        return (None, True)  # the tuned trigger would not engage either

    def cost(s):
        return s.coll_row_slots(world) + _spill.RELAY_COST_FACTOR * s.relay_rows()

    return (SKEW_TRIGGER_TUNED, cost(s_tuned) <= cost(s_static) * (1.0 - mg))


def _hop_mode_proposal(p: Dict[str, Any], mg: float) -> Tuple[Any, bool]:
    """The hop mode from the per-axis bytes. Two hops shrink the
    cross-outer traffic only when it is clustered enough that ``cap_o``
    stays under its ``inner x cap`` ceiling; dense cross-group traffic
    gains nothing and pays the inner hop on top. The profile holds both
    modes' mean cross-outer bytes of the same plans: propose "1hop" when
    two hops fail to undercut the flat bytes by the margin, None (the
    two-hop default) once the saving clears it."""
    n = max(int(p.get("hop_n", 1)), 1)
    i2 = p.get("hop_i2_sum", 0) / n
    i1 = p.get("hop_i1_sum", 0) / n
    if i1 <= 0:
        return (None, True)
    if i2 > i1 * (1.0 - mg):
        return ("1hop", True)
    return (None, True)


def _impl_proposal(ev_of, slow: str, fast: Tuple[str, ...], mg: float, m: int):
    """The two-engine walk-back shared by the sort and codec proposers:
    ``ev_of[impl] = [n, ms_sum, passes_sum, alt_passes_sum]``. Both
    engines measured: propose ``slow`` when it wins by the margin, STATIC
    when the default engine does. One measured: model the other through
    the pass-count ratio the observation carried. ``(None, None)`` below
    the evidence floor."""

    def _ev(impl):
        ev = (ev_of or {}).get(impl)
        if not ev or ev[0] < m:
            return None
        n, ms, passes, alt = ev
        return ms / n, passes / max(n, 1), alt / max(n, 1)

    alt_ev = _ev(slow)
    dflt = None
    for impl in fast:
        dflt = dflt or _ev(impl)
    if alt_ev is not None and dflt is not None:
        if alt_ev[0] <= dflt[0] * (1.0 - mg):
            return (slow, True)
        if dflt[0] <= alt_ev[0] * (1.0 - mg):
            return (STATIC, True)
        return (None, True)  # within the margin: keep the static default
    for ev, other_wins in ((dflt, lambda ms, modeled: ms > modeled * (1.0 + mg)),
                           (alt_ev, lambda ms, modeled: modeled > ms * (1.0 + mg))):
        if ev is None:
            continue
        ms, passes, alt = ev
        if passes <= 0 or alt <= 0:
            return (None, True)
        return ((slow, True) if other_wins(ms, ms / passes * alt) else (STATIC, True))
    return (None, None)


def _sort_impl_proposal(p: Dict[str, Any], mg: float, m: int) -> Tuple[Any, Optional[bool]]:
    """The sort engine from ``p["sort_ev"]``: "bitonic" when the compare
    sort beats radix by the margin, STATIC when radix holds. The port's
    one engine journals ``radix`` with ``alt_passes`` 0: no proposal."""
    return _impl_proposal(p.get("sort_ev"), "bitonic", ("radix", "radix_pallas"), mg, m)


def _codec_impl_proposal(p: Dict[str, Any], mg: float, m: int) -> Tuple[Any, Optional[bool]]:
    """The shuffle codec from ``p["codec_ev"]``: "xla" when the lowerings
    beat the fused kernels by the margin, STATIC when the kernels hold.
    The port journals ``cuda``/``plain``, neither engine here: no
    proposal."""
    return _impl_proposal(p.get("codec_ev"), "xla", ("pallas",), mg, m)


def _serve_bucket_proposal(p: Dict[str, Any], target: float, mg: float) -> Tuple[Any, bool]:
    batch_max = max(_batch_max(), 1)
    cur = p.get("dec", {}).get("serve_bucket") or batch_max
    p99 = _store.lat_quantile(p.get("serve_lat") or p["lat"], 0.99)
    if p99 > target:
        cand = max(cur // 2, 1)
        return (cand if cand < batch_max else None, p99 > target * (1.0 + mg))
    if p99 <= target * 0.5 and cur < batch_max:
        cand = min(cur * 2, batch_max)
        return (cand if cand < batch_max else None, True)
    return (cur if cur < batch_max else None, True)


# ----------------------------------------------------------------------
# explain(analyze=True) annotations
# ----------------------------------------------------------------------
def describe(base: tuple) -> list:
    """``<gate> tuned: <value> (was <static>, n=<obs>)`` lines for every
    tuned decision of this shape (empty when autotune is inactive or
    nothing is tuned)."""
    s = _store.store()
    if s is None or not autotune_enabled():
        return []
    key = base_key(base)
    d = decisions_for(base)
    p = s.profile_snapshot(key) or {}
    from ..config import SEMI_FILTER_MIN_PAYOFF, shuffle_byte_budget

    lines = []
    if d.shuffle_budget is not None:
        lines.append(f"shuffle_budget tuned: {d.shuffle_budget} "
                     f"(was {shuffle_byte_budget()}, n={p.get('n', 0)})")
    if d.semi_mode is not None:
        lines.append(f"semi_filter tuned: {d.semi_mode} "
                     f"(was payoff>={SEMI_FILTER_MIN_PAYOFF}x, n={p.get('sel_n', 0)})")
    if d.serve_bucket is not None:
        lines.append(f"serve_bucket tuned: {d.serve_bucket} "
                     f"(was {_batch_max()}, n={p.get('serve_lat', {}).get('n', 0)})")
    if d.spill_tier is not None:
        lines.append(f"spill_tier tuned: {d.spill_tier} (was budget-line, n={p.get('n', 0)})")
    if d.footprint is not None:
        lines.append(f"admission footprint tuned: {d.footprint} B "
                     f"(was input-bytes estimate, n={p.get('foot', {}).get('n', 0)})")
    if d.skew_trigger is not None:
        from ..parallel.spill import SKEW_MIN_RATIO

        lines.append(f"skew_trigger tuned: {d.skew_trigger}x-mean "
                     f"(was {SKEW_MIN_RATIO}x-mean, n={p.get('strag_n', 0)})")
    if d.hop_mode is not None:
        lines.append(f"hop_mode tuned: {d.hop_mode} "
                     f"(was 2hop-on-topology, n={p.get('hop_n', 0)})")
    if d.sort_impl is not None:
        n_sort = sum(ev[0] for ev in (p.get("sort_ev") or {}).values())
        lines.append(f"sort_impl tuned: {d.sort_impl} (was radix-where-eligible, n={n_sort})")
    if d.codec_impl is not None:
        n_codec = sum(ev[0] for ev in (p.get("codec_ev") or {}).values())
        lines.append(f"codec_impl tuned: {d.codec_impl} "
                     f"(was pallas-where-supported, n={n_codec})")
    return lines
