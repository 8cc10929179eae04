"""Deterministic, seeded fault injection on the spill tier's host paths
and the observability layer (counterpart of the spill and obs seams of
cylon_tpu/fault/inject.py), armed from ``CYLON_TPU_TORCH_FAULTS``.

SEAMS (``check(seam)`` sites in parallel/spill.py and obs/):

=================  ====================================================
``spill.write``    arena append path (fires only while the arena holds or
                   targets disk-backed buffers: a RAM write cannot
                   ENOSPC, and the tier-degradation escape must escape)
``spill.read``     arena read-back at result rebuild (disk-backed only)
``arena.alloc``    host or disk arena buffer allocation
``obs.journal``    the observation-store journal append (obs/store.py): a
                   failure turns the store to in-memory telemetry
                   (``obs.journal_degraded``), the query unaffected
``obs.prof``       the profiler's record path (obs/prof.py): a failure
                   turns profiling off (``prof.degraded``), never the
                   query
=================  ====================================================

The serving and streaming seams come with their layers (ROADMAP.md A9).

SPEC GRAMMAR: comma-separated seam clauses, ``:``-separated fields::

    CYLON_TPU_TORCH_FAULTS="spill.write:p=0.05:kind=ENOSPC,arena.alloc:n=1"

    p=<float>     injection probability per check (default 1.0)
    kind=<name>   ENOSPC | EIO | ENOMEM: an OSError with that errno, the
                  only kinds these seams take (their sites sit inside
                  ``except OSError`` degradation ladders); default per
                  seam (spill.write and arena.alloc ENOSPC, spill.read
                  and the obs seams EIO)
    n=<int>       total injection cap (default unlimited)
    seed=<int>    RNG seed of this seam's draw sequence (default 0)

Each armed seam draws from ``random.Random(f"{seed}:{seam}")``: the k-th
check of a seam injects or not as a pure function of (seed, seam, k), so
a campaign replays from its spec alone.

:func:`check` is a module-level no-op while nothing is armed; sites reach
it through the module attribute (``inject.check(...)``). The environment
is read at import and at :func:`refresh`: a change takes effect at the
next refresh.
"""
from __future__ import annotations

import errno
import random
import threading
from typing import Dict, Optional

from ..utils import envgate as _eg

#: the seam catalog; check() accepts only these names
SEAMS = ("spill.write", "spill.read", "arena.alloc", "obs.journal", "obs.prof")

_ERRNO_KINDS = {"ENOSPC": errno.ENOSPC, "EIO": errno.EIO, "ENOMEM": errno.ENOMEM}

#: default fault kind per seam: the failure that path sees in the wild
_DEFAULT_KIND = {"spill.write": "ENOSPC", "spill.read": "EIO", "arena.alloc": "ENOSPC",
                 "obs.journal": "EIO", "obs.prof": "EIO"}


class FaultSpec:
    """One armed seam's parsed clause and its deterministic draw state."""

    __slots__ = ("seam", "p", "kind", "n", "seed", "rng", "draws", "fired")

    def __init__(self, seam: str, p: float, kind: str, n: Optional[int], seed: int):
        self.seam = seam
        self.p = p
        self.kind = kind
        self.n = n
        self.seed = seed
        # str seeds hash via sha512: deterministic across processes
        self.rng = random.Random(f"{seed}:{seam}")
        self.draws = 0
        self.fired = 0


class FaultSpecError(ValueError):
    """CYLON_TPU_TORCH_FAULTS failed to parse: misarmed chaos fails
    loudly, it never runs silently fault-free."""


_lock = threading.Lock()
_SPECS: Dict[str, FaultSpec] = {}


def parse_spec(raw: str) -> Dict[str, FaultSpec]:
    """Parse one CYLON_TPU_TORCH_FAULTS value into {seam: FaultSpec}."""
    specs: Dict[str, FaultSpec] = {}
    for clause in raw.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        seam = parts[0].strip()
        if seam not in SEAMS:
            raise FaultSpecError(f"unknown fault seam {seam!r} (seams: {', '.join(SEAMS)})")
        p, kind, n, seed = 1.0, _DEFAULT_KIND[seam], None, 0
        for f in parts[1:]:
            if "=" not in f:
                raise FaultSpecError(f"bad fault field {f!r} in {clause!r}")
            k, v = f.split("=", 1)
            k = k.strip()
            try:
                if k == "p":
                    p = float(v)
                elif k == "kind":
                    kind = v.strip()
                elif k == "n":
                    n = int(v)
                elif k == "seed":
                    seed = int(v)
                else:
                    raise FaultSpecError(f"unknown fault field {k!r} in {clause!r}")
            except ValueError as e:
                if isinstance(e, FaultSpecError):
                    raise
                raise FaultSpecError(f"bad value for {k!r} in {clause!r}: {v!r}") from e
        if kind not in _ERRNO_KINDS:
            raise FaultSpecError(
                f"kind {kind!r} is not valid for seam {seam!r}: the spill seams take "
                "errno kinds (ENOSPC/EIO/ENOMEM) only"
            )
        if not 0.0 <= p <= 1.0:
            raise FaultSpecError(f"p={p} out of [0,1] in {clause!r}")
        specs[seam] = FaultSpec(seam, p, kind, n, seed)
    return specs


def active() -> bool:
    """Any seam armed (as of the last import or refresh)?"""
    return bool(_SPECS)


def _check_noop(seam: str) -> None:
    """The disabled hook: ``check`` is this function until :func:`refresh`
    arms a spec."""
    return None


def _check_armed(seam: str) -> None:
    """The armed hook: the seam's seeded RNG decides whether this check
    injects, raising an ``OSError`` with the armed errno."""
    spec = _SPECS.get(seam)
    if spec is None:
        if seam not in SEAMS:  # a typo'd site fails loudly under an armed campaign
            raise FaultSpecError(f"check() called with unknown seam {seam!r}")
        return
    with _lock:
        if spec.n is not None and spec.fired >= spec.n:
            return
        spec.draws += 1
        if spec.p < 1.0 and spec.rng.random() >= spec.p:
            return
        spec.fired += 1
    # the counter via obs.metrics directly (lazy: utils.tracing imports
    # obs, whose store imports this module)
    from ..obs.metrics import rollup_count

    rollup_count(f"fault.injected.{seam}")
    raise OSError(_ERRNO_KINDS[spec.kind],
                  f"{spec.kind} injected at seam {seam} (fault injection)")


def refresh() -> bool:
    """Re-read ``CYLON_TPU_TORCH_FAULTS``, rebuild the plan with fresh draw
    state and swap the module-level ``check`` hook. Returns whether any
    seam is now armed; raises :class:`FaultSpecError` on a malformed spec."""
    global _SPECS, check
    specs = parse_spec(_eg.FAULTS.get())
    with _lock:
        _SPECS = specs
        check = _check_armed if specs else _check_noop
    return bool(specs)


#: re-arm from the current environment with fresh draw counters
reset = refresh

#: the live hook (rebound by refresh); a process started with the knob
#: set is armed at import
check = _check_noop
refresh()


def fired(seam: str) -> int:
    """Injections ``seam`` delivered since the last refresh."""
    spec = _SPECS.get(seam)
    return 0 if spec is None else spec.fired
