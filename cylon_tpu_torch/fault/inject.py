"""Deterministic, seeded fault injection on the spill tier's host paths,
the observability layer, the serving scheduler and streaming ingest
(counterpart of cylon_tpu/fault/inject.py), armed from
``CYLON_TPU_TORCH_FAULTS``.

SEAMS (``check(seam)`` sites in parallel/spill.py, obs/, serve/ and
stream/):

=====================  ================================================
``spill.write``        arena append path (fires only while the arena
                       holds or targets disk-backed buffers: a RAM write
                       cannot ENOSPC, and the tier-degradation escape
                       must escape)
``spill.read``         arena read-back at result rebuild (disk-backed
                       only)
``arena.alloc``        host or disk arena buffer allocation
``obs.journal``        the observation-store journal append
                       (obs/store.py): a failure turns the store to
                       in-memory telemetry (``obs.journal_degraded``),
                       the query unaffected
``obs.prof``           the profiler's record path (obs/prof.py): a
                       failure turns profiling off (``prof.degraded``),
                       never the query
``serve.batch_exec``   the stacked execution of a batch of bindings
``serve.single_exec``  one binding's single execution
``serve.worker``       the scheduler's worker loop (thread death)
``stream.append``      an append, between its validation and budget
                       admission and the first arena write (inside the
                       append's ``except OSError`` rollback: errno kinds
                       only)
``stream.refresh``     a view refresh, before any plan runs or retained
                       state is touched (surfaces typed through the
                       refresh's wrapper)
=====================  ================================================

SPEC GRAMMAR: comma-separated seam clauses, ``:``-separated fields::

    CYLON_TPU_TORCH_FAULTS="spill.write:p=0.05:kind=ENOSPC,serve.worker:n=1"

    p=<float>     injection probability per check (default 1.0)
    kind=<name>   ENOSPC | EIO | ENOMEM: an OSError with that errno, the
                  only kinds the I/O seams take (their sites sit inside
                  ``except OSError`` degradation ladders); or exec |
                  timeout | die: the typed CylonError family, the serve
                  seams and stream.refresh only. Default per seam:
                  spill.write, arena.alloc and stream.append ENOSPC,
                  spill.read and the obs seams EIO, serve.*_exec and
                  stream.refresh exec, serve.worker die
    n=<int>       total injection cap (default unlimited)
    seed=<int>    RNG seed of this seam's draw sequence (default 0)
    match=<str>   inject only when the check's key contains this
                  substring, not followed by a further digit (``#q2``
                  does not fire on ``#q20``). The serve seams key per
                  binding as ``<PlanRoot>#q<admission seq>`` (the batch
                  seam's key joins its whole group's)

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
import re
import threading
from typing import Dict, Optional

from ..utils import envgate as _eg
from .errors import QueryExecError, QueryTimeoutError, WorkerDiedError

#: the seam catalog; check() accepts only these names
SEAMS = ("spill.write", "spill.read", "arena.alloc", "serve.batch_exec", "serve.single_exec",
         "serve.worker", "obs.journal", "obs.prof", "stream.append", "stream.refresh")

#: seams whose check() sites pass a key (a binding label): the only ones a
#: ``match=`` clause can select on
_KEYED_SEAMS = frozenset({"serve.batch_exec", "serve.single_exec"})

_ERRNO_KINDS = {"ENOSPC": errno.ENOSPC, "EIO": errno.EIO, "ENOMEM": errno.ENOMEM}

#: default fault kind per seam: the failure that path sees in the wild
_DEFAULT_KIND = {"spill.write": "ENOSPC", "spill.read": "EIO", "arena.alloc": "ENOSPC",
                 "serve.batch_exec": "exec", "serve.single_exec": "exec",
                 "serve.worker": "die", "obs.journal": "EIO", "obs.prof": "EIO",
                 "stream.append": "ENOSPC", "stream.refresh": "exec"}

#: seams whose sites surface typed CylonError kinds (the scheduler fails
#: the affected futures with them; a view's refresh raises them through
#: its typed wrapper); every other seam sits inside an ``except OSError``
#: ladder, so only errno kinds are valid there
_TYPED_KIND_SEAMS = frozenset({s for s in SEAMS if s.startswith("serve.")} | {"stream.refresh"})


class FaultSpec:
    """One armed seam's parsed clause and its deterministic draw state."""

    __slots__ = ("seam", "p", "kind", "n", "seed", "match", "match_re", "rng", "draws", "fired")

    def __init__(self, seam: str, p: float, kind: str, n: Optional[int], seed: int,
                 match: Optional[str] = None):
        self.seam = seam
        self.p = p
        self.kind = kind
        self.n = n
        self.seed = seed
        self.match = match
        # a match ending in digits must not continue into more digits, or
        # match=#q2 would also fire on admission sequence numbers 20-29
        self.match_re = None if match is None else re.compile(re.escape(match) + r"(?!\d)")
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
        p, kind, n, seed, match = 1.0, _DEFAULT_KIND[seam], None, 0, None
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
                elif k == "match":
                    match = v
                else:
                    raise FaultSpecError(f"unknown fault field {k!r} in {clause!r}")
            except ValueError as e:
                if isinstance(e, FaultSpecError):
                    raise
                raise FaultSpecError(f"bad value for {k!r} in {clause!r}: {v!r}") from e
        if kind not in _ERRNO_KINDS and kind not in ("exec", "timeout", "die"):
            raise FaultSpecError(f"unknown fault kind {kind!r} in {clause!r}")
        if kind not in _ERRNO_KINDS and seam not in _TYPED_KIND_SEAMS:
            raise FaultSpecError(
                f"kind {kind!r} is not valid for seam {seam!r}: the I/O seams take "
                "errno kinds (ENOSPC/EIO/ENOMEM) only"
            )
        if match is not None and seam not in _KEYED_SEAMS:
            raise FaultSpecError(
                f"match= is not valid for seam {seam!r}: only keyed seams "
                f"({', '.join(sorted(_KEYED_SEAMS))}) pass a key"
            )
        if not 0.0 <= p <= 1.0:
            raise FaultSpecError(f"p={p} out of [0,1] in {clause!r}")
        specs[seam] = FaultSpec(seam, p, kind, n, seed, match)
    return specs


def active() -> bool:
    """Any seam armed (as of the last import or refresh)?"""
    return bool(_SPECS)


def _exception(spec: FaultSpec, key: Optional[str]) -> BaseException:
    at = f"injected at seam {spec.seam}" + (f" key={key}" if key else "")
    if spec.kind in _ERRNO_KINDS:
        return OSError(_ERRNO_KINDS[spec.kind], f"{spec.kind} {at} (fault injection)")
    if spec.kind == "timeout":
        return QueryTimeoutError(f"timeout {at} (fault injection)")
    if spec.kind == "die":
        return WorkerDiedError(f"worker death {at} (fault injection)")
    return QueryExecError(f"exec failure {at} (fault injection)", binding=key)


def _check_noop(seam: str, key: Optional[str] = None) -> None:
    """The disabled hook: ``check`` is this function until :func:`refresh`
    arms a spec."""
    return None


def _check_armed(seam: str, key: Optional[str] = None) -> None:
    """The armed hook: the seam's seeded RNG decides whether this check
    injects, raising the armed kind (an ``OSError`` with the armed errno,
    or a typed CylonError on the typed seams). ``key`` is the site's
    binding label, which ``match=`` selects on."""
    spec = _SPECS.get(seam)
    if spec is None:
        if seam not in SEAMS:  # a typo'd site fails loudly under an armed campaign
            raise FaultSpecError(f"check() called with unknown seam {seam!r}")
        return
    if spec.match_re is not None and (key is None or spec.match_re.search(str(key)) is None):
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
    raise _exception(spec, key)


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
