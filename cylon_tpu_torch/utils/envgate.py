"""Declared environment knobs (counterpart of cylon_tpu/utils/envgate.py):
the one registry of every ``CYLON_TPU_TORCH_*`` variable the port reads,
and the kill-switch machinery.

Every knob declares its ``kind`` (the policy class below) and a ``note``;
kill switches also say how their gate decision reaches what it changes
(``keyed_via``: the plan fingerprint, a plan that rides a call). No module
of the port reads ``os.environ`` outside this file, except the
``torchrun`` variables of ``config.py`` (WORLD_SIZE, RANK, LOCAL_RANK),
which belong to torch's launcher, not to the port.

The port registers only the knobs of features it has: the observability
layer (obs/: the tracer, the profiler, the flight ring and its export,
the ops endpoint, the observation store, the leak grace), the shuffle tiers,
the skew split and the spill tiers (parallel/spill.py, which the
out-of-core layers of parallel/ooc.py, task.py and dag.py read and add
none to), the spill fault seams (fault/inject.py), the two-hop topology
(parallel/topo.py), the native runtime's kill switch (native/) and the C
ABI's platform (native/capi.cpp's ``ct_api_init``). Knobs of layers it has
not ported (the feedback re-coster, serving, SLO rules, streaming) join
with their items (ROADMAP.md A9); the JAX package's
knobs that choose between its XLA and Pallas tiers or configure XLA have no
counterpart (ROADMAP.md A5), nor has its AddressSanitizer build of the
native runtime (ROADMAP.md, "Left out so far").
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

KINDS = {
    # VAR=1 turns an optimization off; the decision changes which plan a
    # call takes, so it is part of the plan fingerprint
    "kill-switch": "optimization escape hatch; gate decision must be keyed",
    # host-resolved sizing; reaches the device only through shapes
    "tuning": "host-resolved sizing knob; reaches kernels via shapes only",
    # host-resolved value that decides a plan per call (which wire fields a
    # shuffle ships); it reaches the device through that plan
    "dispatch": "host-resolved plan choice; rides the per-call plan and the fingerprint",
    # Read once at import / context init, before any kernel exists.
    "startup": "import/init-time configuration",
    # alters which host code paths raise (fault injection), never a plan
    # or a result where it does not fire
    "observability": "host-only reads; never a plan, a cache key or a result",
    # native-extension build and runtime configuration (host code only)
    "native": "native extension build/runtime config",
}

REGISTRY: Dict[str, "EnvKnob"] = {}


class EnvKnob:
    """One declared environment variable. Instantiating registers it."""

    __slots__ = ("var", "default", "kind", "keyed_via", "note")

    def __init__(
        self,
        var: str,
        default: str = "",
        kind: str = "tuning",
        keyed_via: Optional[str] = None,
        note: str = "",
    ) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown knob kind {kind!r} for {var}")
        if kind == "kill-switch" and not keyed_via:
            raise ValueError(f"{var}: a kill switch needs keyed_via=")
        if not var.startswith("CYLON_TPU_TORCH_"):
            raise ValueError(f"{var}: the port's knobs are named CYLON_TPU_TORCH_*")
        self.var = var
        self.default = default
        self.kind = kind
        self.keyed_via = keyed_via
        self.note = note
        REGISTRY[var] = self

    def get(self) -> str:
        """Current value (read per call: a change takes effect at once)."""
        return os.environ.get(self.var, self.default)

    def truthy(self) -> bool:
        """Set to anything non-empty and non-'0'."""
        return self.get() not in ("", "0")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"EnvKnob({self.var!r}, kind={self.kind!r})"


def env_gate(var: str, keyed_via: str = "", note: str = ""):
    """``(enabled, disabled)`` of a ``VAR=1``-disables kill switch.

    ``enabled()`` reads the environment per call. ``disabled()`` is a
    reentrant save/set/restore context manager: the differential oracle of
    the tests. Registers ``var`` as a kill switch."""
    knob = EnvKnob(
        var, "0", kind="kill-switch",
        keyed_via=keyed_via or "the plan fingerprint carries the gate (plan/lazy.py)",
        note=note,
    )

    def enabled() -> bool:
        return knob.get() != "1"

    @contextlib.contextmanager
    def disabled():
        prev = os.environ.get(var)
        os.environ[var] = "1"
        try:
            yield
        finally:
            if prev is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = prev

    return enabled, disabled


# ----------------------------------------------------------------------
# knob declarations (the kill switches are declared at their consumers:
# CYLON_TPU_TORCH_NO_ORDERING in ordering.py, CYLON_TPU_TORCH_NO_SEMI_FILTER
# in ops/sketch.py, CYLON_TPU_TORCH_NO_LANE_PACK in ops/stats.py,
# CYLON_TPU_TORCH_NO_QUANT in ops/quant.py, CYLON_TPU_TORCH_NO_SKEW_SPLIT in
# parallel/spill.py, CYLON_TPU_TORCH_NO_TOPO in parallel/topo.py)
# ----------------------------------------------------------------------
SHUFFLE_BUDGET = EnvKnob(
    "CYLON_TPU_TORCH_SHUFFLE_BUDGET", "", kind="tuning",
    note="per-round shuffle exchange byte budget (config.py); the context's "
    "shuffle_byte_budget config wins",
)
SKETCH_BITS = EnvKnob(
    "CYLON_TPU_TORCH_SKETCH_BITS", "", kind="tuning",
    note="semi-join sketch bit cap (config.py); the context's sketch_bits "
    "config wins",
)
QUANT_TOL = EnvKnob(
    "CYLON_TPU_TORCH_QUANT_TOL", "", kind="dispatch",
    note="lossy-wire tolerance (ops/quant.py): float payload columns ride "
    "q8/qb16/qf32 wire fields at or above their thresholds; the context's "
    "quant_tol config wins, an explicit 0 included",
)

# -- the two-hop topology (parallel/topo.py; the JAX package's
# CYLON_TPU_MESH and CYLON_TPU_OUTER_BUDGET) --
MESH = EnvKnob(
    "CYLON_TPU_TORCH_MESH", "", kind="startup",
    note="2-D topology 'OxI' (outer x inner), e.g. '4x2'; product must "
    "equal the world size; read once at context init (GPUConfig.mesh_shape "
    "wins); unset = flat 1-D",
)
OUTER_BUDGET = EnvKnob(
    "CYLON_TPU_TORCH_OUTER_BUDGET", "", kind="tuning",
    keyed_via="budget -> cross-outer combined-chunk capacity (cap_o) -> the "
    "two-hop plan of the call",
    note="per-round cross-outer (hop 2) exchange byte budget for 2-D "
    "topologies; unset = the shared shuffle byte budget (never binds)",
)

# -- spill tiers (parallel/spill.py; the JAX package's CYLON_TPU_SPILL_*) --
SPILL_TIER = EnvKnob(
    "CYLON_TPU_TORCH_SPILL_TIER", "", kind="dispatch",
    keyed_via="host-side tier selection between the in-device round path and "
    "the arena staging path; the forced tier rides the plan fingerprint "
    "(spill.gate_state in plan/lazy.gated_fingerprint)",
    note="force the spill tier: 0=device rounds, 1=host-RAM arenas, "
    "2=disk-backed arenas; empty = decide from the measured counts",
)
SPILL_DEVICE_BUDGET = EnvKnob(
    "CYLON_TPU_TORCH_SPILL_DEVICE_BUDGET", "", kind="tuning",
    note="per-shard staged-output bytes above which shuffle rounds spill "
    "off-device (unset = never, tier 0 unless forced)",
)
SPILL_HOST_BUDGET = EnvKnob(
    "CYLON_TPU_TORCH_SPILL_HOST_BUDGET", "", kind="tuning",
    note="total live host-arena bytes above which arena growth promotes to "
    "disk-backed buffers (tier 1 -> tier 2)",
)
SPILL_DIR = EnvKnob(
    "CYLON_TPU_TORCH_SPILL_DIR", "", kind="tuning",
    note="directory for tier-2 disk-spill arenas (default: a tempdir)",
)
SPILL_RETRIES = EnvKnob(
    "CYLON_TPU_TORCH_SPILL_RETRIES", "2", kind="tuning",
    note="bounded-backoff retries for a failed spill arena write or read "
    "before the degradation ladder re-plans onto the host-RAM tier (or fails "
    "the one query with SpillIOError)",
)
FAULTS = EnvKnob(
    "CYLON_TPU_TORCH_FAULTS", "", kind="observability",
    note="deterministic fault-injection spec (fault/inject.py): "
    "comma-separated 'seam[:p=0.05][:kind=ENOSPC][:n=3][:seed=7]' clauses "
    "arming spill.write/spill.read/arena.alloc/obs.journal/obs.prof; read at "
    "import and at "
    "fault.inject.refresh()",
)

# -- the native runtime and the C ABI (native/; the JAX package's
# CYLON_TPU_NO_NATIVE and CYLON_TPU_PLATFORM) --
NO_NATIVE = EnvKnob(
    "CYLON_TPU_TORCH_NO_NATIVE", "", kind="native",
    note="=1 turns the native C++ codec off: CSV reads go through pyarrow, "
    "writes through pandas, and murmur3_strings takes its Python twin",
)
PLATFORM = EnvKnob(
    "CYLON_TPU_TORCH_PLATFORM", "", kind="startup",
    note="the device of the C ABI's context (native/capi.cpp ct_api_init): "
    "unset = GPUConfig() on cuda:0, which raises without a card; 'cpu' "
    "asks for the CPU; read once, at ct_api_init",
)

# -- the observability layer (obs/; the JAX package's CYLON_TPU_TRACE,
# _TRACE_RING, _TRACE_EXPORT, _PROF, _OBS_DIR, _METRICS_PORT and
# _LEAK_GRACE_S). None alters a plan, a cache key or a result --
TRACE = EnvKnob(
    "CYLON_TPU_TORCH_TRACE", "0", kind="observability",
    note="=1 logs each span as it closes AND records query span trees; any "
    "other truthy value (e.g. 'tree') records the structured traces without "
    "the per-span stderr log; on a card spans record CUDA timing events, "
    "read only once completed or at export (no added host sync)",
)
PROF = EnvKnob(
    "CYLON_TPU_TORCH_PROF", "0", kind="observability",
    note="truthy enables the critical-path profiler (obs/prof.py): "
    "per-stage per-shard stage clocks of the shuffle round pipeline from "
    "the counts the engine already read and the window of its events",
)
TRACE_RING = EnvKnob(
    "CYLON_TPU_TORCH_TRACE_RING", "64", kind="observability",
    note="flight-recorder capacity: the last N finished query traces kept "
    "in memory (obs/export.py); read per record",
)
TRACE_EXPORT = EnvKnob(
    "CYLON_TPU_TORCH_TRACE_EXPORT", "", kind="observability",
    note="when set, the flight ring is written to this path as Chrome "
    "trace-event JSON at interpreter exit",
)
OBS_DIR = EnvKnob(
    "CYLON_TPU_TORCH_OBS_DIR", "", kind="observability",
    note="directory of the persistent per-fingerprint observation journal "
    "(obs/store.py); unset disables the store. No tuned decision reads it "
    "yet (the feedback re-coster, ROADMAP.md A9b)",
)
METRICS_PORT = EnvKnob(
    "CYLON_TPU_TORCH_METRICS_PORT", "", kind="observability",
    note="when set, context init starts the ops endpoint on loopback "
    "(obs/export.OpsServer): /metrics, /healthz, /queries; also turns the "
    "resource ledger on; '0' picks a free port",
)
LEAK_GRACE_S = EnvKnob(
    "CYLON_TPU_TORCH_LEAK_GRACE_S", "30", kind="observability",
    note="resource-ledger leak grace (seconds): a table still live this "
    "long after its owning query trace finished is flagged by "
    "ResourceLedger.leaks()",
)
