"""Declared environment knobs (counterpart of cylon_tpu/utils/envgate.py):
the one registry of every ``CYLON_TPU_TORCH_*`` variable the port reads,
and the kill-switch machinery.

Every knob declares its ``kind`` (the policy class below) and a ``note``;
kill switches also say how their gate decision reaches what it changes
(``keyed_via``: the plan fingerprint, a plan that rides a call). No module
of the port reads ``os.environ`` outside this file, except the
``torchrun`` variables of ``config.py`` (WORLD_SIZE, RANK, LOCAL_RANK),
which belong to torch's launcher, not to the port.

The port registers only the knobs of features it has. Knobs of tiers it has
not ported join with their items (ROADMAP.md A6, A7, A9); the JAX package's
knobs that choose between its XLA and Pallas tiers or configure XLA have no
counterpart (ROADMAP.md A5).
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
# CYLON_TPU_TORCH_NO_QUANT in ops/quant.py)
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
