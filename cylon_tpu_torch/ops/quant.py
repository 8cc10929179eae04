"""Block-scaled lossy wire codec for float payload columns, the quantized
wire tier (counterpart of cylon_tpu/ops/quant.py).

An opt-in lossy encoding of float payload columns on the shuffle wire,
selected per context by an explicit error tolerance and applied only to
columns that are never join or groupby keys. :func:`codec_for` picks by
dtype and tolerance:

``q8``
    Block-scaled int8: each block (one destination chunk of a shuffle
    round's send buffer) carries one float32 max-abs scale, which rides
    the chunk's header rows, and every value ships as an 8-bit code.
    Codes 0 / 1 / 255 are NaN / -inf / +inf; finite values quantize to
    +-126 steps of ``scale / 126``, so one crossing errs by at most
    blockmax/252. Engages at ``tol >= Q8_TOL`` (1e-2).
``qb16``
    Round-to-nearest-even bfloat16: relative error <= 2^-9 per crossing,
    inf and NaN exact. Engages at ``tol >= QB16_TOL`` (2^-8).
``qf32``
    float64 -> float32: relative error <= 2^-24 per crossing. Engages at
    ``tol >= QF32_TOL`` (2^-23).

The tolerance is the per-column end-to-end relative error bound
(``max|x_hat - x| <= tol * max|x|``), each codec sized so that two lossy
crossings stay under it. Keys, integers, bools and dictionary codes are
never quantized.

``CYLON_TPU_TORCH_QUANT_TOL`` (or the per-context ``quant_tol`` config,
which wins, an explicit 0 included) turns the tier on; unset, every path
is byte-identical to the exact wire. ``CYLON_TPU_TORCH_NO_QUANT=1`` is the
kill switch. The decided codec per column rides the wire plan's 'q'
fields, and :func:`gate_state` rides the lazy plan fingerprint.

The codes are those of the JAX package's XLA forms, bit for bit:
``x / s * 126``, round half to even, clip, offset 128. The encode, the
decode and the chunk max-abs are torch ops (XLA ops in the JAX package);
the pack and compact kernels (B2, B3) move the codes. The JAX package's
numpy mirrors serve its spill arena (ROADMAP.md A7) and are not here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.envgate import QUANT_TOL, env_gate

# the CYLON_TPU_TORCH_NO_QUANT=1 kill switch, the exact-wire oracle
enabled, disabled = env_gate(
    "CYLON_TPU_TORCH_NO_QUANT",
    keyed_via="the decided per-column codec rides the wire plan's 'q' fields "
    "(a call's shuffle plan); the plan fingerprint carries ops.quant.gate_state "
    "(plan/lazy.gated_fingerprint)",
    note="=1 disables the lossy wire tier whatever the tolerance (the "
    "exact-wire differential oracle)",
)

#: engagement thresholds: each codec engages only where the tolerance
#: covers two lossy crossings with margin
Q8_TOL = 1e-2          # per crossing: err <= blockmax / 252
QB16_TOL = 2.0 ** -8   # per crossing: rel err <= 2^-9 (bf16 RNE)
QF32_TOL = 2.0 ** -23  # per crossing: rel err <= 2^-24 (f32 RNE)

#: wire field width of each codec
CODEC_BITS = {"q8": 8, "qb16": 16, "qf32": 32}

# q8 reserved codes (non-finite passthrough)
Q8_NAN = 0
Q8_NEG_INF = 1
Q8_POS_INF = 255
#: float32(1 / 126): the decode's multiplier (see decode_q8)
_INV_126 = float(np.float32(1.0 / 126.0))


def tolerance(configured: Optional[object] = None) -> float:
    """The effective lossy-wire tolerance: an explicit per-context value
    wins (an explicit 0 or '' too: a context may opt back into the exact
    wire under a process-wide env tolerance), then
    CYLON_TPU_TORCH_QUANT_TOL, then 0.0 (off). The kill switch forces
    0.0."""
    if not enabled():
        return 0.0
    if configured is not None:
        return float(configured) if configured != "" else 0.0
    env = QUANT_TOL.get()
    return float(env) if env else 0.0


def gate_state() -> tuple:
    """The quant component of the plan fingerprint: the kill switch and
    the effective env tolerance. Both change the wire plans a lowered
    shuffle decides, so a flip re-enters the plan cache."""
    return (enabled(), tolerance())


def codec_for(np_dtype, tol: float) -> Optional[str]:
    """The lossy codec a float column of ``np_dtype`` rides under
    tolerance ``tol``, or None (exact). Non-float dtypes never quantize."""
    dt = np.dtype(np_dtype)
    if tol <= 0.0 or not np.issubdtype(dt, np.floating):
        return None
    if dt.itemsize == 2:
        # float16/bfloat16 already ship 16 lossless bits: only q8 gains
        return "q8" if tol >= Q8_TOL else None
    if dt == np.float32:
        if tol >= Q8_TOL:
            return "q8"
        if tol >= QB16_TOL:
            return "qb16"
        return None
    if tol >= Q8_TOL:
        return "q8"
    if tol >= QB16_TOL:
        return "qb16"
    if tol >= QF32_TOL:
        return "qf32"
    return None


def quant_spec(dtypes, key_idx, tol: float) -> Tuple[Optional[str], ...]:
    """Per-column codec tuple of a column set: float payload columns get
    :func:`codec_for`'s pick, key columns (``key_idx``) never quantize.
    ``dtypes`` are torch or numpy dtypes."""
    kset = set(key_idx)
    return tuple(
        None if ci in kset else codec_for(_np_kind(dt), tol)
        for ci, dt in enumerate(dtypes)
    )


def _np_kind(dt):
    """A numpy dtype with a torch dtype's codec class. bfloat16 never
    quantizes: the JAX package's bfloat16 (ml_dtypes) is no numpy
    floating subtype, so its codec_for declines it."""
    if not isinstance(dt, torch.dtype):
        return dt
    if not dt.is_floating_point or dt == torch.bfloat16:
        return np.int32
    return {2: np.float16, 4: np.float32}.get(dt.itemsize, np.float64)


# ----------------------------------------------------------------------
# the device codecs: int64 field values holding the unsigned code (the
# ops/gather wire codec's field contract)
# ----------------------------------------------------------------------

def safe_scale(blockmax: torch.Tensor) -> torch.Tensor:
    """A strictly positive float32 scale from a (possibly zero) block
    max-abs: a zero block quantizes exactly through scale 1."""
    bm = blockmax.to(torch.float32)
    return torch.where(bm > 0, bm, torch.ones_like(bm))


def encode_q8(data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int64 q8 codes of a float column under a per-row float32 ``scale``
    (broadcastable): finite values in codes 2..254 (offset 128, +-126
    steps), NaN / -inf / +inf on the reserved codes."""
    x = data.to(torch.float32)
    s = scale.to(torch.float32)
    q = torch.clamp(torch.round(x / s * 126.0), -126.0, 126.0)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)  # cast safety only
    code = (q + 128.0).to(torch.int64)
    code = torch.where(torch.isnan(x), Q8_NAN, code)
    code = torch.where(x == -float("inf"), Q8_NEG_INF, code)
    return torch.where(x == float("inf"), Q8_POS_INF, code)


def decode_q8(code: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`encode_q8` under the same per-row scale, in the
    XLA form of the JAX package's ``(code - 128) / 126 * s``: XLA turns the
    division by the constant into a product with its float32 reciprocal."""
    s = scale.to(torch.float32)
    x = (code.to(torch.float32) - 128.0) * _INV_126 * s
    x = torch.where(code == Q8_NAN, float("nan"), x)
    x = torch.where(code == Q8_NEG_INF, -float("inf"), x)
    x = torch.where(code == Q8_POS_INF, float("inf"), x)
    return x.to(dtype)


def encode_qb16(data: torch.Tensor) -> torch.Tensor:
    """int64 holding the bfloat16 (round to nearest even) bits; every NaN
    as XLA's canonical quiet NaN 0x7FC0."""
    code = data.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return torch.where(torch.isnan(data), 0x7FC0, code)


def decode_qb16(code: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    c = torch.where(code >= 2**15, code - 2**16, code)
    return c.to(torch.int16).view(torch.bfloat16).to(dtype)


def encode_qf32(data: torch.Tensor) -> torch.Tensor:
    """int64 holding the float32 (round to nearest even) bits of a
    float64 column."""
    return data.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def decode_qf32(code: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    c = torch.where(code >= 2**31, code - 2**32, code)
    return c.to(torch.int32).view(torch.float32).to(dtype)


def encode_field(codec: str, data: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    if codec == "q8":
        return encode_q8(data, scale)
    if codec == "qb16":
        return encode_qb16(data)
    if codec == "qf32":
        return encode_qf32(data)
    raise ValueError(f"unknown quant codec {codec!r}")


def decode_field(
    codec: str, code: torch.Tensor, scale: Optional[torch.Tensor], dtype: torch.dtype
) -> torch.Tensor:
    if codec == "q8":
        return decode_q8(code, scale, dtype)
    if codec == "qb16":
        return decode_qb16(code, dtype)
    if codec == "qf32":
        return decode_qf32(code, dtype)
    raise ValueError(f"unknown quant codec {codec!r}")


def finite_magnitude(data: torch.Tensor, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 |x| per value, 0 where it is not finite (or not live): what
    a q8 block's scale is the max of."""
    x = data.to(torch.float32)
    ok = torch.isfinite(x)
    if live is not None:
        ok = ok & live
    return torch.where(ok, x.abs(), torch.zeros_like(x))


def block_maxabs(data: torch.Tensor, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 max-abs over the finite (optionally live-masked) values of
    one column: a single block's scale."""
    mag = finite_magnitude(data, live)
    return mag.max() if mag.numel() else torch.zeros((), dtype=torch.float32, device=mag.device)
