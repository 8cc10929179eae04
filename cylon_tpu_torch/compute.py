"""Elementwise and columnar compute on device-resident tables (counterpart
of cylon_tpu/compute.py; the reference's pycylon compute layer).

Every op runs per shard on the shard's device and keeps the shards' rows.
Nulls follow Arrow: a null operand gives a null result (the result takes
the operands' validity masks), and ``is_null`` / ``not_null`` read the
mask itself.

Result types are the JAX package's, which runs with 64-bit types on: two
columns promote on its lattice (``dtypes.promote_concat_dtypes``: an
integer with a float takes the float's width), and a Python scalar is
weak, so it takes the column's type (an int32 column times 2 is int32) or
the 64-bit default of its kind (an int32 column times 2.5 is float64),
where torch would give float32. ``/`` gives the inexact type of the
promoted one (bool and integers up to 32 bits -> float32, 64-bit ->
float64); ``//``, ``%`` and ``**`` of two bools give int32. Floor division,
remainder and powers follow JAX's formulas step for step, so that the
results agree bit for bit.
"""
from __future__ import annotations

import operator
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .column import Column
from .dtypes import DataType, Type, numpy_dtype, promote_concat_dtypes, torch_dtype
from .table import Table, _unify_dict_pair

__all__ = [
    "table_compare_op", "is_null", "not_null", "invert", "neg", "abs_",
    "math_op", "division_op", "unique", "nunique", "is_in", "drop_na",
    "map_columns", "compare_array_like_values",
]

_BOOL = DataType(Type.BOOL)

_COMPARE = {operator.eq, operator.ne, operator.lt, operator.le, operator.gt, operator.ge}

_MATH_OPS: Dict[str, Callable] = {
    "add": operator.add, "+": operator.add,
    "sub": operator.sub, "subtract": operator.sub, "-": operator.sub,
    "mul": operator.mul, "multiply": operator.mul, "*": operator.mul,
    "div": operator.truediv, "divide": operator.truediv, "/": operator.truediv,
    "floordiv": operator.floordiv, "//": operator.floordiv,
    "mod": operator.mod, "%": operator.mod,
    "pow": operator.pow, "**": operator.pow,
}


# ----------------------------------------------------------------------
# the JAX package's promotion and arithmetic on torch tensors
# ----------------------------------------------------------------------

def _weak_kind(x) -> Optional[str]:
    """'int' or 'float' for a weakly typed Python scalar, None for a
    tensor, a bool or a numpy scalar (those are strongly typed)."""
    if isinstance(x, (bool, np.bool_, torch.Tensor, np.generic)):
        return None
    if isinstance(x, int):
        return "int"
    if isinstance(x, float):
        return "float"
    raise TypeError(f"unsupported operand {x!r}")


def _strong_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, (bool, np.bool_)):
        return torch.bool
    return torch_dtype(np.asarray(x).dtype)


def promote(a: torch.dtype, b) -> torch.dtype:
    """The JAX type of ``a`` (a column's) combined with the operand ``b``."""
    kind = _weak_kind(b)
    if kind == "int":
        return torch.int64 if a == torch.bool else a
    if kind == "float":
        return a if a.is_floating_point else torch.float64
    return promote_concat_dtypes(a, _strong_dtype(b))


def _inexact(dt: torch.dtype) -> torch.dtype:
    if dt.is_floating_point:
        return dt
    return torch.float64 if dt.itemsize == 8 else torch.float32


def _as_operand(b, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(b, torch.Tensor):
        return b.to(device=device, dtype=dtype)
    if _weak_kind(b) == "int" and not dtype.is_floating_point and dtype != torch.bool:
        info = torch.iinfo(dtype)
        if not info.min <= b <= info.max:
            raise OverflowError(f"Python int {b} too large to convert to {dtype}")
    return torch.tensor(b, dtype=dtype, device=device)


def _sign_differs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a < 0) != (b < 0)


def _remainder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.remainder: the truncated remainder, moved onto the divisor's
    sign; an integer divisor of 0 counts as 1."""
    if not a.is_floating_point():
        b = torch.where(b == 0, torch.ones_like(b), b)
    r = torch.fmod(a, b)
    return torch.where(_sign_differs(r, b) & (r != 0), r + b, r)


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """lax.round's default: halves away from zero."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x), torch.round(x))


def _floor_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.floor_divide: integers by torch's floor division (the same
    quotient); floats by CPython's float_divmod, as JAX computes it."""
    if not a.is_floating_point():
        return torch.div(a, b, rounding_mode="floor")
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    return _round_away(torch.where(ind, div - 1, div))


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """lax.integer_pow: binary exponentiation by a constant exponent, the
    reciprocal for a negative one (refused for integers)."""
    if y == 0:
        return torch.ones_like(x)
    if y < 0 and not x.is_floating_point():
        raise TypeError(f"Integers cannot be raised to negative powers, got {y}")
    acc, e = None, abs(y)
    while e > 0:
        if e & 1:
            acc = x if acc is None else acc * x
        e >>= 1
        if e > 0:
            x = x * x
    return 1 / acc if y < 0 else acc


def _pow_int_int(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.power of two integer arrays: six rounds of binary
    exponentiation over the exponent's low bits (logical shifts)."""
    acc = torch.where((x == 0) & (y != 0), torch.zeros_like(x), torch.ones_like(x))
    low = (1 << (8 * y.element_size() - 1)) - 1
    for _ in range(6):
        acc = torch.where((y & 1) != 0, acc * x, acc)
        x = x * x
        y = (y >> 1) & low
    return acc


def binary_op(fn: Callable, a: torch.Tensor, b) -> torch.Tensor:
    """``fn(a, b)`` (an ``operator`` function) on one column's data and a
    tensor or scalar, with the JAX package's result type and arithmetic."""
    device = a.device
    if fn is operator.pow and not isinstance(b, torch.Tensor):
        try:
            y = operator.index(b)  # a constant integer exponent keeps the base's type
        except TypeError:
            y = None
        if y is not None:
            return _integer_pow(a.to(torch.int32) if a.dtype == torch.bool else a, y)
    dt = promote(a.dtype, b)
    if fn in _COMPARE:
        return fn(a.to(dt), _as_operand(b, dt, device))
    if fn is operator.truediv:
        dt = _inexact(dt)
        y = _as_operand(b, dt, device)
        if a.dtype == torch.bool and not isinstance(b, torch.Tensor):
            # XLA makes a converted bool over a constant a select: False
            # gives +0.0 where the quotient would give -0.0
            return torch.where(a, 1 / y, torch.zeros_like(y))
        return a.to(dt) / y
    if fn in (operator.and_, operator.or_):
        if dt.is_floating_point:
            raise TypeError(f"bitwise {fn.__name__} is not defined on {dt}")
        return fn(a.to(dt), _as_operand(b, dt, device))
    if dt == torch.bool:
        if fn is operator.sub:
            raise TypeError("subtract does not accept two bool operands")
        if fn in (operator.floordiv, operator.mod, operator.pow):
            dt = torch.int32
        else:  # add is or, mul is and
            return fn(a, _as_operand(b, dt, device))
    x, y = a.to(dt), _as_operand(b, dt, device)
    if fn is operator.mul and dt.is_floating_point:
        # XLA turns a product with a converted bool array into a select, so
        # False gives +0.0 where the product would give -0.0
        if a.dtype == torch.bool:
            return torch.where(a, y, torch.zeros_like(y))
        if isinstance(b, torch.Tensor) and b.dtype == torch.bool:
            return torch.where(y != 0, x, torch.zeros_like(x))
    if fn is operator.floordiv:
        return _floor_divide(x, y)
    if fn is operator.mod:
        return _remainder(x, y)
    if fn is operator.pow:
        if not dt.is_floating_point:
            return _pow_int_int(x, y)
        if isinstance(b, torch.Tensor) and a.is_floating_point() and not b.is_floating_point():
            return torch.pow(a, b.to(a.dtype))  # a float base keeps its type
        return torch.pow(x, y)
    return fn(x, y)


def _negate(a: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.bool:
        raise TypeError("negative does not accept dtype bool")
    return torch.neg(a)


def _absolute(a: torch.Tensor) -> torch.Tensor:
    return a if a.dtype == torch.bool else torch.abs(a)


def bit_invert(a: torch.Tensor) -> torch.Tensor:
    """``~``: logical not of a bool, bitwise not of an integer."""
    if a.is_floating_point():
        raise TypeError(f"invert is not defined on {a.dtype}")
    return ~a


def _typed(data: torch.Tensor) -> DataType:
    return DataType.from_numpy_dtype(numpy_dtype(data.dtype))


def _and_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for m in masks:
        if m is not None:
            out = m if out is None else out & m.to(out.device)
    return out


def _map(table: Table, fn) -> Table:
    """``fn(shard index, column name, Column) -> Column`` over every column
    of every shard this process owns."""
    return table._with_shards(table._per_shard(lambda s: OrderedDict(
        (n, fn(s, n, c)) for n, c in table._shards[s].items()
    )))


# ----------------------------------------------------------------------
# the reference's compute functions
# ----------------------------------------------------------------------

def _dict_scalar_compare(col: Column, value: str, op: Callable) -> torch.Tensor:
    """A dictionary column against a string: its codes against the
    string's position in the SORTED dictionary, whose order is the
    strings' order."""
    d = col.dictionary
    pos = int(np.searchsorted(d, value))
    present = pos < len(d) and d[pos] == value
    c = col.data
    if op is operator.eq:
        return (c == pos) if present else torch.zeros_like(c, dtype=torch.bool)
    if op is operator.ne:
        return (c != pos) if present else torch.ones_like(c, dtype=torch.bool)
    if op is operator.lt:
        return c < pos
    if op is operator.ge:
        return c >= pos
    if op is operator.le:
        return (c <= pos) if present else (c < pos)
    if op is operator.gt:
        return (c > pos) if present else (c >= pos)
    raise ValueError(f"unsupported dictionary comparison {op}")


def _paired(table: Table, other: Table):
    if table.column_count != other.column_count:
        raise ValueError("tables must have the same number of columns")
    if not (table._counts == other._counts).all():
        raise ValueError("tables must have the same rows per shard")
    return dict(zip(table.column_names, other.column_names))


def table_compare_op(table: Table, other: Any, op: Callable) -> Table:
    """Elementwise comparison -> a bool table: against a scalar, or column
    by column against an equal-width table (string columns compare on
    their union dictionary)."""
    if isinstance(other, Table):
        pairs = _paired(table, other)
        for name, oname in pairs.items():
            if table._ref[name].dtype.is_dictionary != other._ref[oname].dtype.is_dictionary:
                raise ValueError(f"cannot compare string and numeric column {name!r}")
        a, b = table, other
        for name, oname in pairs.items():
            if table._ref[name].dtype.is_dictionary:
                a, b = _unify_dict_pair(a, b, [name], [oname])

        def cmp(s, n, c):
            oc = b._shards[s][pairs[n]]
            return Column(binary_op(op, a._shards[s][n].data, oc.data), _BOOL,
                          _and_masks(a._shards[s][n].valid, oc.valid))

        return _map(table, cmp)

    def cmp_scalar(s, n, c):
        if c.dtype.is_dictionary:
            if not isinstance(other, str):
                raise ValueError(f"cannot compare string column {n!r} with {type(other)}")
            data = _dict_scalar_compare(c, other, op)
        else:
            data = binary_op(op, c.data, other)
        return Column(data, _BOOL, c.valid)

    return _map(table, cmp_scalar)


def is_null(table: Table) -> Table:
    return table.isnull()


def not_null(table: Table) -> Table:
    return table.notnull()


def invert(table: Table) -> Table:
    """Elementwise NOT of bool columns."""
    def inv(s, n, c):
        if c.data.dtype != torch.bool:
            raise ValueError(f"invert expects boolean columns, got {c.dtype}")
        return Column(~c.data, _BOOL, c.valid)

    return _map(table, inv)


def neg(table: Table) -> Table:
    return map_columns(table, _negate)


def abs_(table: Table) -> Table:
    return map_columns(table, _absolute)


def math_op(table: Table, op: Union[str, Callable], value: Any) -> Table:
    """Elementwise arithmetic against a scalar or, column by column, an
    equal-width table."""
    fn = _MATH_OPS[op] if isinstance(op, str) else op
    if isinstance(value, Table):
        pairs = _paired(table, value)

        def both(s, n, c):
            oc = value._shards[s][pairs[n]]
            if c.dtype.is_dictionary or oc.dtype.is_dictionary:
                raise ValueError(f"arithmetic is not defined on string column {n!r}")
            data = binary_op(fn, c.data, oc.data)
            return Column(data, _typed(data), _and_masks(c.valid, oc.valid))

        return _map(table, both)

    def one(s, n, c):
        if c.dtype.is_dictionary:
            raise ValueError(f"arithmetic is not defined on string column {n!r}")
        data = binary_op(fn, c.data, value)
        return Column(data, _typed(data), c.valid)

    return _map(table, one)


def division_op(table: Table, op: str, value: Any) -> Table:
    """truediv / floordiv / mod, refusing a zero scalar divisor."""
    if (
        np.isscalar(value) and not isinstance(value, str) and value == 0
        and op in ("/", "div", "divide", "//", "floordiv", "%", "mod")
    ):
        raise ZeroDivisionError("division by zero")
    return math_op(table, op, value)


def map_columns(table: Table, fn: Callable[[torch.Tensor], torch.Tensor]) -> Table:
    """An elementwise tensor function over every (numeric) column."""
    def one(s, n, c):
        if c.dtype.is_dictionary:
            raise ValueError(f"map is not defined on string column {n!r}")
        data = fn(c.data)
        return Column(data, _typed(data), c.valid)

    return _map(table, one)


def unique(table: Table) -> Table:
    return table.unique()


def nunique(table: Table) -> Dict[str, int]:
    """Distinct non-null values per column, deduplicated across the shards."""
    out = {}
    for name in table.column_names:
        sub = table.project([name])
        if sub._ref[name].valid is not None:
            sub = sub.filter(sub._map_shards(lambda sh: sh[name].valid))
        uniq = sub.distributed_unique() if sub.world_size > 1 else sub.unique()
        out[name] = int(uniq.row_count)
    return out


def _probe_targets(values, col_dtype: np.dtype) -> np.ndarray:
    """The probe values in the column's domain, sorted: integer columns
    keep exact integers and integral floats in range; float columns keep
    the values that round-trip through the column type (NaN never
    matches)."""
    nums = [v for v in values if not isinstance(v, str) and v is not None]
    if col_dtype.kind in "iu":
        kept = []
        info = np.iinfo(col_dtype)
        for v in nums:
            if isinstance(v, (int, np.integer)) or (
                isinstance(v, bool) is False and float(v).is_integer()
            ):
                iv = int(v)
                if info.min <= iv <= info.max:
                    kept.append(iv)
        return np.sort(np.array(kept, col_dtype))
    kept = []
    for v in nums:
        fv = float(v)
        if np.isnan(fv):
            continue
        if float(col_dtype.type(fv)) == fv:
            kept.append(fv)
    return np.sort(np.array(kept, col_dtype))


def _probe_lane(x: torch.Tensor) -> torch.Tensor:
    """A tensor ``torch.searchsorted`` takes, in ``x``'s value order."""
    if x.dtype == torch.bool or x.dtype in (torch.uint8, torch.uint16, torch.uint32):
        return x.to(torch.int64)
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ (-(2**63))
    return x


def is_in(table: Table, values: Sequence, skip_null: bool = True) -> Table:
    """Membership in a host value list: a dictionary column by its
    dictionary's membership, a numeric one by a binary search over the
    sorted probe values in its own type. With ``skip_null`` a null is
    False, not null."""
    vals = list(values)
    str_vals = np.array(sorted(str(v) for v in vals if isinstance(v, str)), dtype=object)
    member = {n: np.isin(c.dictionary.astype(object), str_vals)
              for n, c in table._ref.items() if c.dtype.is_dictionary}
    targets = {n: _probe_targets(vals, numpy_dtype(c.data.dtype))
               for n, c in table._ref.items() if not c.dtype.is_dictionary}

    def probe(s, n, c):
        if c.dtype.is_dictionary:
            look = torch.from_numpy(member[n]).to(c.data.device)
            data = (look.index_select(0, c.data.clamp(0, len(member[n]) - 1))
                    if len(member[n]) else torch.zeros_like(c.data, dtype=torch.bool))
        elif len(targets[n]) == 0:
            data = torch.zeros_like(c.data, dtype=torch.bool)
        else:
            tgt = torch.from_numpy(targets[n]).to(c.data.device)
            pos = torch.searchsorted(_probe_lane(tgt), _probe_lane(c.data)).clamp(0, len(tgt) - 1)
            data = tgt.index_select(0, pos) == c.data
        mask = c.valid
        if mask is not None and skip_null:
            data, mask = data & mask, None
        return Column(data, _BOOL, mask)

    return _map(table, probe)


def drop_na(table: Table, how: str = "any", axis: int = 0) -> Table:
    """Drop the rows (axis=0) or the columns (axis=1) holding nulls: with
    ``how='any'`` any null, with ``how='all'`` only nulls."""
    if how not in ("any", "all"):
        raise ValueError("how must be 'any' or 'all'")
    if axis == 0:
        def keep(s):
            masks = torch.stack([c.valid_mask() for c in table._shards[s].values()])
            return masks.all(0) if how == "any" else masks.any(0)

        return table.filter(table._per_shard(keep))
    if axis == 1:
        nullable = [n for n, c in table._ref.items() if c.valid is not None]
        if not nullable:
            return table
        local = [torch.stack([(~table._shards[s][n].valid).sum() for n in nullable])
                 for s in table.ctx.local_shards]
        n_null = table._gather_counts(local).sum(axis=0)  # every rank alike
        n_live = table.row_count
        drop = [n for n, k in zip(nullable, n_null)
                if (how == "any" and k > 0) or (how == "all" and k == n_live)]
        return table.drop(drop) if drop else table
    raise ValueError("axis must be 0 or 1")


def compare_array_like_values(values, value_set, skip_null: bool = True) -> np.ndarray:
    """Membership of each element of a host array in ``value_set`` (the
    reference's SetLookup is_in over arrays), as a bool numpy array; typed
    as the reference compares: text matches text, numbers numbers (int 1
    never matches '1'), NaN never matches, None only when ``skip_null`` is
    False and None is in the set."""
    vals = np.asarray(values)
    if vals.dtype.kind in ("U", "S"):
        text = [v.decode(errors="replace") if isinstance(v, bytes) else v
                for v in value_set if isinstance(v, (str, bytes))]
        probe = (np.char.decode(vals, encoding="utf-8", errors="replace")
                 if vals.dtype.kind == "S" else vals)
        return np.isin(probe, np.asarray(text, dtype="U"))
    if vals.dtype == object:
        def canon(v):
            if isinstance(v, bytes):
                return ("t", v.decode(errors="replace"))
            if isinstance(v, str):
                return ("t", v)
            if isinstance(v, (bool, int, float, np.bool_, np.integer, np.floating)):
                return ("n", v)
            return ("o", v)

        def safe_eq(x, y):
            try:
                return bool(x == y)
            except (TypeError, ValueError):
                return False

        def is_nan(v):
            return isinstance(v, (float, np.floating)) and v != v

        vset = list(value_set)
        svals = [canon(v) for v in vset if v is not None and not is_nan(v)]
        sset, slinear = set(), []
        for c in svals:
            try:
                sset.add(c)
            except TypeError:  # an unhashable member: a linear scan
                slinear.append(c)

        def contains(c):
            try:
                if c in sset:
                    return True
            except TypeError:
                return any(s[0] == c[0] and safe_eq(s[1], c[1]) for s in svals)
            return any(s[0] == c[0] and safe_eq(s[1], c[1]) for s in slinear)

        null_hit = not skip_null and any(v is None for v in vset)
        return np.array([null_hit if v is None else False if is_nan(v) else contains(canon(v))
                         for v in vals.tolist()], bool)
    vs = _probe_targets(list(value_set), np.dtype(vals.dtype))
    if len(vs) == 0:
        return np.zeros(vals.shape, bool)
    pos = np.clip(np.searchsorted(vs, vals), 0, len(vs) - 1)
    out = vs[pos] == vals
    if skip_null and vals.dtype.kind == "f":
        out &= ~np.isnan(vals)
    return np.asarray(out)
