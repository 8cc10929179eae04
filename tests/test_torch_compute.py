"""The port's compute layer against the JAX package's on the CPU:
``compute.table_compare_op`` / ``math_op`` / ``division_op`` (and the
Table operators on them), ``neg``, ``abs_``, ``invert``, ``map_columns``,
``is_in`` and ``Table.isin``, ``drop_na``, ``nunique``,
``compare_array_like_values``, and the DataFrame operators
(``DataFrame._binop``), fed one host encoding made with numpy from a fixed
seed.

The type promotion trap is covered operator by operator: every operator on
an int32, int64, float32, float64 and bool column, against a column of
each of those types and against a Python int, float and bool and a numpy
scalar, must give the JAX package's result type and, bit for bit, its
values (NaN equal to NaN, the sign of a zero kept) and validity; where
the JAX package raises TypeError, the port raises TypeError. The one
inexact case is a float power with a float or integer ARRAY exponent
(XLA's pow against torch's): rtol 1e-6 in float32, 1e-15 in float64. Every
other comparison is exact and shard by shard. The elementwise ops run
shard by shard with no distributed form, so they are held at world 1;
``drop_na`` and ``nunique`` (a filter, a distributed_unique) at worlds 1
and 4.
"""
import operator

import numpy as np
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu import compute as jc
from cylon_tpu_torch import compute as tc
from test_torch_shuffle_slice import _contexts, _encode

torch.set_num_threads(1)

DTYPES = [np.int32, np.int64, np.float32, np.float64, np.bool_]
SCALARS = [3, 2.5, True, np.float32(1.5), np.int64(2), -2]
OPS = {
    "+": operator.add, "-": operator.sub, "*": operator.mul, "/": operator.truediv,
    "//": operator.floordiv, "%": operator.mod, "**": operator.pow, "&": operator.and_,
    "|": operator.or_, "<": operator.lt, "==": operator.eq, ">=": operator.ge,
}


# ----------------------------------------------------------------------
# comparisons of whole tables (shared by the other new test files)
# ----------------------------------------------------------------------

def same_values(got: np.ndarray, want: np.ndarray, what, rtol=None):
    """Same dtype and values: NaN equals NaN, and the sign of a zero
    counts; ``rtol`` for the one inexact case."""
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == object:
        assert got.tolist() == want.tolist(), what
        return
    if rtol is not None:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True, err_msg=str(what))
        return
    assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f"), (what, got, want)
    if want.dtype.kind == "f":
        live = ~np.isnan(want)
        assert (np.signbit(got[live]) == np.signbit(want[live])).all(), what


def shard_column(t, c, s, port):
    """(values of the valid rows, validity mask) of one shard's column;
    a dictionary column decoded to its strings. The JAX side reads the
    whole column and cuts it at the row counts (an elementwise result may
    not keep the shards' layout)."""
    if port:
        d, v = t._host_physical_shard(c, s)
    else:
        d, v = t._host_physical(c)
        offs = np.concatenate([[0], np.cumsum(t.row_counts)])
        d = d[offs[s]:offs[s + 1]]
        v = None if v is None else v[offs[s]:offs[s + 1]]
    mask = np.ones(len(d), bool) if v is None else np.asarray(v, bool)
    col = t._shards[s][c] if port else t._columns[c]
    if col.dtype.is_dictionary:
        d = col.decode_host(d, None)
    return d[mask], mask


def tables_equal(jt, tt, rtol=None, index=True):
    """The port's table equals the JAX package's: names, rows per shard,
    the index, and per shard each column's type, validity and values."""
    assert tt.column_names == jt.column_names
    np.testing.assert_array_equal(tt.row_counts, jt.row_counts)
    if index:
        assert tt.index_name == jt.index_name
    for s in range(len(jt.row_counts)):
        for c in jt.column_names:
            assert tt._shards[s][c].dtype.type == jt._columns[c].dtype.type, c
            gd, gm = shard_column(tt, c, s, True)
            wd, wm = shard_column(jt, c, s, False)
            np.testing.assert_array_equal(gm, wm, err_msg=f"{c} valid, shard {s}")
            same_values(gd, wd, (c, s), rtol)


def both(world, cols):
    jctx, tctx = _contexts(world)
    enc = _encode(cols)
    return ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)


def _agree(jcall, tcall, rtol=None):
    """Both packages' results equal, or both raise TypeError."""
    try:
        want = jcall()
    except TypeError:
        with pytest.raises(TypeError):
            tcall()
        return None
    got = tcall()
    tables_equal(want, got, rtol)
    return got


def _column(rng, dt, n, nulls=True):
    if dt == np.bool_:
        x = rng.random(n) < 0.5
    elif np.dtype(dt).kind == "f":
        x = (rng.normal(size=n) * 4).astype(dt)
        x[:4] = [0.0, -0.0, 2.0, -3.5]
    else:
        x = rng.integers(-9, 10, n).astype(dt)
        x[:2] = [0, 7]
    if nulls and np.dtype(dt).kind == "f":
        x[rng.random(n) < 0.15] = np.nan  # nulls on load
    return x


def _exponents(rng, dt, n):
    """Small exponents for the integer powers (non-negative)."""
    return rng.integers(0, 4, n).astype(dt)


def _rtol(op, t, name):
    """The inexact case: a float power (XLA's pow against torch's; a
    constant integer exponent multiplies alike in both), at the result's
    precision."""
    dt = np.dtype(t._columns[name].data.dtype)
    if op != "**" or dt.kind != "f":
        return None
    return 1e-6 if dt == np.float32 else 1e-15


def _apply(pkg, op, fn, t, other):
    m = jc if pkg == "j" else tc
    if op in ("<", "==", ">="):
        return m.table_compare_op(t, other, fn)
    return m.math_op(t, fn, other)


def _agree_by_column(op, fn, jl, tl, jo, to):
    """``op`` over every column pair at once, or column by column where the
    JAX package raises TypeError for one of them (then so must the port)."""
    try:
        want = _apply("j", op, fn, jl, jo)
    except TypeError:
        for i, n in enumerate(jl.column_names):
            def pick(t, o, i=i, n=n):
                return t.project([n]), (o.project([o.column_names[i]])
                                        if hasattr(o, "project") else o)
            try:
                w = _apply("j", op, fn, *pick(jl, jo))
            except TypeError:
                with pytest.raises(TypeError):
                    _apply("t", op, fn, *pick(tl, to))
                continue
            tables_equal(w, _apply("t", op, fn, *pick(tl, to)), _rtol(op, w, n))
        return
    got = _apply("t", op, fn, tl, to)
    for n in jl.column_names:
        tables_equal(want.project([n]), got.project([n]), _rtol(op, want, n))


@pytest.mark.parametrize("op", list(OPS), ids=list(OPS))
def test_operator_promotion_matches_reference(rng, op):
    """One operator on an int32, int64, float32, float64 and bool column,
    each against a column of its own type and of the next type in that
    list, and against a Python int, float and bool (a numpy float32 and
    int64 for the arithmetic): the JAX package's result type, values and
    nulls."""
    fn = OPS[op]
    n = 40
    left = {np.dtype(d).name: _column(rng, d, n) for d in DTYPES}
    jl, tl = both(1, left)
    for shift in (0, 1):
        other = {}
        for i, ld in enumerate(DTYPES):
            d = DTYPES[(i + shift) % len(DTYPES)]
            x = _exponents(rng, d, n) if op == "**" and np.dtype(d).kind in "iu" else \
                _column(rng, d, n)
            if op in ("/", "//", "%") and np.dtype(d).kind in "iub":
                x = np.where(x == 0, 3, x).astype(d)  # no integer division by zero
            other[f"{np.dtype(ld).name}_by"] = x
        jo, to = both(1, other)
        _agree_by_column(op, fn, jl, tl, jo, to)
    scalars = SCALARS if op in ("+", "*", "/", "**") else SCALARS[:3]
    for v in scalars:
        if op == "**" and isinstance(v, (int, np.integer)) and not isinstance(v, bool) and v < 0:
            ints = [c for c in left if np.dtype(c).kind in "iub"]
            for c in ints:  # an integer to a negative constant power
                with pytest.raises(TypeError):
                    jc.math_op(jl.project([c]), fn, v)
                with pytest.raises(TypeError):
                    tc.math_op(tl.project([c]), fn, v)
            floats = [c for c in left if c not in ints]
            _agree_by_column(op, fn, jl.project(floats), tl.project(floats), v, v)
            continue
        _agree_by_column(op, fn, jl, tl, v, v)


@pytest.mark.parametrize("world", [1])
def test_table_operators_and_unary_ops_match_reference(rng, world):
    n = 90
    cols = {"i": _column(rng, np.int32, n), "f": _column(rng, np.float32, n),
            "d": _column(rng, np.float64, n)}
    jt, tt = both(world, cols)
    # the JAX package's Table.__truediv__ asks its math_op for "truediv",
    # which it does not know (KeyError, ROADMAP.md C): held against "/"
    tables_equal(jc.math_op(jt, "/", 4), tt / 4)
    for call in (
        lambda t: 2 + t, lambda t: t - 1.5, lambda t: 3 * t, lambda t: t // 3,
        lambda t: t != 1, lambda t: t <= 0, lambda t: -t, lambda t: t > t,
    ):
        tables_equal(call(jt), call(tt))
    tables_equal(jc.abs_(jt), tc.abs_(tt))
    tables_equal(jc.map_columns(jt, lambda x: x * x), tc.map_columns(tt, lambda x: x * x))
    b = {"b": rng.random(n) < 0.5, "c": rng.random(n) < 0.3}
    jb, tb = both(world, b)
    tables_equal(jc.invert(jb), tc.invert(tb))
    tables_equal(~jb, ~tb)
    tables_equal(jb & jb.rename(["c", "b"]), tb & tb.rename(["c", "b"]))
    tables_equal(jb | True, tb | True)
    tables_equal(jc.is_null(jt), tc.is_null(tt))
    tables_equal(jc.not_null(jt), tc.not_null(tt))
    for bad in (lambda m: m.invert(tt), lambda m: m.division_op(tt, "/", 0),
                lambda m: m.division_op(tt, "//", 0.0)):
        with pytest.raises((ValueError, ZeroDivisionError)):
            bad(tc)
    with pytest.raises(ValueError):
        bool(tt == 1)


@pytest.mark.parametrize("world", [1])
def test_string_comparisons_use_the_sorted_dictionary(rng, world):
    """A string column against present and absent strings, and two string
    columns with different dictionaries."""
    n = 80
    cols = {"s": rng.choice(["bee", "cat", "eel", "fox"], n).astype(object)}
    cols["s"][rng.random(n) < 0.1] = None
    other = {"s": rng.choice(["ant", "cat", "dog", "fox"], n).astype(object)}
    jt, tt = both(world, cols)
    jo, to = both(world, other)
    for value in ("cat", "dog", "aaa", "zzz", "fox"):
        for fn in (operator.eq, operator.ne, operator.lt, operator.le, operator.gt, operator.ge):
            tables_equal(jc.table_compare_op(jt, value, fn), tc.table_compare_op(tt, value, fn))
    for fn in (operator.eq, operator.lt, operator.ge):
        tables_equal(jc.table_compare_op(jt, jo, fn), tc.table_compare_op(tt, to, fn))
    for bad in (lambda: tc.table_compare_op(tt, 3, operator.eq), lambda: tc.math_op(tt, "+", 1)):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("world", [1])
def test_isin_probes_in_the_column_domain(rng, world):
    """``compute.is_in`` / ``Table.isin``: integral floats probe integer
    columns, values outside the type are dropped, 0.1 never matches a
    float32 column, NaN never matches, nulls are False (or null with
    skip_null=False); strings against the dictionary."""
    n = 120
    f32 = rng.normal(size=n).astype(np.float32)
    f32[:3] = [0.5, 0.1, -2.0]
    f32[rng.random(n) < 0.1] = np.nan
    cols = {
        "i": rng.integers(-5, 20, n).astype(np.int32),
        "l": rng.integers(-5, 20, n).astype(np.int64),
        "f": f32,
        "s": rng.choice(["ant", "bee", "cat", "dog"], n).astype(object),
        "b": rng.random(n) < 0.5,
    }
    jt, tt = both(world, cols)
    values = [3, 4.0, 2**40, 7.5, -5, np.int64(19), 0.5, 0.1, float("nan"), -2.0, "bee",
              "cat", "eel", None, True]
    tables_equal(jc.is_in(jt, values), tc.is_in(tt, values))
    tables_equal(jt.isin(values, skip_null=False), tt.isin(values, skip_null=False))
    tables_equal(jt.isin([]), tt.isin([]))
    tables_equal(jt.isin(["ant"]), tt.isin(["ant"]))


@pytest.mark.parametrize("world", [1, 4])
def test_drop_na_and_nunique_match_reference(rng, world):
    """Rows and columns, how any and all, over a mask-free column, a
    nullable float and a nullable string; nunique deduplicated across the
    shards."""
    n = 100
    x = rng.normal(size=n)
    x[rng.random(n) < 0.3] = np.nan
    y = rng.normal(size=n).astype(np.float32)
    y[rng.random(n) < 0.3] = np.nan
    s = rng.choice(["a", "b", "c"], n).astype(object)
    s[rng.random(n) < 0.2] = None
    jt, tt = both(world, {"k": rng.integers(0, 5, n).astype(np.int32), "x": x, "y": y, "s": s})
    for how in ("any", "all"):
        for axis in (0, 1):
            tables_equal(jc.drop_na(jt, how=how, axis=axis), tc.drop_na(tt, how=how, axis=axis))
        tables_equal(jt.project(["x", "y"]).dropna(axis=1, how=how),
                     tt.project(["x", "y"]).dropna(axis=1, how=how))
    sub = ["x", "s"]  # each column one unique (a distributed_unique at world 4)
    assert tc.nunique(tt.project(sub)) == jc.nunique(jt.project(sub))
    tables_equal(jc.unique(jt.project(["k"])), tc.unique(tt.project(["k"])))
    with pytest.raises(ValueError):
        tc.drop_na(tt, how="some")


def test_compare_array_like_values_matches_reference():
    cases = [
        (np.array([1, 2, 3, 4], np.int32), [2, 4.0, 3.5, "3", None]),
        (np.array([0.5, np.nan, 2.0]), [0.5, float("nan"), 2]),
        (np.array(["a", "b", "c"]), ["b", b"c", 1]),
        (np.array(["a", 1, None, 2.5, float("nan")], object), ["a", 1, None, 2.5]),
    ]
    for vals, vset in cases:
        for skip in (True, False):
            np.testing.assert_array_equal(tc.compare_array_like_values(vals, vset, skip),
                                          jc.compare_array_like_values(vals, vset, skip))


def _frames(world, cols):
    jt, tt = both(world, cols)
    return ct.DataFrame(_table=jt), ctt.DataFrame(tt)


@pytest.mark.parametrize("world", [1])
def test_dataframe_operators_match_reference(rng, world):
    """``DataFrame._binop``: every column against a scalar or against the
    first column of another frame, on the raw values; ``isin`` through
    ``jnp.isin``'s promoted compare; ``~``."""
    n = 70
    cols = {"i": _column(rng, np.int32, n), "f": _column(rng, np.float32, n),
            "l": _column(rng, np.int64, n)}
    jd, td = _frames(world, cols)
    jb, tb = _frames(world, {"b": rng.random(n) < 0.5})
    for call in (
        lambda d: d["i"] * 2.5, lambda d: d["i"] * 2, lambda d: d["f"] * 2,
        lambda d: d["i"] / d["i"].__add__(100), lambda d: d["f"] + d["i"],
        lambda d: d["l"] - d["f"], lambda d: d[["i", "l"]] > 0, lambda d: d["f"] <= 1.5,
        lambda d: d["i"] == d["l"], lambda d: d["f"] != d["f"], lambda d: d["i"] >= -3,
        lambda d: d["i"] < 2, lambda d: d[["i", "l"]] & 6, lambda d: d["i"] | d["l"],
        lambda d: d[["i", "f"]].isin([1, 2, 3.0, 0.5]), lambda d: ~d["i"],
    ):
        tables_equal(call(jd).table, call(td).table)
    tables_equal((~jb).table, (~tb).table)
    tables_equal((jb & jb).table, (tb & tb).table)
