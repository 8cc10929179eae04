"""The port's I/O (cylon_tpu_torch/io: read_csv, write_csv, read_parquet,
write_parquet; Table.to_arrow / from_arrow) against the JAX package's on
the CPU, at worlds 1, 2 and 4, on files made with numpy from fixed seeds:

- ``write_csv`` gives the JAX package's bytes, one file or one a shard;
- ``read_csv`` gives the JAX package's tables, shard for shard (type,
  validity and values): one path split evenly, world_size paths one a
  shard, 3 paths at world 4 concatenated and split again; files whose
  dictionaries differ and whose inferred types disagree (int64 in one,
  float64 in another) are promoted and unified alike;
- the options the native codec leaves to pyarrow (``na_values``,
  ``ignore_empty_lines(False)``, ``with_column_types``) and the kill
  switch CYLON_TPU_TORCH_NO_NATIVE=1 give the JAX package's tables and
  bytes through its pyarrow and pandas routes;
- parquet round trips, one file or one a shard, and typed Arrow
  (dictionary, nullable int, timestamp, duration), ``to_arrow(shard=i)``;
- the reference's goldens (tests/data, as tests/test_golden.py holds the
  JAX package to them) read by the port's ``read_csv`` and computed by its
  distributed operators at worlds 1, 2 and 4.

Every comparison is exact.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu import native as jnative
import _torch_jax_native as J
import _torch_mp_worker as W
from test_torch_compute import tables_equal
from test_torch_shuffle_slice import _contexts, _encode

torch.set_num_threads(1)
J.load_jax_native()  # one xdist worker's first build at a time

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _cols(rng, n):
    x = rng.normal(size=n)
    x[rng.random(n) < 0.2] = np.nan
    f = rng.normal(size=n).astype(np.float32)
    s = rng.choice(["bee", "cat,dog", 'say "hi"', "eel"], n).astype(object)
    s[rng.random(n) < 0.2] = None
    b = (rng.random(n) < 0.5).astype(object)
    b[rng.random(n) < 0.1] = None
    return {"k": rng.integers(-50, 50, n).astype(np.int32), "l": rng.integers(-2**40, 2**40, n),
            "x": x, "f": f, "s": s, "b": b, "u": rng.integers(0, 200, n).astype(np.uint8)}


def both(world, cols):
    jctx, tctx = _contexts(world)
    enc = _encode(cols)
    return ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)


@pytest.mark.parametrize("world", [1, 4])
def test_write_csv_bytes_equal_the_jax_writer(tmp_path, world):
    jt, tt = both(world, _cols(np.random.default_rng(1), 203))
    J.require_jax_native()
    for i, opts in enumerate((None, ("|", ["K", "L", "X", "F", "S", "B", "U"]))):
        jo = to = None
        if opts is not None:
            jo = ct.CSVWriteOptions().with_delimiter(opts[0]).with_column_names(opts[1])
            to = ctt.CSVWriteOptions().with_delimiter(opts[0]).with_column_names(opts[1])
        ct.write_csv(jt, str(tmp_path / f"j{i}.csv"), jo)
        ctt.write_csv(tt, str(tmp_path / f"t{i}.csv"), to)
        assert (tmp_path / f"t{i}.csv").read_bytes() == (tmp_path / f"j{i}.csv").read_bytes()
        jp = [str(tmp_path / f"j{i}_{s}.csv") for s in range(world)]
        tp = [str(tmp_path / f"t{i}_{s}.csv") for s in range(world)]
        ct.write_csv(jt, jp, jo)
        tt.to_csv(tp, to)
        for a, b in zip(tp, jp):
            assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="paths"):
        ctt.write_csv(tt, [str(tmp_path / "x.csv")] * (world + 1))


def _write_files(tmp_path, rng, n_files, rows=60):
    """CSV files of ints, floats with nulls, bools and strings whose
    dictionaries differ from file to file; column m is int64 in the even
    files and float64 in the odd ones (the unification promotes it)."""
    paths = []
    for i in range(n_files):
        words = [f"w{j}" for j in range(3 * i, 3 * i + 5)] + ['a "q", b']
        frame = {
            "k": rng.integers(0, 30, rows), "x": rng.normal(size=rows),
            "b": rng.random(rows) < 0.5, "s": rng.choice(words, rows),
            "m": rng.integers(0, 9, rows) + (0.5 if i % 2 else 0),
        }
        lines = ["k,x,b,s,m"]
        for r in range(rows):
            x = "" if r % 7 == 3 else repr(float(frame["x"][r]))
            s = frame["s"][r]
            s = '"' + s.replace('"', '""') + '"' if '"' in s else s
            lines.append(f"{frame['k'][r]},{x},{str(bool(frame['b'][r])).lower()},{s},{frame['m'][r]}")
        p = tmp_path / f"in_{i}.csv"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("world,layout", [(1, "one"), (1, "per_shard"), (2, "per_shard"),
                                          (4, "one"), (4, "per_shard"), (4, "three")])
def test_read_csv_equals_the_jax_read(tmp_path, world, layout):
    n_files = {"one": 1, "per_shard": world, "three": 3}[layout]
    paths = _write_files(tmp_path, np.random.default_rng(2 + world), n_files)
    arg = paths[0] if layout == "one" else paths
    jctx, tctx = _contexts(world)
    J.require_jax_native()
    jt, tt = ct.read_csv(jctx, arg), ctt.read_csv(tctx, arg)
    tables_equal(jt, tt)
    if n_files > 1:  # m: int64 in one file, float64 in another -> float64
        assert tt._ref["m"].dtype.type == ctt.Table.from_pydict(tctx, {"m": [0.5]})._ref["m"].dtype.type
    got, want = tt.to_pydict(), jt.to_pydict()
    for c in want:
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(want[c]), err_msg=c)


def _arrow_files(tmp_path):
    """A file for the pyarrow-only options: 'NA' and '-' as nulls, and
    empty lines."""
    p = tmp_path / "na.csv"
    p.write_text("k,v,s\n1,2.5,a\n\n2,NA,-\n3,-,c\n\n4,1.5,NA\n")
    return str(p)


ARROW_CASES = {
    "na_values": lambda m: m.CSVReadOptions().na_values(["NA", "-"]),
    "keep_empty_lines": lambda m: m.CSVReadOptions().ignore_empty_lines(False)
    .na_values(["NA", "-"]),
    "column_types": lambda m: m.CSVReadOptions().na_values(["NA", "-"])
    .with_column_types({"k": np.int32, "v": "float32"}),
}


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("case", list(ARROW_CASES))
def test_pyarrow_options_give_the_jax_tables(tmp_path, world, case):
    path = _arrow_files(tmp_path)
    jctx, tctx = _contexts(world)
    arg = path if world == 1 else [path] * world
    jt = ct.read_csv(jctx, arg, ARROW_CASES[case](ct))
    tt = ctt.read_csv(tctx, arg, ARROW_CASES[case](ctt))
    assert ARROW_CASES[case](ctt)._needs_arrow()
    tables_equal(jt, tt)


@pytest.mark.parametrize("world", [1, 4])
def test_kill_switch_gives_the_jax_pyarrow_and_pandas_routes(tmp_path, world, monkeypatch):
    paths = _write_files(tmp_path, np.random.default_rng(11), world)
    jctx, tctx = _contexts(world)
    arg = paths if world > 1 else paths[0]
    monkeypatch.setattr(jnative, "available", lambda: False)  # the JAX side's own switch
    monkeypatch.setenv("CYLON_TPU_TORCH_NO_NATIVE", "1")
    jt, tt = ct.read_csv(jctx, arg), ctt.read_csv(tctx, arg)
    tables_equal(jt, tt)
    ct.write_csv(jt, str(tmp_path / "j.csv"))
    ctt.write_csv(tt, str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_temporal_and_uint64_columns_write_through_pandas(tmp_path):
    ts = np.array(["2024-01-02T03:04:05", "NaT", "1999-12-31T23:59:59.5"], "datetime64[ns]")
    cols = {"t": ts, "d": np.array([1, 2, 3], "timedelta64[s]"),
            "u": np.array([2**63 + 5, 0, 7], np.uint64), "k": np.arange(3)}
    jt, tt = both(1, cols)
    ct.write_csv(jt, str(tmp_path / "j.csv"))
    ctt.write_csv(tt, str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert "9223372036854775813" in (tmp_path / "t.csv").read_text()


def parquet_round_trips(tmp_path, world):
    """The parquet checks of :func:`test_parquet_round_trips_equal_the_jax_package`,
    run in a child process of their own."""
    import pyarrow.parquet as pq

    jctx, tctx = _contexts(world)
    jt, tt = both(world, _cols(np.random.default_rng(5), 150))
    ctt.write_parquet(tt, str(tmp_path / "t.parquet"))
    ct.write_parquet(jt, str(tmp_path / "j.parquet"))
    assert pq.read_table(tmp_path / "t.parquet").equals(pq.read_table(tmp_path / "j.parquet"))
    tables_equal(ct.read_parquet(jctx, str(tmp_path / "j.parquet")),
                 ctt.read_parquet(tctx, str(tmp_path / "t.parquet")))
    opts = ctt.ParquetOptions().chunk_size(16).writer_properties(compression="zstd")
    tp = [str(tmp_path / f"t_{s}.parquet") for s in range(world)]
    ctt.write_parquet(tt, tp, opts)
    assert pq.ParquetFile(tp[0]).metadata.num_row_groups == -(-int(tt.row_counts[0]) // 16)
    for s, p in enumerate(tp):
        assert pq.read_table(p).equals(jt.to_arrow(shard=s))
    tables_equal(ct.read_parquet(jctx, tp), ctt.read_parquet(tctx, tp))
    if world == 4:  # three files: concatenated, then split evenly
        tables_equal(ct.read_parquet(jctx, tp[:3]),
                     ctt.read_parquet(tctx, tp[:3], ctt.ParquetOptions().concurrent_file_reads(False)))


_CHILD = """
import json, os, sys, traceback
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
from pathlib import Path
sys.path.insert(0, {tests!r})
import test_torch_io
got = {{}}
for world in (1, 4):
    tmp = Path({tmp!r}) / str(world)
    tmp.mkdir()
    try:
        test_torch_io.parquet_round_trips(tmp, world)
        got[world] = "ok"
    except Exception:
        got[world] = traceback.format_exc()
print(json.dumps(got))
"""


@pytest.fixture(scope="module")
def parquet_results(tmp_path_factory):
    """{world: "ok" or the traceback} of :func:`parquet_round_trips` at
    worlds 1 and 4, run in one child process: a parquet write or read in a
    process that goes on to compile XLA programs has made a later compile
    segfault there (jaxlib beside pyarrow's parquet I/O, on the CPU), so no
    test worker runs one. The child starts with none of either package's
    knobs set, as a fresh test process does: tests that set them in
    ``os.environ`` without restoring them leave them to later tests. A
    child that fails gives its error output as each world's result."""
    def compute():
        code = _CHILD.format(tests=os.path.dirname(os.path.abspath(__file__)),
                             tmp=str(tmp_path_factory.mktemp("parquet")))
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {k: v for k, v in os.environ.items() if not k.startswith("CYLON_TPU")}
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=300, cwd=root, env=dict(env, PYTHONPATH=root))
        if out.returncode != 0:
            return {w: out.stderr[-3000:] for w in (1, 4)}
        return {int(k): v for k, v in json.loads(out.stdout.strip().splitlines()[-1]).items()}

    # once per test session, shared by the xdist workers
    return W.shared_result(tmp_path_factory, "parquet_round_trips", compute)


@pytest.mark.parametrize("world", [1, 4])
def test_parquet_round_trips_equal_the_jax_package(parquet_results, world):
    assert parquet_results[world] == "ok", parquet_results[world]


def _typed_arrow():
    import pyarrow as pa

    n = 40
    rng = np.random.default_rng(6)
    mask = rng.random(n) < 0.25
    dict_arr = pa.DictionaryArray.from_arrays(
        pa.array(rng.integers(0, 4, n).astype(np.int32), mask=mask),
        pa.array(["zeta", "alpha", "mid", "beta"]))  # not sorted: the codes are remapped
    return pa.table({
        "d": dict_arr,
        "i": pa.array(rng.integers(-9, 9, n), mask=rng.random(n) < 0.3),  # nullable int64
        "t": pa.array(np.arange(n).astype("datetime64[s]"), mask=mask).cast(pa.timestamp("ms")),
        "dt": pa.array(np.arange(n).astype("timedelta64[us]"), mask=~mask),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.2),
        "f": pa.array(rng.normal(size=n).astype(np.float32)),
        "s": pa.array(rng.choice(["x", "y"], n).tolist()),
        "day": pa.array(np.arange(n).astype("datetime64[D]")),
    })


@pytest.mark.parametrize("world", [1, 4])
def test_typed_arrow_equals_the_jax_package(world):
    import pyarrow as pa  # inside the test: collection leaves pyarrow unloaded

    jctx, tctx = _contexts(world)
    at = _typed_arrow()
    jt, tt = ct.Table.from_arrow(jctx, at), ctt.Table.from_arrow(tctx, at)
    tables_equal(jt, tt)
    assert tt._ref["i"].data.dtype == torch.int64 and tt._ref["i"].valid is not None
    assert list(tt._ref["d"].dictionary) == ["alpha", "beta", "mid", "zeta"]
    assert tt.to_arrow().equals(jt.to_arrow())
    for s in range(world):
        assert tt.to_arrow(shard=s).equals(jt.to_arrow(shard=s))
    tables_equal(jt, ctt.Table.from_arrow(tctx, tt.to_arrow()))
    with pytest.raises(TypeError, match="unsupported arrow type"):
        ctt.Table.from_arrow(tctx, pa.table({"l": pa.array([[1], [2]])}))


# ----------------------------------------------------------------------
# the reference's goldens (tests/test_golden.py), through the port
# ----------------------------------------------------------------------

_PORT_CTX = {}


def _port_ctx(world):
    if world not in _PORT_CTX:
        _PORT_CTX[world] = ctt.CylonContext.init_distributed(
            ctt.GPUConfig(device="cpu", world_size=world))
    return _PORT_CTX[world]


def _inputs(ctx, side):
    return ctt.read_csv(ctx, [os.path.join(DATA, f"csv{side}_{r}.csv") for r in range(4)])


def _golden(ctx, name):
    return ctt.read_csv(ctx, os.path.join(DATA, f"{name}.csv"))


def _set_equal(got, expect):
    """The reference's check: counts and a two-way subtract."""
    assert got.row_count == expect.row_count
    assert got.column_names == expect.column_names
    assert got.distributed_subtract(expect).row_count == 0
    assert expect.distributed_subtract(got).row_count == 0


def _multiset_equal(got, expect, columns):
    gp = got.to_pandas()[columns].sort_values(columns).reset_index(drop=True)
    ep = expect.to_pandas()[columns].sort_values(columns).reset_index(drop=True)
    pd.testing.assert_frame_equal(gp, ep, check_dtype=False)


def _golden_join(how):
    def run(ctx):
        got = _inputs(ctx, 1).distributed_join(_inputs(ctx, 2), on="k", how=how)
        expect = _golden(ctx, f"join_{how}")
        got = got.rename({"k_x": "k"}).drop(["k_y"])
        assert got.row_count == expect.row_count
        _multiset_equal(got, expect, [c for c in expect.column_names if c in got.column_names])
    return run


def _golden_sort(ctx):
    got = _inputs(ctx, 1).distributed_sort(["k", "v"]).to_pandas()[["k", "v"]]
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  _golden(ctx, "sort_kv").to_pandas()[["k", "v"]],
                                  check_dtype=False)


GOLDENS = {
    **{f"join_{how}": _golden_join(how) for how in ("inner", "left", "right", "outer")},
    "union": lambda c: _set_equal(_inputs(c, 1).distributed_union(_inputs(c, 2)),
                                  _golden(c, "union")),
    "subtract": lambda c: _set_equal(_inputs(c, 1).distributed_subtract(_inputs(c, 2)),
                                     _golden(c, "subtract")),
    "intersect": lambda c: _set_equal(_inputs(c, 1).distributed_intersect(_inputs(c, 2)),
                                      _golden(c, "intersect")),
    "sort_kv": _golden_sort,
    "groupby_sum": lambda c: _set_equal(_inputs(c, 1).distributed_groupby("k", {"v": "sum"}),
                                        _golden(c, "groupby_sum")),
    "unique": lambda c: _set_equal(_inputs(c, 1).distributed_unique(), _golden(c, "unique")),
}


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("golden", list(GOLDENS))
def test_reference_goldens_hold(world, golden):
    GOLDENS[golden](_port_ctx(world))
