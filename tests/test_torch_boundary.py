"""The port's boundaries: it imports neither JAX nor the JAX package (its
Python modules, nor its C and C++ sources), its device rule (the card
unless the caller asks for the CPU), and the arguments it has not ported
raise NotImplementedError."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu_torch as ctt
import _torch_jax_native as J

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cylon_tpu_torch"


def test_import_leaves_jax_out():
    modules = sorted(
        "cylon_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys, importlib\n"
        "import cylon_tpu_torch\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cylon_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_no_import_of_jax_anywhere_in_the_source():
    """Also catches imports inside functions, which an import does not run;
    the multi-process tests' rank script too."""
    for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                           ROOT / "tests" / "_torch_mp_worker.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "cylon_tpu"), (path, name)


def test_gpu_config_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.GPUConfig()
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu"))
    assert ctx.device == torch.device("cpu") and ctx.world_size == 1


def _tables():
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu"))
    t = ctt.Table.from_pydict(ctx, {"k": np.arange(8, dtype=np.int32), "v": np.ones(8)})
    return ctx, t


@pytest.mark.parametrize(
    "call",
    [
        lambda t: t.lazy().dispatch(),
        lambda t: t.lazy().collect_async().result(60),
        lambda t: ctt.parallel.spill.plan_schedule(np.full((2, 2), 64, np.int64), 8, 2, 1 << 20,
                                                   trigger=4),
    ],
)
def test_unported_arguments_raise(call):
    """The calls that raised until the feedback re-coster and serving were
    ported (A9b, A9c), against the JAX package's same call: ``dispatch``,
    ``collect_async().result()``, ``plan_schedule(trigger=4)``."""
    import jax

    import cylon_tpu as ct
    from cylon_tpu.parallel import spill as jspill

    _ctx, t = _tables()
    jt = ct.Table.from_pydict(
        ct.CylonContext.init_distributed(ct.TPUConfig(devices=jax.devices()[:1])), t.to_pydict())
    got = call(t)
    if isinstance(got, ctt.Table):
        assert got.to_pandas().equals(jt.lazy().collect().to_pandas())
    else:
        want = jspill.plan_schedule(np.full((2, 2), 64, np.int64), 8, 2, 1 << 20, trigger=4)
        assert (got.bucket_cap, got.n_rounds, got.relay) == (want.bucket_cap, want.n_rounds,
                                                             want.relay)


@pytest.mark.parametrize("call", ["from_arrow", "to_arrow", "to_csv"])
def test_arrow_and_csv_calls_give_the_jax_packages_results(tmp_path, call):
    """The calls that raised until the I/O layers were ported, against the
    JAX package's on the same table (tests/test_torch_io.py holds the rest
    of the I/O surface)."""
    import jax

    import cylon_tpu as ct

    _ctx, t = _tables()
    jctx = ct.CylonContext.init_distributed(ct.TPUConfig(devices=jax.devices()[:1]))
    jt = ct.Table.from_pydict(jctx, t.to_pydict())
    if call == "from_arrow":
        got = ctt.Table.from_arrow(t.ctx, jt.to_arrow())
        assert got.to_pandas().equals(jt.to_pandas()) and got._ref["k"].data.dtype == torch.int32
    elif call == "to_arrow":
        assert t.to_arrow().equals(jt.to_arrow())
    else:
        J.require_jax_native()
        t.to_csv(str(tmp_path / "t.csv"))
        jt.to_csv(str(tmp_path / "j.csv"))
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


NATIVE_SOURCES = ("native/csv.cpp", "native/runtime.cpp", "native/capi.cpp",
                  "native/examples/capi_client.c", "native/examples/java_abi_harness.c")


@pytest.mark.parametrize("rel", NATIVE_SOURCES)
def test_native_sources_reach_neither_jax_nor_the_jax_package(rel):
    """The port's C and C++ sources are its own copies: none imports a
    Python module of the JAX package, includes a file of its tree, or
    loads its libraries."""
    import re

    text = (PKG / rel).read_text()
    for mod in re.findall(r'PyImport_ImportModule\("([^"]+)"\)', text):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "cylon_tpu"), (rel, mod)
    assert not re.search(r'#include\s*[<"][^>"]*cylon_tpu/', text), rel
    assert "_cylon_native" not in text and "_cylon_capi" not in text, rel
    if rel == "native/capi.cpp":
        assert 'PyImport_ImportModule("cylon_tpu_torch")' in text


def test_world_size_above_one_raises(monkeypatch):
    """Above one shard only a missing card raises: a CPU context of two
    shards splits rows in contiguous blocks and its to_pandas round-trips,
    while GPUConfig(world_size=2) without a card is an error."""
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=2))
    assert ctx.world_size == 2 and ctx.devices == [torch.device("cpu")] * 2
    df = pd.DataFrame({"k": np.arange(7, dtype=np.int32), "s": list("abcabca"),
                       "x": [1.5, np.nan, 2.5, 3.5, 4.5, 5.5, 6.5]})
    t = ctt.Table.from_pandas(ctx, df)
    assert t.row_counts.tolist() == [4, 3]
    pd.testing.assert_frame_equal(t.to_pandas(), df)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.GPUConfig(world_size=2)


def test_pandas_round_trip_and_errors():
    ctx, t = _tables()
    df = t.to_pandas()
    assert list(df.columns) == ["k", "v"] and len(df) == 8
    with pytest.raises(KeyError):
        t.join(t, on="missing")
    with pytest.raises(ValueError):
        t.join(t)
    s = ctt.Table.from_pydict(ctx, {"k": np.array(["a", "b"], dtype=object)})
    with pytest.raises(ValueError, match="string key"):
        t.join(s, on="k")


PLANNER = ("ordering.py", "utils/tracing.py", "plan/__init__.py", "plan/expr.py",
           "plan/nodes.py", "plan/rules.py", "plan/lower.py", "plan/lazy.py",
           "plan/feedback.py", "obs/slo.py", "serve/__init__.py", "serve/future.py",
           "serve/batch.py", "serve/scheduler.py")


@pytest.mark.parametrize("rel", PLANNER)
def test_planner_modules_import_neither_jax_nor_the_jax_package(rel):
    """The order descriptors, the planner, the feedback re-coster, the SLO
    monitor and the serving layer keep their own copies of the JAX
    package's modules (none of which imports JAX itself), and import it
    nowhere, not even inside a function."""
    path = PKG / rel
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in ("jax", "jaxlib", "cylon_tpu") for n in names), (rel, names)
    module = "cylon_tpu_torch." + rel[:-3].replace("/", ".").replace(".__init__", "")
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cylon_tpu')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert out.returncode == 0, out.stderr


TORCHRUN_VARS = {"WORLD_SIZE", "RANK", "LOCAL_RANK"}


def test_environment_is_read_only_through_the_knob_registry():
    """Outside utils/envgate.py no module of the port touches os.environ
    (or getenv), but config.py's reads of torch's launcher variables; and
    every knob the registry declares is named CYLON_TPU_TORCH_*."""
    for path in PKG.rglob("*.py"):
        rel = path.relative_to(PKG).as_posix()
        if rel == "utils/envgate.py":
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "os":
                assert not {a.name for a in node.names} & {"environ", "getenv", "putenv"}, rel
            if not (isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv", "putenv")):
                continue
            assert rel == "config.py", (rel, node.lineno)
        if rel == "config.py":
            reads = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                     and isinstance(n.func, ast.Attribute) and n.func.attr == "get"
                     and isinstance(n.func.value, ast.Attribute) and n.func.value.attr == "environ"]
            assert reads and {r.args[0].value for r in reads} <= TORCHRUN_VARS
    from cylon_tpu_torch.utils import envgate

    assert envgate.REGISTRY and all(k.startswith("CYLON_TPU_TORCH_") for k in envgate.REGISTRY)
