"""The port's boundaries: it imports neither JAX nor the JAX package, its
device rule (the card unless the caller asks for the CPU), and the
arguments it has not ported raise NotImplementedError."""
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
    """Also catches imports inside functions, which an import does not run."""
    for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
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
        lambda t: t.distributed_join(t, on="k", mode="fused"),
        lambda t: t.join(t, on="k", algorithm="pallas_pk"),
        lambda t: t.join(t, on="k", emit_order="key"),
        lambda t: t.groupby("k", {"v": "var"}),
        lambda t: t.groupby("k", {"v": "nunique"}),
    ],
)
def test_unported_arguments_raise(call):
    _ctx, t = _tables()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(t)


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
