"""cylon_tpu_torch: the PyTorch / CUDA port of cylon_tpu.

The JAX package (``cylon_tpu``) stays the reference; this package keeps its
module structure and names and runs on one NVIDIA Hopper card (or on the
CPU when the caller asks for it). It imports neither JAX nor ``cylon_tpu``.

    import cylon_tpu_torch as ctt
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig())  # cuda:0
    left = ctt.Table.from_pandas(ctx, df_left)
    right = ctt.Table.from_pandas(ctx, df_right)
    joined = left.distributed_join(right, on="k", how="inner")
    out = joined.distributed_groupby("k_x", {"v": "sum"}).to_pandas()
"""
from .config import GPUConfig
from .context import CylonContext
from .table import Table

__all__ = ["CylonContext", "GPUConfig", "Table"]
