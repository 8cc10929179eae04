"""cylon_tpu_torch: the PyTorch / CUDA port of cylon_tpu.

The JAX package (``cylon_tpu``) stays the reference; this package keeps its
module structure and names and runs on one NVIDIA Hopper card (or on the
CPU when the caller asks for it). It imports neither JAX nor ``cylon_tpu``.

    import cylon_tpu_torch as ctt
    env = ctt.CylonEnv(config=ctt.GPUConfig())  # cuda:0
    orders = ctt.DataFrame(df_orders, ctx=env.context)
    customers = ctt.DataFrame(df_customers, ctx=env.context)
    joined = orders.merge(customers, on="cust", env=env)
    by_seg = joined.groupby("segment", env=env).agg({"price": "sum"})

or, one level down, ``Table.from_pandas(ctx, df)`` with
``distributed_join(..., algorithm="sort" | "pallas_pk")`` and
``distributed_groupby``.
"""
from .config import GPUConfig
from .context import CylonContext
from .frame import CylonEnv, DataFrame
from .join_config import JoinConfig
from .table import Table

__all__ = ["CylonContext", "CylonEnv", "DataFrame", "GPUConfig", "JoinConfig", "Table"]
