"""cylon_tpu_torch: the PyTorch / CUDA port of cylon_tpu.

The JAX package (``cylon_tpu``) stays the reference; this package keeps its
module structure and names and runs on NVIDIA Hopper cards (or on the
CPU when the caller asks for it). It imports neither JAX nor ``cylon_tpu``.

    import cylon_tpu_torch as ctt
    env = ctt.CylonEnv(config=ctt.GPUConfig())  # cuda:0
    orders = ctt.DataFrame(df_orders, ctx=env.context)
    customers = ctt.DataFrame(df_customers, ctx=env.context)
    joined = orders.merge(customers, on="cust", env=env)
    by_seg = joined.groupby("segment", env=env).agg({"price": "sum"})

or, one level down, ``Table.from_pandas(ctx, df)`` with
``distributed_join(..., algorithm="sort" | "pallas_pk")`` and
``distributed_groupby``. One process per shard, as under ``mpirun``:
``GPUConfig(coordinator_address="host:port", num_processes=W,
process_id=rank)`` (NCCL on the cards, gloo on the CPU), or
``coordinator_address="env://"`` under ``torchrun``. Lazy plans:
``t.lazy().join(u.lazy(), on="k").filter(col("v") > 0).groupby("k",
{"v": "sum"})`` with ``.explain()`` and ``.collect()``.

Files: ``read_csv(ctx, path or [one path a shard])`` through the native
C++ codec (``native/``), ``write_csv(table, path or paths)``,
``read_parquet`` / ``write_parquet`` through pyarrow, with
``CSVReadOptions``, ``CSVWriteOptions`` and ``ParquetOptions``; and
``Table.to_arrow`` / ``from_arrow``. A foreign language drives the same
calls through the C ABI of ``native/capi.cpp`` (``native.build_capi()``).

Streams: ``AppendableTable(ctx, columns)`` grows by ``append(batch)``;
``stream.view(lambda t: t.lazy()...groupby(...), tab).refresh()`` keeps a
plan's result up to date on the appended rows only, and
``stream.subscribe(view)`` refreshes it through the serving scheduler.
"""
from . import compute, indexing
from .config import GPUConfig
from .context import CylonContext
from .frame import CylonEnv, DataFrame
from .io import (
    CSVReadOptions, CSVWriteOptions, ParquetOptions, read_csv, read_parquet, write_csv,
    write_parquet,
)
from .join_config import JoinConfig
from .plan import LazyFrame, col, lit
from .series import Series
from .table import Table, concat
from . import stream
from .stream import AppendableTable, IncrementalView, Subscription

__all__ = ["AppendableTable", "CSVReadOptions", "CSVWriteOptions", "CylonContext", "CylonEnv",
           "DataFrame", "GPUConfig", "IncrementalView", "JoinConfig", "LazyFrame",
           "ParquetOptions", "Series", "Subscription", "Table", "col", "compute", "concat",
           "indexing", "lit", "read_csv", "read_parquet", "stream", "write_csv",
           "write_parquet"]
