"""CSV ingest and egress at the host boundary (counterpart of
cylon_tpu/io/csv.py).

Reference analog: io/arrow_io.cpp:33-61 (Arrow csv::TableReader over mmap),
the CSVReadOptions chain (io/csv_read_config.hpp), WriteCSV's row-wise
printer (table.cpp:244-253) and the concurrent multi-file reads
(table.cpp:791-829).

The native C++ codec (native/csv.cpp: mmap, multithreaded tokenize, typed
parse, dictionary-encoded strings) reads and writes: host columns arrive in
the table's physical encoding and are staged to the devices once
(``Table.from_encoded`` / ``from_encoded_shards``). pyarrow reads only for
the options the codec does not cover (:meth:`CSVReadOptions._needs_arrow`)
and under CYLON_TPU_TORCH_NO_NATIVE=1; pandas writes only temporal and
uint64 columns, and under that switch.

Under ``torch.distributed`` a list of world_size paths is read per rank:
each rank parses only the files of its own shards and gathers the others'
row counts, types and dictionaries before it unifies (the JAX package
reads every file in every process); likewise each rank writes only its own
shards' files, and one file of the whole table is written by the rank that
owns shard 0 after every rank took part in the gather.
"""
from __future__ import annotations

import concurrent.futures
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import native
from ..context import CylonContext
from ..dtypes import DataType, Type
from ..table import Encoded, Table, unify_encoded_shards


class CSVReadOptions:
    """Options set by chained calls (reference io/csv_read_config.hpp:30+)."""

    def __init__(self):
        self._delimiter = ","
        self._use_threads = True
        self._block_size = 1 << 20
        self._skip_rows = 0
        self._column_names: Optional[List[str]] = None
        self._na_values: Optional[List[str]] = None
        self._ignore_empty_lines = True
        self._column_types: Optional[Dict[str, Any]] = None

    def with_delimiter(self, d: str) -> "CSVReadOptions":
        self._delimiter = d
        return self

    def use_threads(self, flag: bool) -> "CSVReadOptions":
        self._use_threads = flag
        return self

    def block_size(self, b: int) -> "CSVReadOptions":
        self._block_size = b
        return self

    def skip_rows(self, n: int) -> "CSVReadOptions":
        self._skip_rows = n
        return self

    def with_column_names(self, names: Sequence[str]) -> "CSVReadOptions":
        self._column_names = list(names)
        return self

    def na_values(self, vals: Sequence[str]) -> "CSVReadOptions":
        """Strings parsed as null (reference CSVReadOptions::NullValues)."""
        self._na_values = [str(v) for v in vals]
        return self

    def ignore_empty_lines(self, flag: bool) -> "CSVReadOptions":
        """False keeps empty lines as all-null rows (reference
        CSVReadOptions::IgnoreEmptyLines)."""
        self._ignore_empty_lines = bool(flag)
        return self

    def with_column_types(self, types: Dict[str, Any]) -> "CSVReadOptions":
        """Per-column dtype overrides (numpy dtypes or strings; reference
        CSVReadOptions::WithColumnTypes)."""
        self._column_types = dict(types)
        return self

    def _needs_arrow(self) -> bool:
        """The native codec covers the defaults; these breadth options take
        the pyarrow codec instead of a second parser."""
        return (
            self._na_values is not None
            or not self._ignore_empty_lines
            or self._column_types is not None
        )


class CSVWriteOptions:
    """Write options set by chained calls (reference io/csv_write_config.hpp:34-47:
    WithDelimiter and a ColumnNames header override)."""

    def __init__(self):
        self._delimiter = ","
        self._column_names: Optional[List[str]] = None

    def with_delimiter(self, d: str) -> "CSVWriteOptions":
        self._delimiter = d
        return self

    def with_column_names(self, names: Sequence[str]) -> "CSVWriteOptions":
        """Override the header row (reference CSVWriteOptions::ColumnNames)."""
        self._column_names = [str(n) for n in names]
        return self

    def _header_names(self, table_names: List[str]) -> List[str]:
        if self._column_names is None:
            return table_names
        if len(self._column_names) != len(table_names):
            raise ValueError(
                f"ColumnNames override has {len(self._column_names)} names, "
                f"table has {len(table_names)} columns"
            )
        return self._column_names


# native ColType -> logical DataType
_CT_TO_DTYPE = {
    native.CT_INT64: DataType(Type.INT64),
    native.CT_FLOAT64: DataType(Type.DOUBLE),
    native.CT_BOOL: DataType(Type.BOOL),
    native.CT_STRING: DataType(Type.STRING),
}


def _io_workers(n_paths: int) -> int:
    """Bounded IO pool: a thread a path, capped so hundreds of per-rank
    shard paths don't oversubscribe the host (each read also parses)."""
    import os

    return max(1, min(n_paths, 4 * (os.cpu_count() or 1), 32))


def _read_many(read, paths: Sequence[str]) -> list:
    """``read(p)`` of every path, in a bounded thread pool."""
    if len(paths) <= 1:
        return [read(p) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(max_workers=_io_workers(len(paths))) as ex:
        return list(ex.map(read, paths))


def _read_one_native(path: str, options: CSVReadOptions) -> "OrderedDict[str, Encoded]":
    cols = native.read_csv(
        path,
        delimiter=options._delimiter,
        skip_rows=options._skip_rows,
        has_header=options._column_names is None,
        num_threads=0 if options._use_threads else 1,
    )
    out: "OrderedDict[str, Encoded]" = OrderedDict()
    for i, c in enumerate(cols):
        name = (
            options._column_names[i]
            if options._column_names is not None and i < len(options._column_names)
            else c.name
        )
        out[name] = (c.data, c.valid, _CT_TO_DTYPE[c.ctype], c.dictionary)
    return out


def _read_one_arrow(path: str, options: CSVReadOptions) -> Dict[str, np.ndarray]:
    import pyarrow as pa
    from pyarrow import csv as pacsv

    ropts = pacsv.ReadOptions(
        use_threads=options._use_threads,
        block_size=options._block_size,
        skip_rows=options._skip_rows,
        column_names=options._column_names,
    )
    popts = pacsv.ParseOptions(
        delimiter=options._delimiter,
        ignore_empty_lines=options._ignore_empty_lines,
    )
    ckw: Dict[str, Any] = {}
    if options._na_values is not None:
        ckw["null_values"] = options._na_values
        ckw["strings_can_be_null"] = True
    if options._column_types is not None:
        ckw["column_types"] = {
            name: pa.from_numpy_dtype(np.dtype(t)) for name, t in options._column_types.items()
        }
    copts = pacsv.ConvertOptions(**ckw) if ckw else None
    at = pacsv.read_csv(path, read_options=ropts, parse_options=popts, convert_options=copts)
    return {name: at.column(name).to_numpy(zero_copy_only=False) for name in at.column_names}


def concat_encoded(shards: List[Dict[str, Encoded]]) -> "OrderedDict[str, Encoded]":
    """Unified per-file encodings as one: the columns concatenated in file
    order (a file without a mask counts as all valid)."""
    merged: "OrderedDict[str, Encoded]" = OrderedDict()
    for n in shards[0]:
        data = np.concatenate([s[n][0] for s in shards])
        valid = None
        if any(s[n][1] is not None for s in shards):
            valid = np.concatenate([s[n][1] if s[n][1] is not None
                                    else np.ones(len(s[n][0]), bool) for s in shards])
        merged[n] = (data, valid, shards[0][n][2], shards[0][n][3])
    return merged


def read_csv(
    ctx: CylonContext,
    paths: Union[str, Sequence[str]],
    options: Optional[CSVReadOptions] = None,
) -> Table:
    """Read CSV file(s) into a sharded Table.

    - one path: its rows split evenly over the shards;
    - a list of world_size paths: file i becomes shard i (the reference's
      per-rank ``csv1_{RANK}.csv`` pattern), with no global concatenation;
      under several processes each rank reads only its own shards' files;
    - a list of any other length: concatenated in order, then split
      evenly.
    """
    options = options or CSVReadOptions()
    many = isinstance(paths, (list, tuple))
    local = ctx.local_shards
    if not options._needs_arrow() and native.available():
        def read(p):
            return _read_one_native(p, options)

        if not many:
            return Table.from_encoded(ctx, read(paths))
        if len(paths) == ctx.world_size:
            got = dict(zip(local, _read_many(read, [paths[s] for s in local])))
            return Table._from_local_encoded(ctx, [got.get(s) for s in range(ctx.world_size)])
        shards = _read_many(read, list(paths))
        unify_encoded_shards(shards)
        return Table.from_encoded(ctx, concat_encoded(shards))

    def read(p):
        return _read_one_arrow(p, options)

    if not many:
        return Table.from_pydict(ctx, read(paths))
    if len(paths) == ctx.world_size and len(paths) > 1:
        got = dict(zip(local, _read_many(read, [paths[s] for s in local])))
        return Table.from_shards(ctx, [got.get(s) for s in range(ctx.world_size)])
    shards = _read_many(read, list(paths))
    return Table.from_pydict(ctx, {n: np.concatenate([s[n] for s in shards]) for n in shards[0]})


# one native write at a time: a write resets its context's arena pool and
# carves its staging copies from it
_write_lock = threading.Lock()


def _stage(pool: native.MemoryPool, data: np.ndarray, want) -> np.ndarray:
    """Contiguous typed staging copy for the native writer, carved from the
    context's arena pool (``CylonContext.memory_pool``, native/runtime.cpp;
    the reference's memory pool) so repeated writes reuse the same blocks
    instead of malloc churn."""
    want = np.dtype(want)
    if data.dtype == want and data.flags["C_CONTIGUOUS"]:
        return data
    out = pool.alloc_array(data.shape, want)
    np.copyto(out, data, casting="unsafe")
    return out


def write_csv(
    table: Table,
    path: Union[str, Sequence[str]],
    options: Optional[CSVWriteOptions] = None,
) -> None:
    """Reference WriteCSV (table.cpp:244-253), through the native buffered
    row writer (csv.cpp ``ct_csv_write``); temporal and uint64 columns take
    pandas.

    ``path`` may be a list of world_size paths: shard i's rows go to
    path[i], each shard fetched alone (no gather); a process writes the
    files of its own shards."""
    options = options or CSVWriteOptions()
    if isinstance(path, (list, tuple)):
        if len(path) != table.world_size:
            raise ValueError(f"need {table.world_size} paths, got {len(path)}")
        for i in table.ctx.local_shards:
            _write_csv_one(table, path[i], options, shard=i)
        return
    _write_csv_one(table, path, options, shard=None)


HostCols = Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]


def _write_csv_one(table: Table, path: str, options: CSVWriteOptions,
                   shard: Optional[int]) -> None:
    names = table.column_names
    if shard is None:  # one gather, in which every rank takes part
        host = table._host_physical(names)
        if 0 not in table.ctx.local_shards:
            return  # the rank of shard 0 writes the file
    else:
        host = {n: table._host_physical_shard(n, shard) for n in names}
    pool = table.ctx.memory_pool  # None under CYLON_TPU_TORCH_NO_NATIVE
    if pool is not None:
        with _write_lock:
            pool.reset()
            if _write_csv_native(table, host, path, options, pool):
                return
    _pandas_write(table, host, path, options)


def _pandas_write(table: Table, host: HostCols, path: str, options: CSVWriteOptions) -> None:
    import pandas as pd

    pd.DataFrame({n: table._ref[n].decode_host(*host[n]) for n in host}).to_csv(
        path, index=False, sep=options._delimiter,
        header=options._header_names(table.column_names),
    )


def _write_csv_native(table: Table, host: HostCols, path: str, options: CSVWriteOptions,
                      pool: native.MemoryPool) -> bool:
    """Write through the native codec; False (nothing written) where a
    column needs pandas' formatting: temporal, or uint64 (values at or
    above 2^63 do not fit the writer's int64 lane)."""
    cols = []
    for name, (data, valid) in host.items():
        col = table._ref[name]
        t = col.dtype.type
        if col.dtype.is_dictionary:
            cols.append((native.CT_STRING, _stage(pool, data, np.int32), valid, col.dictionary))
        elif t == Type.BOOL:
            cols.append((native.CT_BOOL, _stage(pool, data, np.uint8), valid, None))
        elif t in (Type.HALF_FLOAT, Type.FLOAT, Type.DOUBLE):
            cols.append((native.CT_FLOAT64, _stage(pool, data, np.float64), valid, None))
        elif Type.UINT8 <= t <= Type.INT64 and t != Type.UINT64:
            cols.append((native.CT_INT64, _stage(pool, data, np.int64), valid, None))
        else:
            return False
    native.write_csv(path, options._header_names(table.column_names), cols,
                     delimiter=options._delimiter)
    return True
