"""Parquet ingest and egress (counterpart of cylon_tpu/io/parquet.py;
reference io/arrow_io.cpp:63-116), through pyarrow, which is imported
inside the functions only.

Typed end to end: reads go through the Arrow type bridge
(``Table.from_arrow`` / ``table._encode_arrow_array``: dictionary codes,
integer nulls and validity bitmaps survive, no pandas float64 bounce), and
a list of world_size paths reads and writes one file a shard, no global
gather. Under ``torch.distributed`` a rank reads and writes only its own
shards' files (``io/csv.py`` says how the others' schemas are gathered),
and one file of the whole table is written by the rank of shard 0.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Union

from ..context import CylonContext
from ..table import Table, _encode_arrow_array, unify_encoded_shards
from .csv import _read_many, concat_encoded


class ParquetOptions:
    """Parquet options set by chained calls (reference io/parquet_config.hpp:24-48:
    ChunkSize, ConcurrentFileReads, WriterProperties). The writer
    properties pass through to ``pyarrow.parquet.write_table``
    (compression, use_dictionary, ...); ChunkSize is its
    ``row_group_size``."""

    def __init__(self):
        self._chunk_size: Optional[int] = None
        self._concurrent_file_reads = True
        self._writer_properties: Dict[str, Any] = {}

    def chunk_size(self, n: int) -> "ParquetOptions":
        """Rows per written row group (reference ParquetOptions::ChunkSize)."""
        self._chunk_size = int(n)
        return self

    def concurrent_file_reads(self, flag: bool) -> "ParquetOptions":
        """Thread-pool multi-file reads (reference ConcurrentFileReads)."""
        self._concurrent_file_reads = bool(flag)
        return self

    def writer_properties(self, **kwargs) -> "ParquetOptions":
        """pq.write_table keyword passthrough: compression='zstd',
        use_dictionary=False, ... (reference WriterProperties)."""
        self._writer_properties.update(kwargs)
        return self


def read_parquet(
    ctx: CylonContext,
    paths: Union[str, Sequence[str]],
    options: Optional[ParquetOptions] = None,
) -> Table:
    """Read parquet file(s); a list of world_size paths maps file i to
    shard i (per-rank ingest), a list of another length is concatenated and
    split evenly."""
    import pyarrow.parquet as pq

    options = options or ParquetOptions()
    if not isinstance(paths, (list, tuple)):
        return Table.from_arrow(ctx, pq.read_table(paths))

    def read(p):
        at = pq.read_table(p)
        return OrderedDict((n, _encode_arrow_array(at.column(n))) for n in at.column_names)

    def read_all(ps):
        return _read_many(read, ps) if options._concurrent_file_reads else [read(p) for p in ps]

    if len(paths) == ctx.world_size:
        local = ctx.local_shards
        got = dict(zip(local, read_all([paths[s] for s in local])))
        return Table._from_local_encoded(ctx, [got.get(s) for s in range(ctx.world_size)])
    shards = read_all(list(paths))
    unify_encoded_shards(shards)
    return Table.from_encoded(ctx, concat_encoded(shards))


def write_parquet(
    table: Table,
    path: Union[str, Sequence[str]],
    options: Optional[ParquetOptions] = None,
) -> None:
    """Write parquet. A list of world_size paths writes shard i to path[i],
    fetching each shard's buffers alone (no global gather)."""
    import pyarrow.parquet as pq

    options = options or ParquetOptions()
    kw = dict(options._writer_properties)
    if options._chunk_size is not None:
        kw["row_group_size"] = options._chunk_size
    if isinstance(path, (list, tuple)):
        if len(path) != table.world_size:
            raise ValueError(f"need {table.world_size} paths, got {len(path)}")
        for i in table.ctx.local_shards:
            pq.write_table(table.to_arrow(shard=i), path[i], **kw)
        return
    whole = table.to_arrow()  # one gather, in which every rank takes part
    if 0 in table.ctx.local_shards:
        pq.write_table(whole, path, **kw)
