"""Fingerprint-batched execution: B parameter bindings, one execution
(counterpart of cylon_tpu/serve/batch.py).

Same-shape plans over different tables share one cached executor, but a
serial loop still pays the whole lowered op chain's host work once a
query. This module runs B bindings of one shape as ONE execution, by
key augmentation at the plan level, so the whole optimizer (the fused q3
pushdown, shuffle elimination, semi filters) applies to the batch as to
one query:

1. :func:`stack_tables`: the B bindings of each Scan ordinal concatenated
   shard by shard into one table, with a binding-id column
   (``__cylon_qid``) a row;
2. :func:`build_batched_template`: the logical plan rewritten so the qid
   rides every data-dependent boundary (leading the join keys of both
   sides, the groupby keys and the sort keys), which makes the batch B
   disjoint queries inside one execution;
3. :func:`split_batch`: every binding's rows of the result, projected back
   to the original schema: one stable K1 sort of each shard by its qid
   lane, one gather a column, and one host read of the per-binding row
   counts.

The JAX package pads a batch to a power-of-two number of bindings so its
compiled programs repeat (``stack_tables(..., pad_to)``); the port's
tables are exact-length and its executors are not compiled per shape, so
it stacks exactly the bindings it has. The power-of-two bucket names the
batched executor's cache entry (``engine.serve_batch_executable``) and
caps a group's size, nothing more (ROADMAP.md C3).

Batchability is a whitelist (Scan / Filter / Project / Join except full
outer / GroupBy / Sort / Union); anything else, and any schema already
using the reserved qid name, runs as per-query executions in the
scheduler. A full-outer join is out because neither side's qid survives
on every row; a Limit because "the first n rows" is a per-query global.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..column import Column
from ..dtypes import DataType, Type
from ..fault.errors import CylonError
from ..ops import radix as _radix
from ..plan.nodes import Filter, GroupBy, Join, Node, Project, Scan, Sort, Union
from ..utils.tracing import span

#: the reserved binding-id column name (schemas using it are unbatchable)
QID = "__cylon_qid"


class Unbatchable(CylonError):
    """This plan shape cannot ride the stacked batch execution: it runs
    a binding at a time instead (scope "query": nothing is poisoned).
    Internal control flow (``is_batchable`` catches it), never surfaced to
    a future."""


# ----------------------------------------------------------------------
# plan rewrite: thread the binding id through every relational boundary
# ----------------------------------------------------------------------
def _qid_scan_stub(scan: Scan) -> Scan:
    """A detached Scan stub over the STACKED table: the original schema
    plus the qid column, the frozen ordinal, no order, stats or stream
    generation claims (the stacked table makes none)."""
    stub = Scan.__new__(Scan)
    stub.table = None
    stub.ordinal = scan.ordinal
    stub.table_ordering = None
    stub.table_stats = {}
    stub.table_stream_gen = None
    stub.schema = tuple(scan.schema) + ((QID, int(Type.INT32), "int32"),)
    return stub


def _rewrite(node: Node, memo: Dict[int, Tuple[Node, str]]) -> Tuple[Node, str]:
    """The batched twin of ``node`` and the OUTPUT NAME its binding-id
    column rides under (a join may suffix it)."""
    got = memo.get(id(node))
    if got is not None:
        return got
    if isinstance(node, Scan):
        out: Tuple[Node, str] = (_qid_scan_stub(node), QID)
    elif isinstance(node, Filter):
        child, q = _rewrite(node.children[0], memo)
        out = (Filter(child, node.expr), q)
    elif isinstance(node, Project):
        child, q = _rewrite(node.children[0], memo)
        cols = list(node.cols)
        if q not in cols:
            cols.append(q)
        out = (Project(child, cols), q)
    elif isinstance(node, Sort):
        child, q = _rewrite(node.children[0], memo)
        # qid leads: a range shuffle partitions bindings apart, and each
        # binding's rows keep the serial sort's key order
        out = (Sort(child, (q,) + tuple(node.by), (True,) + tuple(node.ascending)), q)
    elif isinstance(node, GroupBy):
        child, q = _rewrite(node.children[0], memo)
        out = (GroupBy(child, (q,) + tuple(node.keys), node.aggs), q)
    elif isinstance(node, Join):
        if node.how == "outer":
            raise Unbatchable("full-outer join")  # no side's qid is on every row
        left, ql = _rewrite(node.children[0], memo)
        right, qr = _rewrite(node.children[1], memo)
        j = Join(left, right, (ql,) + tuple(node.l_on), (qr,) + tuple(node.r_on), node.how,
                 node.suffixes)
        # the surviving (never-null) side's qid names the binding: the
        # left for inner and left joins, the right for right joins
        q = j.l_rename[ql] if node.how in ("inner", "left") else j.r_rename[qr]
        out = (j, q)
    elif isinstance(node, Union):
        left, ql = _rewrite(node.children[0], memo)
        right, qr = _rewrite(node.children[1], memo)
        if ql != qr or left.names != right.names:
            raise Unbatchable("union with mismatched batched schemas")
        # rows of different bindings differ in qid: no cross-binding dedup
        out = (Union(left, right), ql)
    else:
        raise Unbatchable(type(node).__name__)
    memo[id(node)] = out
    return out


class BatchTemplate:
    """The batched twin of one logical plan: a detached plan whose Scans
    expect stacked tables (the original columns + qid), and the names the
    split needs."""

    __slots__ = ("root", "qid_out", "out_names", "n_scans")

    def __init__(self, root: Node, qid_out: str, out_names: List[str], n_scans: int):
        self.root = root
        self.qid_out = qid_out
        self.out_names = out_names
        self.n_scans = n_scans


def build_batched_template(plan: Node, n_scans: int) -> BatchTemplate:
    """Rewrite ``plan`` (ordinals assigned by ``scan_tables``) into its
    batched twin. Raises :class:`Unbatchable` for an unsupported shape or
    a schema that uses the reserved qid name."""

    def check(n: Node) -> None:
        if isinstance(n, Scan):
            if any(e[0].startswith(QID) for e in n.schema):
                raise Unbatchable(f"schema uses reserved column {QID}")
            return
        for c in n.children:
            check(c)

    check(plan)
    root, qid_out = _rewrite(plan, {})
    if qid_out not in root.names:  # pragma: no cover - defensive
        raise Unbatchable("binding id pruned from the batched output")
    return BatchTemplate(root, qid_out, list(plan.names), n_scans)


def is_batchable(plan: Node) -> bool:
    try:
        build_batched_template(plan, 0)
        return True
    except Unbatchable:
        return False


# ----------------------------------------------------------------------
# table stacking: B bindings -> one table + the qid column
# ----------------------------------------------------------------------
def _union_dictionaries(tables: list, name: str):
    """(union dictionary, per-binding code remap or None) of one
    dictionary-encoded column across the bindings: a host merge of the
    sorted, unique dictionaries; identical dictionaries remap nothing."""
    dicts = [t._ref[name].dictionary for t in tables]
    if all(d is dicts[0] or np.array_equal(d, dicts[0]) for d in dicts[1:]):
        return dicts[0], [None] * len(tables)
    union = dicts[0]
    for d in dicts[1:]:
        union = np.union1d(union, d)
    return union, [np.searchsorted(union, d).astype(np.int32) for d in dicts]


def stack_tables(ctx, tables: list):
    """Concatenate B same-schema bindings into ONE table: shard s holds
    every binding's shard-s rows in binding order, plus an int32
    ``__cylon_qid`` column holding each row's binding index. A
    dictionary-encoded column takes the union of the bindings'
    dictionaries, each binding's codes remapped on its device.
    Exact-length: no padding slot."""
    from ..table import Table

    t0 = tables[0]
    names = t0.column_names
    with span("serve.stack", rows=len(tables)):
        dicts: Dict[str, tuple] = {}
        for n in names:
            if t0._ref[n].dictionary is not None:
                dicts[n] = _union_dictionaries(tables, n)
        qtype = DataType.from_numpy_dtype(np.dtype(np.int32))
        shards: List[Optional["OrderedDict[str, Column]"]] = [None] * ctx.world_size
        for s in ctx.local_shards:
            cols: "OrderedDict[str, Column]" = OrderedDict()
            for n in names:
                parts = [t._shards[s][n] for t in tables]
                datas = [c.data for c in parts]
                if n in dicts:
                    datas = [d if rm is None else
                             torch.as_tensor(rm, device=d.device)[d.long()].to(d.dtype)
                             for d, rm in zip(datas, dicts[n][1])]
                valid = None
                if any(c.valid is not None for c in parts):
                    valid = torch.cat([
                        c.valid if c.valid is not None
                        else torch.ones(c.data.shape[0], dtype=torch.bool, device=c.data.device)
                        for c in parts])
                cols[n] = Column(torch.cat(datas), parts[0].dtype, valid,
                                 dicts[n][0] if n in dicts else parts[0].dictionary)
            dev = ctx.devices[s]
            cols[QID] = Column(torch.cat([
                torch.full((int(t._counts[s]),), i, dtype=torch.int32, device=dev)
                for i, t in enumerate(tables)]), qtype)
            shards[s] = cols
        return Table(ctx, shards, np.sum([t._counts for t in tables], axis=0))


# ----------------------------------------------------------------------
# result split: every binding's rows, one host read
# ----------------------------------------------------------------------
def split_batch(result, template: BatchTemplate, b: int) -> list:
    """Every binding's slice of the batched result: per shard one stable
    K1 sort by the qid lane, one gather a column into binding order, then
    exact-length views of each binding's rows. A binding's rows keep their
    order in the result (the sort is stable), so a sort tail's slice
    comes out in its requested order. The per-binding row counts of every
    shard cross to the host in one read."""
    from ..table import Table
    from ..utils.tracing import bump

    ctx = result.ctx
    names = template.out_names
    with span("serve.split", rows=b):
        perms, counts = {}, np.zeros((ctx.world_size, b), np.int64)
        hist = []
        for s in ctx.local_shards:
            q = result._shards[s][template.qid_out].data
            hist.append(torch.bincount(q.long(), minlength=b)[:b])
            perms[s] = (_radix.argsort_perm(q, _radix.bound_hint(max(b - 1, 0)))
                        if q.shape[0] else torch.zeros(0, dtype=torch.int32, device=q.device))
        bump("host_sync")
        local = torch.stack([h.cpu() for h in hist]).numpy() if hist else np.zeros((0, b))
        counts[list(ctx.local_shards)] = local
        counts = ctx.comm.all_gather_counts(local) if getattr(ctx.comm, "n_procs", 1) > 1 \
            else counts
        slices: List[list] = [[None] * ctx.world_size for _ in range(b)]
        for s in ctx.local_shards:
            perm = perms[s].long()
            sizes = [int(x) for x in counts[s]]
            parts: Dict[str, tuple] = {}
            for n in names:
                c = result._shards[s][n]
                data = c.data.index_select(0, perm).split(sizes)
                valid = (None,) * b if c.valid is None else c.valid.index_select(0, perm).split(sizes)
                parts[n] = (c, data, valid)
            for i in range(b):
                slices[i][s] = OrderedDict(
                    (n, Column(data[i], c.dtype, valid[i], c.dictionary))
                    for n, (c, data, valid) in parts.items())
        return [Table(ctx, slices[i], counts[:, i]) for i in range(b)]


def split_bytes_estimate(result, template: BatchTemplate) -> int:
    """Device bytes of the batched result's output columns (this
    process's shards), the split's transient copy: the scheduler charges
    it to every query of the batch's admission lease."""
    total = 0
    for s in result.ctx.local_shards:
        for n in template.out_names:
            c = result._shards[s][n]
            total += c.data.numel() * c.data.element_size()
            if c.valid is not None:
                total += c.valid.numel() * c.valid.element_size()
    return int(total)
