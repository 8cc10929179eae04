"""Lowering: optimized plan -> calls into the eager Table ops (counterpart of
cylon_tpu/plan/lower.py).

``build_executor`` compiles a plan into a closure ``fn(tables) -> Table``
(``tables`` = the Scan inputs in ordinal order). The closure is what the
plan cache (``engine.plan_executable``) stores: collecting a plan of the
same shape again skips optimize and lower.

Join-family nodes own their input Shuffles: a join unifies the key
dictionaries and promotes the key dtypes BEFORE hashing (as
``Table.distributed_join`` does), so a planner Shuffle under a Join is
peeled off the child and replayed inside the join recipe, both sides in one
shuffle call.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..obs import trace as _obstrace
from ..utils.tracing import span
from .expr import filter_mask
from .nodes import (
    Filter,
    FusedJoinGroupBySum,
    GroupBy,
    Join,
    Limit,
    Node,
    Project,
    Scan,
    Shuffle,
    Sort,
    Union,
)


def scan_tables(root: Node) -> list:
    """Assign Scan ordinals in DFS order (a shared scan keeps one ordinal)
    and return their bound tables in that order. Called before
    fingerprinting."""
    tables: list = []
    seen: Dict[int, int] = {}

    def walk(n: Node) -> None:
        if isinstance(n, Scan):
            if id(n) not in seen:
                seen[id(n)] = len(tables)
                tables.append(n.table)
            n.ordinal = seen[id(n)]
            return
        for c in n.children:
            walk(c)

    walk(root)
    return tables


def detach_scans(root: Node) -> Node:
    """Copy the plan with table-less Scan stubs (frozen ordinals, schema,
    order descriptor and range stats). The plan cache stores executors built over the
    detached plan: live Scans belong to the user's LazyFrame, and their
    tables would otherwise stay alive as long as the context."""
    memo: Dict[int, Node] = {}

    def walk(n: Node) -> Node:
        got = memo.get(id(n))
        if got is not None:
            return got
        if isinstance(n, Scan):
            stub = Scan.__new__(Scan)
            stub.table = None
            stub.ordinal = n.ordinal
            stub.schema = n.schema
            stub.table_ordering = n.ordering()  # frozen compile-time claim
            stub.table_stats = dict(n.col_stats())  # frozen likewise
            out: Node = stub
        elif n.children:
            out = n.with_children([walk(c) for c in n.children])
        else:
            out = n
        memo[id(n)] = out
        return out

    return walk(root)


def _peel_shuffle(child: Node, keys: Sequence[str]):
    """(grandchild, needs_shuffle) for a join-family input: a planner hash
    Shuffle on exactly the side's keys is replayed inside the join recipe
    (after the dictionary unification and key promotion)."""
    if isinstance(child, Shuffle) and child.kind == "hash" and set(child.keys) == set(keys):
        return child.children[0], True
    return child, False


# plan-side semi_filter annotation -> table._shuffle_pair sides
_SEMI_SIDES = {"both": "both", "left": "a", "right": "b"}


def _prepare_join_inputs(lt, rt, l_keys, r_keys, l_shuf: bool, r_shuf: bool, semi=None):
    """The join-input invariant in ONE place (Join and the fused node):
    unify dictionaries and promote key dtypes BEFORE hashing, then replay
    the peeled planner Shuffles; when both sides move, one engine call
    shuffles the pair (``table._shuffle_pair``), as the eager join does,
    with the semi-join filter of the node's ``semi`` annotation."""
    from ..table import _promote_key_pair, _shuffle_pair, _unify_dict_pair

    lt, rt = _unify_dict_pair(lt, rt, l_keys, r_keys)
    lt, rt = _promote_key_pair(lt, rt, l_keys, r_keys)
    if lt.world_size > 1:
        if l_shuf and r_shuf:
            lt, rt = _shuffle_pair(lt, l_keys, rt, r_keys, semi=_SEMI_SIDES.get(semi))
        elif l_shuf:
            lt = lt._shuffle_impl(l_keys)
        elif r_shuf:
            rt = rt._shuffle_impl(r_keys)
    return lt, rt


def plan_order(root: Node) -> Dict[int, int]:
    """Stable pre-order numbering of a plan's nodes: the ``node_id`` a
    per-node span carries, and the id ``explain(analyze=True)`` joins
    spans back to rendered tree lines with. A shared subplan (a DAG) keeps
    its first-visit id."""
    order: Dict[int, int] = {}

    def number(n: Node) -> None:
        if id(n) in order:
            return
        order[id(n)] = len(order)
        for c in n.children:
            number(c)

    number(root)
    return order


def build_executor(root: Node) -> Callable[[List], "object"]:
    """Compile the plan into ``fn(tables) -> Table``. A node shared by two
    parents runs once.

    Every node executes under a ``plan.node.<Type>`` span carrying its
    pre-order ``node_id``: with tracing off one disabled-path span call a
    node (a rollup bump); with a query trace active the spans nest into
    the query's tree and carry ``rows_out`` (the port's counts are
    host-known). Under ``obs.trace.analyze_mode()`` (set only by
    ``explain(analyze=True)``) each node waits for its card's work, so its
    span's time is its own: a diagnostic sync by design."""
    order = plan_order(root)

    def run(tables: List):
        memo: Dict[int, object] = {}

        def ex(node: Node):
            got = memo.get(id(node))
            if got is not None:
                return got
            with span("plan.node." + type(node).__name__, node_id=order[id(node)]) as sp:
                out = _lower_one(node, ex, tables)
                if _obstrace.analyze_active():
                    _wait_for_devices(out)
                if sp is not None:
                    sp.attrs["rows_out"] = int(out._counts.sum())
            memo[id(node)] = out
            return out

        return ex(root)

    return run


def _wait_for_devices(table) -> None:
    """The analyzed run's per-node wait: every card this process's shards
    of ``table`` live on."""
    for d in dict.fromkeys(table.ctx.devices):
        if d is not None and d.type == "cuda":
            torch.cuda.synchronize(d)


def _lower_one(node: Node, ex, tables):
    from ..table import _shuffle_many, _ShuffleSpec

    if isinstance(node, Scan):
        return tables[node.ordinal]
    if isinstance(node, Project):
        return ex(node.children[0]).project(list(node.cols))
    if isinstance(node, Filter):
        t = ex(node.children[0])
        return t.filter(t._per_shard(lambda s: filter_mask(node.expr, t._shards[s])))
    if isinstance(node, Sort):
        return ex(node.children[0]).sort(list(node.by), list(node.ascending))
    if isinstance(node, Shuffle):
        t = ex(node.children[0])
        if t.world_size == 1:
            return t
        if node.kind == "hash":
            return t._shuffle_impl(list(node.keys))
        return _shuffle_many([_ShuffleSpec(t, (node.keys[0],), kind="range", asc0=node.asc0)])[0]
    if isinstance(node, GroupBy):
        t = ex(node.children[0])
        spec: Dict[str, list] = {}
        for c, op in node.aggs:
            spec.setdefault(c, []).append(op)
        res = t.groupby(list(node.keys), spec)
        # several ops of one column group in dict order; restore plan order
        if res.column_names != node.names:
            res = res.project(node.names)
        return res
    if isinstance(node, Join):
        lchild, l_shuf = _peel_shuffle(node.children[0], node.l_on)
        rchild, r_shuf = _peel_shuffle(node.children[1], node.r_on)
        lt, rt = ex(lchild), ex(rchild)
        # rename both sides to the build-time output names first, so that
        # pruning can never change the suffixing (nodes.Join docstring)
        lt = lt.rename({n: node.l_rename[n] for n in lt.column_names})
        rt = rt.rename({n: node.r_rename[n] for n in rt.column_names})
        l_keys, r_keys = list(node.l_key_out), list(node.r_key_out)
        lt, rt = _prepare_join_inputs(lt, rt, l_keys, r_keys, l_shuf, r_shuf,
                                      semi=node.semi_filter)
        return lt.join(
            rt, left_on=l_keys, right_on=r_keys, how=node.how, suffixes=node.suffixes,
            # order_reuse: the key-order emit, whose descriptor lets the
            # groupby above run-detect
            emit_order="key" if node.emit_key_order else "left",
        )
    if isinstance(node, FusedJoinGroupBySum):
        lchild, l_shuf = _peel_shuffle(node.children[0], node.l_on)
        rchild, r_shuf = _peel_shuffle(node.children[1], node.r_on)
        l_on, r_on = list(node.l_on), list(node.r_on)
        lt, rt = _prepare_join_inputs(ex(lchild), ex(rchild), l_on, r_on, l_shuf, r_shuf,
                                      semi=node.semi_filter)
        # the kernel emits the keys in join-pair order; name them so that
        # projecting to node.names restores the groupby key order
        pair_names = [None] * len(l_on)
        for name, ki in zip(node.out_keys, node.key_order):
            pair_names[ki] = name
        res = lt._join_sum_pushdown(rt, l_on, r_on, node.val_col, pair_names, node.out_val)
        if res.column_names != node.names:
            res = res.project(node.names)
        return res
    if isinstance(node, Union):
        return ex(node.children[0]).union(ex(node.children[1]))
    if isinstance(node, Limit):
        t = ex(node.children[0])
        return t.take(np.arange(min(node.n, t.row_count), dtype=np.int64))
    raise TypeError(f"no lowering for plan node {type(node).__name__}")
