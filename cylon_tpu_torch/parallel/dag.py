"""Streaming op-DAG engine: push-based dataflow over table chunks
(counterpart of cylon_tpu/parallel/dag.py).

Reference analog: cpp/src/cylon/ops/: ``Op`` (ops/api/parallel_op.hpp:32-162:
per-edge input queues, child links, finalize propagation, leaf callback),
``RootOp`` (:164), the cooperative execution strategies
(ops/execution/execution.hpp:13-95: RoundRobin / Priority / Sequential /
Join), and the concrete ops (PartitionOp, AllToAllOp, MergeOp, JoinOp,
UnionOp) wired into whole graphs by ``DisJoinOP``/``DisUnionOp``
(ops/dis_join_op.cpp:26-71).

A chunk is a sharded :class:`~cylon_tpu_torch.table.Table`, not a buffer of
bytes. Each op's ``process`` queues its kernels on the card and returns
once the host has what the next step needs (a shuffle reads its counts),
so the scheduler issues chunk k+1's work while chunk k's runs.

Execution model: every op owns one FIFO queue per input edge. ``insert``
pushes a chunk; ``execute_one`` pops and processes one chunk (one
scheduling quantum); when every upstream edge has signalled FIN and the
queues are drained, ``on_finalize`` fires once and FIN propagates to the
children: the reference's finalize protocol (parallel_op.cpp).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from ..table import Table, _concat_tables

__all__ = [
    "Op", "RootOp", "MapOp", "ShuffleOp", "PartitionOp", "MergeOp", "JoinOp",
    "UnionOp", "SequentialExecution", "RoundRobinExecution",
    "PriorityExecution", "JoinExecution", "DisJoinOp", "DisUnionOp",
]


class Op:
    """Dataflow node (reference Op, ops/api/parallel_op.hpp:32-162)."""

    def __init__(self, op_id: str, num_inputs: int = 1):
        self.op_id = op_id
        self.children: List["Op"] = []
        self._child_edge: List[int] = []
        self.queues: List[deque] = [deque() for _ in range(num_inputs)]
        self._fin_in: List[bool] = [False] * num_inputs
        self._finalized = False

    # -- graph construction --------------------------------------------
    def add_child(self, child: "Op", edge: int = 0) -> "Op":
        self.children.append(child)
        self._child_edge.append(edge)
        return child

    # -- data path ------------------------------------------------------
    def insert(self, table: Table, edge: int = 0) -> None:
        if self._fin_in[edge]:
            raise RuntimeError(f"{self.op_id}: insert after FIN on edge {edge}")
        self.queues[edge].append(table)

    def _emit(self, table: Optional[Table]) -> None:
        if table is None:
            return
        for child, edge in zip(self.children, self._child_edge):
            child.insert(table, edge)

    def process(self, table: Table, edge: int) -> Optional[Table]:
        """Transform one chunk (override). None == nothing to forward."""
        return table

    def on_finalize(self) -> Optional[Table]:
        """Called once after all inputs FIN'd and queues drained (override)."""
        return None

    # -- scheduling quanta ----------------------------------------------
    def execute_one(self) -> bool:
        """Run one quantum: process one queued chunk, or finalize. Returns
        True if progress was made (reference Op::Execute + DidSomeWork)."""
        for edge, q in enumerate(self.queues):
            if q:
                self._emit(self.process(q.popleft(), edge))
                return True
        if all(self._fin_in) and not self._finalized:
            self._emit(self.on_finalize())
            self._finalized = True
            for child, edge in zip(self.children, self._child_edge):
                child.finish(edge)
            return True
        return False

    def finish(self, edge: int = 0) -> None:
        """Upstream FIN for one edge (reference sendFin protocol)."""
        self._fin_in[edge] = True

    def is_complete(self) -> bool:
        return self._finalized and not any(self.queues)

    # -- traversal -------------------------------------------------------
    def all_ops(self) -> List["Op"]:
        """This op + descendants in BFS order, deduplicated."""
        seen: Dict[int, Op] = {}
        frontier = deque([self])
        order = []
        while frontier:
            op = frontier.popleft()
            if id(op) in seen:
                continue
            seen[id(op)] = op
            order.append(op)
            frontier.extend(op.children)
        return order


class RootOp(Op):
    """Sink collecting result chunks (reference RootOp,
    parallel_op.hpp:164); ``result()`` concatenates them into one Table."""

    def __init__(self, op_id: str = "root", num_inputs: int = 1):
        super().__init__(op_id, num_inputs)
        self.outputs: List[Table] = []

    def process(self, table: Table, edge: int) -> None:
        self.outputs.append(table)
        return None

    def result(self) -> Table:
        if not self.outputs:
            raise RuntimeError("root has no output (graph not executed?)")
        return _concat_tables(self.outputs)


class MapOp(Op):
    """Apply an arbitrary Table -> Table function per chunk."""

    def __init__(self, op_id: str, fn: Callable[[Table], Table]):
        super().__init__(op_id, 1)
        self.fn = fn

    def process(self, table: Table, edge: int) -> Table:
        return self.fn(table)


class PartitionOp(MapOp):
    """Hash-partition marker stage (reference PartitionOp,
    ops/partition_op.cpp:44-76). The partition ids and the scatter live
    inside the shuffle (kernels B2a and B2b), so this is the identity unless
    a custom pre-partition fn is given; it stays a node of its own, so the
    graphs keep the reference's partition -> all_to_all -> ... shape."""

    def __init__(self, op_id: str = "partition", fn: Optional[Callable] = None):
        super().__init__(op_id, fn or (lambda t: t))


class ShuffleOp(Op):
    """All-to-all shuffle of each chunk on key columns (reference AllToAllOp,
    ops/all_to_all_op.cpp: wraps ArrowAllToAll; the world_size==1 bypass at
    :40-56 is mirrored here)."""

    def __init__(self, op_id: str, key_columns: Sequence):
        super().__init__(op_id, 1)
        self.key_columns = list(key_columns)

    def process(self, table: Table, edge: int) -> Table:
        if table.world_size == 1:
            return table
        return table.shuffle(self.key_columns)


class MergeOp(Op):
    """Accumulate chunks, concat once on finalize (reference MergeOp)."""

    def __init__(self, op_id: str = "merge"):
        super().__init__(op_id, 1)
        self._chunks: List[Table] = []

    def process(self, table: Table, edge: int) -> None:
        self._chunks.append(table)
        return None

    def on_finalize(self) -> Optional[Table]:
        if not self._chunks:
            return None
        return _concat_tables(self._chunks)


class JoinOp(Op):
    """Two-input local join at finalize time (reference JoinOp,
    ops/kernels/join_kernel.cpp): chunks arriving on each edge are already
    co-partitioned by the upstream shuffles, so the join itself is local."""

    def __init__(self, op_id: str = "join", **join_kwargs):
        super().__init__(op_id, 2)
        self._acc: List[List[Table]] = [[], []]
        self.join_kwargs = join_kwargs

    def process(self, table: Table, edge: int) -> None:
        self._acc[edge].append(table)
        return None

    def on_finalize(self) -> Optional[Table]:
        if not self._acc[0] or not self._acc[1]:
            # schema travels with chunks; a chunkless edge means we cannot
            # even build the empty output (see _StreamingGraph.execute guard)
            raise RuntimeError(
                f"{self.op_id}: an input edge received no chunks; feed at "
                "least one (possibly zero-row) chunk per stream"
            )
        left = _concat_tables(self._acc[0])
        right = _concat_tables(self._acc[1])
        return left.join(right, **self.join_kwargs)


class UnionOp(Op):
    """Two-input local union at finalize (reference UnionOp,
    ops/kernels/union kernels)."""

    def __init__(self, op_id: str = "union"):
        super().__init__(op_id, 2)
        self._acc: List[List[Table]] = [[], []]

    def process(self, table: Table, edge: int) -> None:
        self._acc[edge].append(table)
        return None

    def on_finalize(self) -> Optional[Table]:
        # Table.union == concat + unique (table.cpp:531-603 semantics), which
        # also covers the one-sided cases
        chunks = self._acc[0] + self._acc[1]
        return _concat_tables(chunks).unique() if chunks else None


# ---------------------------------------------------------------- schedulers

class Execution:
    """Cooperative scheduler over an op graph (reference Execution,
    ops/execution/execution.hpp:13-95). ``run()`` drives quanta until every
    op is complete, the analog of RootOp::WaitForCompletion's progress loop;
    a cycle in which no op progresses raises (a source never FIN'd)."""

    def __init__(self, *roots: Op):
        self.ops: List[Op] = []
        seen = set()
        for r in roots:
            for op in r.all_ops():
                if id(op) not in seen:
                    seen.add(id(op))
                    self.ops.append(op)

    def step(self) -> bool:
        raise NotImplementedError

    def is_complete(self) -> bool:
        return all(op.is_complete() for op in self.ops)

    def run(self) -> None:
        while not self.is_complete():
            if not self.step():
                # no op made progress but graph incomplete -> a source was
                # never FIN'd; surface instead of spinning forever
                pending = [op.op_id for op in self.ops if not op.is_complete()]
                raise RuntimeError(f"op graph stalled; pending: {pending}")


class SequentialExecution(Execution):
    """Drain each op fully in BFS order (reference SequentialExecution,
    execution.hpp:86)."""

    def step(self) -> bool:
        progressed = False
        for op in self.ops:
            while op.execute_one():
                progressed = True
        return progressed


class RoundRobinExecution(Execution):
    """One quantum per op per cycle (reference RoundRobinExecution,
    execution.hpp:28)."""

    def step(self) -> bool:
        progressed = False
        for op in self.ops:
            if op.execute_one():
                progressed = True
        return progressed


class PriorityExecution(Execution):
    """Weighted round-robin: an op with priority w gets w quanta per cycle
    (reference PriorityExecution, execution.hpp:69 — weighted chances)."""

    def __init__(self, *roots: Op, priorities: Optional[Dict[str, int]] = None):
        super().__init__(*roots)
        self.priorities = priorities or {}

    def step(self) -> bool:
        progressed = False
        for op in self.ops:
            for _ in range(max(1, self.priorities.get(op.op_id, 1))):
                if op.execute_one():
                    progressed = True
                else:
                    break
        return progressed


class JoinExecution(Execution):
    """Alternate the two input subtrees, then drive the join (reference
    JoinExecution, execution.hpp:39 — alternates primary/secondary then
    join)."""

    def __init__(self, left_root: Op, right_root: Op, join_op: Op, sink: Op):
        self.left = [op for op in left_root.all_ops() if op is not join_op and op is not sink]
        self.right = [op for op in right_root.all_ops() if op is not join_op and op is not sink]
        self.tail = [join_op, sink]
        self.ops = self.left + [o for o in self.right if o not in self.left] + self.tail

    def step(self) -> bool:
        progressed = False
        for a, b in zip(self.left, self.right):
            if a.execute_one():
                progressed = True
            if b.execute_one():
                progressed = True
        longer = self.left if len(self.left) > len(self.right) else self.right
        for op in longer[min(len(self.left), len(self.right)):]:
            if op.execute_one():
                progressed = True
        for op in self.tail:
            if op.execute_one():
                progressed = True
        return progressed


# ---------------------------------------------------------------- graphs

class _StreamingGraph:
    """Common runner: feed chunk streams into a built graph and execute."""

    def __init__(self, sources: Sequence[Op], root: RootOp, execution: Execution):
        self.sources = list(sources)
        self.root = root
        self.execution = execution

    def execute(self, *streams: Sequence[Table]) -> Table:
        if len(streams) != len(self.sources):
            raise ValueError(f"expected {len(self.sources)} chunk streams")
        for i, s in enumerate(streams):
            if not s:
                raise ValueError(
                    f"input stream {i} is empty; schema travels with chunks, "
                    "so pass at least one (possibly zero-row) Table chunk"
                )
        # interleave chunk insertion across sources so the scheduler can
        # overlap both sides' shuffles (reference DisJoinOP feeds L/R
        # alternately through JoinExecution)
        maxlen = max((len(s) for s in streams), default=0)
        for i in range(maxlen):
            for src, stream in zip(self.sources, streams):
                if i < len(stream):
                    src.insert(stream[i])
        for src in self.sources:
            src.finish()
        self.execution.run()
        return self.root.result()


class DisJoinOp(_StreamingGraph):
    """Distributed streaming join graph (reference DisJoinOP,
    ops/dis_join_op.cpp:26-71): L/R: partition -> shuffle -> merge feeding a
    shared join, driven by JoinExecution."""

    def __init__(self, on=None, how: str = "inner", left_on=None, right_on=None, **kwargs):
        kwargs.update({"on": on, "how": how, "left_on": left_on, "right_on": right_on})
        if on is None and (left_on is None or right_on is None):
            raise ValueError("DisJoinOp needs on= or left_on=/right_on=")
        lp = PartitionOp("partition_l")
        rp = PartitionOp("partition_r")

        def as_list(k):
            return list(k) if isinstance(k, (list, tuple)) else [k]

        lkey = as_list(on if on is not None else left_on)
        rkey = as_list(on if on is not None else right_on)
        ls = ShuffleOp("shuffle_l", lkey)
        rs = ShuffleOp("shuffle_r", rkey)
        join = JoinOp("join", **kwargs)
        root = RootOp()
        lp.add_child(ls)
        rp.add_child(rs)
        ls.add_child(join, edge=0)
        rs.add_child(join, edge=1)
        join.add_child(root)
        super().__init__([lp, rp], root, JoinExecution(lp, rp, join, root))


class DisUnionOp(_StreamingGraph):
    """Distributed streaming union graph (reference DisUnionOp): both sides
    shuffle on ALL columns, then local union."""

    def __init__(self, columns: Sequence[str]):
        lp = PartitionOp("partition_l")
        rp = PartitionOp("partition_r")
        ls = ShuffleOp("shuffle_l", list(columns))
        rs = ShuffleOp("shuffle_r", list(columns))
        union = UnionOp()
        root = RootOp()
        lp.add_child(ls)
        rp.add_child(rs)
        ls.add_child(union, edge=0)
        rs.add_child(union, edge=1)
        union.add_child(root)
        super().__init__(
            [lp, rp], root, RoundRobinExecution(lp, rp)
        )
