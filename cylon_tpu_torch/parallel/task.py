"""Task-based all-to-all: more logical partitions than physical workers
(counterpart of cylon_tpu/parallel/task.py).

Reference analog: the experimental ``LogicalTaskPlan`` + ``ArrowTaskAllToAll``
(cpp/src/cylon/arrow/arrow_task_all_to_all.h:23-40): rows are hashed into T
logical TASKS, each task is owned by one WORKER, and the shuffle routes by
the task -> worker map, so that task-parallel engines can over-decompose
(T >> P) for load balancing.

The task id is an int32 column of murmur3 partition ids mod T; the routing
is one gather through the task -> worker map, whose worker ids go to kernel
B2a in pid mode inside the same chunked shuffle every repartition uses
(``Table._shuffle_impl(kind="task")``). The per-task tables come from one
stable K1 sort of each shard by its task lane, one host read of the
``[P, T]`` task counts and one exact-length slice per task and shard.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..column import Column
from ..dtypes import DataType, Type
from ..ops import radix as _radix
from ..ops.gather import pack_gather
from ..ops.partition import hash_partition_ids
from ..utils.tracing import bump

#: the rider column of each row's task id; no output table carries it
TASK_COLUMN = "__task__"


class LogicalTaskPlan:
    """Task -> worker ownership map (reference arrow_task_all_to_all.h:23-40:
    the task_source_of_operation / worker_for_task tables).

    ``assignments`` is an explicit {task_id: worker} dict over the dense
    task ids 0..T-1, or an int task count (the tasks then spread
    round-robin over ``world`` workers)."""

    def __init__(self, assignments: Union[int, Dict[int, int]], world: int):
        if isinstance(assignments, int):
            if assignments <= 0:
                raise ValueError("need at least one task")
            self.n_tasks = assignments
            self.worker_for_task = np.arange(self.n_tasks, dtype=np.int32) % world
        else:
            if len(assignments) == 0:
                raise ValueError("need at least one task")
            if sorted(assignments.keys()) != list(range(len(assignments))):
                raise ValueError("task ids must be dense 0..T-1")
            self.n_tasks = len(assignments)
            self.worker_for_task = np.asarray(
                [assignments[t] for t in range(self.n_tasks)], np.int32
            )
        if self.worker_for_task.min() < 0 or self.worker_for_task.max() >= world:
            raise ValueError(f"worker ids must be in [0, {world})")
        self.world = world

    def worker_of(self, task: int) -> int:
        return int(self.worker_for_task[task])

    def tasks_of(self, worker: int) -> np.ndarray:
        return np.nonzero(self.worker_for_task == worker)[0]

    def __repr__(self):
        return f"LogicalTaskPlan(tasks={self.n_tasks}, world={self.world})"


def task_partition(table, hash_columns: Sequence[Union[str, int]],
                   plan: LogicalTaskPlan) -> Dict[int, object]:
    """Hash rows into ``plan.n_tasks`` logical tasks, send each task to its
    owning worker and return {task_id: Table}: the per-task tables the
    reference's ArrowTaskAllToAll delivers through its receive callback.
    Every task's rows live on its owner's shard only (``row_counts`` shows
    it), in the order of the shuffle's output."""
    if plan.world != table.world_size:
        raise ValueError(f"plan built for world={plan.world}, table has {table.world_size}")
    T = plan.n_tasks
    ctx = table.ctx
    khash = table._key_hash_cols(table._resolve_cols(hash_columns))
    tasks = table._per_shard(lambda s: Column(hash_partition_ids(khash[s], None, T),
                                              DataType(Type.INT32)))
    shuffled = table.add_column(TASK_COLUMN, tasks)._shuffle_impl(
        [TASK_COLUMN], kind="task", task_map=plan.worker_for_task)

    # each shard's rows in task order (one stable K1 lane sort), the [P, T]
    # task counts in one host read, then one slice per task and shard
    keep = [n for n in shuffled.column_names if n != TASK_COLUMN]
    ordered, counts = {}, []
    for s in ctx.local_shards:
        lane = shuffled._shards[s][TASK_COLUMN].data
        perm = _radix.argsort_perm(lane, _radix.bound_hint(T - 1))
        ordered[s] = pack_gather(shuffled._flat_cols(s, keep), perm, all_valid=True)
        counts.append(torch.bincount(lane.to(torch.int64), minlength=T))
    bump("host_sync")
    cnts = ctx.comm.all_gather_counts(torch.stack(counts).cpu().numpy())  # [P, T]
    offs = np.concatenate([np.zeros((table.world_size, 1), np.int64), np.cumsum(cnts, axis=1)], 1)
    ref = shuffled._ref

    def task_shard(t, s):
        lo, hi = int(offs[s, t]), int(offs[s, t + 1])
        return OrderedDict(
            (n, Column(d[lo:hi], ref[n].dtype, None if v is None else v[lo:hi], ref[n].dictionary))
            for n, (d, v) in zip(keep, ordered[s]))

    return {t: shuffled._with_shards(shuffled._per_shard(lambda s, t=t: task_shard(t, s)),
                                     cnts[:, t])
            for t in range(T)}
