"""LazyFrame: the lazy query surface (counterpart of cylon_tpu/plan/lazy.py).

``Table.lazy()`` / ``DataFrame.lazy()`` return a :class:`LazyFrame`; each
method appends a logical node and nothing runs until ``.collect()``, which
optimizes (rules.py), lowers (lower.py) and runs the plan. The optimize +
lower product is cached per context under the plan's gated fingerprint
(``engine.plan_executable``), so collecting a plan of the same shape again
goes straight to execution. ``.explain()`` shows the plan before and after
the rewrites and which rules fired.

Not ported: ``explain(analyze=True)``, ``collect_async`` and ``dispatch`` (ROADMAP.md A9,
with the plan feedback component of the fingerprint). :func:`gate_report`
reads the counters of the engine's adaptive decisions (``GATE_PREFIXES``),
which the JAX package prints per node under ``explain(analyze=True)``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union as TUnion

from .. import ordering as _ord
from ..engine import PlanEntry, plan_executable
from ..ops import sketch as _sketch
from ..ops import quant as _quant
from ..ops import stats as _stats
from ..parallel import spill as _spill
from ..parallel import topo as _topo
from ..table import _not_ported
from ..utils.tracing import bump, report
from . import lower as _lower
from . import rules as _rules
from .expr import Col, Expr
from .nodes import Filter, GroupBy, Join, Limit, Node, Project, Scan, Sort, Union


def _as_list(x) -> List[str]:
    if isinstance(x, str):
        return [x]
    return list(x)


#: counter families of the engine's adaptive decisions, attributable to the
#: plan node whose execution made them
GATE_PREFIXES = ("ordering.", "shuffle.semi_filter.", "lane_pack.", "plan.cache.",
                 # the spill planner's decisions: skew-split relays, spilled
                 # shuffles and their staged rounds
                 "shuffle.skew_split", "shuffle.spill.shuffles", "shuffle.spill.staged_rounds")


def gate_report() -> Dict[str, Dict[str, float]]:
    """The rollup counters under :data:`GATE_PREFIXES`."""
    out: Dict[str, Dict[str, float]] = {}
    for prefix in GATE_PREFIXES:
        out.update(report(prefix))
    return out


def gated_fingerprint(plan: Node) -> tuple:
    """The executable identity of a plan: its structural fingerprint and
    the ordering, semi-filter, lane-packing, quantized-wire, spill (the
    forced spill tier and the skew split, ``spill.gate_state``) and
    topology gates (the kill switch and the raw mesh request,
    ``topo.gate_state``), which decide which rewrites fire and which paths
    the lowered ops take, so a gate flip re-optimizes instead of reusing
    an executor built under the other state. The JAX package adds a
    feedback component (A9)."""
    return (plan.fingerprint(), _ord.enabled(), _sketch.enabled(), _stats.enabled(),
            _quant.gate_state(), _spill.gate_state(), _topo.gate_state())


def _normalize_aggs(agg: Dict[str, TUnion[str, Sequence[str]]]) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    for c, ops in agg.items():
        ops_list = ops if isinstance(ops, (list, tuple)) else [ops]
        for o in ops_list:
            if not isinstance(o, str):
                raise TypeError(f"agg op must be a string name, got {o!r}")
            out.append((c, o))
    return out


class LazyFrame:
    """A deferred query plan over :class:`~cylon_tpu_torch.table.Table` inputs."""

    def __init__(self, plan: Node, ctx):
        self._plan = plan
        self._ctx = ctx

    # -- construction ------------------------------------------------------
    @classmethod
    def from_table(cls, table) -> "LazyFrame":
        return cls(Scan(table), table.ctx)

    def _wrap(self, node: Node) -> "LazyFrame":
        return LazyFrame(node, self._ctx)

    # -- introspection -----------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return self._plan.names

    @property
    def plan(self) -> Node:
        return self._plan

    def __repr__(self):
        return f"LazyFrame[{', '.join(self.columns)}]\n{self._plan.render()}"

    # -- plan builders -----------------------------------------------------
    def filter(self, predicate: Expr) -> "LazyFrame":
        """Keep rows where the :mod:`~cylon_tpu_torch.plan.expr` predicate
        is true (a null predicate row drops)."""
        if not isinstance(predicate, Expr):
            raise TypeError(
                "LazyFrame.filter takes a plan expression, e.g. "
                "filter(col('a') > 3) — opaque callables would be invisible "
                "to the optimizer"
            )
        return self._wrap(Filter(self._plan, predicate))

    def select(self, columns: TUnion[str, Sequence[str]], *more: str) -> "LazyFrame":
        items = ([columns] if isinstance(columns, (str, Col)) else list(columns)) + list(more)
        cols = [c.name if isinstance(c, Col) else c for c in items]
        return self._wrap(Project(self._plan, cols))

    def join(
        self,
        other: "LazyFrame",
        on: Optional[TUnion[str, Sequence[str]]] = None,
        how: str = "inner",
        left_on: Optional[TUnion[str, Sequence[str]]] = None,
        right_on: Optional[TUnion[str, Sequence[str]]] = None,
        suffixes: Tuple[str, str] = ("_x", "_y"),
    ) -> "LazyFrame":
        if not isinstance(other, LazyFrame):
            raise TypeError("join expects another LazyFrame (use .lazy())")
        if other._ctx is not self._ctx:
            raise ValueError("cannot join LazyFrames from different contexts")
        if on is not None:
            if left_on is not None or right_on is not None:
                raise ValueError("pass either on= or left_on/right_on, not both")
            l_on = r_on = _as_list(on)
        else:
            if left_on is None or right_on is None:
                raise ValueError("join needs on= or both left_on/right_on")
            l_on, r_on = _as_list(left_on), _as_list(right_on)
            if len(l_on) != len(r_on):
                raise ValueError("left_on/right_on length mismatch")
        return self._wrap(Join(self._plan, other._plan, l_on, r_on, how, suffixes))

    def groupby(
        self,
        by: TUnion[str, Sequence[str]],
        agg: Optional[Dict[str, TUnion[str, Sequence[str]]]] = None,
    ):
        """With ``agg``: a GroupBy node (output columns named ``col_op``,
        as ``Table.groupby``). Without: a :class:`LazyGroupBy` builder."""
        keys = _as_list(by)
        if agg is None:
            return LazyGroupBy(self, keys)
        return self._wrap(GroupBy(self._plan, keys, _normalize_aggs(agg)))

    def sort(
        self,
        by: TUnion[str, Sequence[str]],
        ascending: TUnion[bool, Sequence[bool]] = True,
    ) -> "LazyFrame":
        keys = _as_list(by)
        asc = [ascending] * len(keys) if isinstance(ascending, bool) else list(ascending)
        if len(asc) != len(keys):
            raise ValueError("ascending length must match sort keys")
        return self._wrap(Sort(self._plan, keys, asc))

    def union(self, other: "LazyFrame") -> "LazyFrame":
        if other._ctx is not self._ctx:
            raise ValueError("cannot union LazyFrames from different contexts")
        return self._wrap(Union(self._plan, other._plan))

    def limit(self, n: int) -> "LazyFrame":
        return self._wrap(Limit(self._plan, n))

    def head(self, n: int = 5) -> "LazyFrame":
        return self.limit(n)

    # -- execution ---------------------------------------------------------
    def explain(self, analyze: bool = False) -> str:
        """The plan before and after the rewrites, each line with its
        derived order (``-- order: [k asc] @shard``), and the rules that
        fired. ``analyze=True`` (run and annotate per node) is not ported."""
        if analyze:
            raise _not_ported("explain(analyze=True)", "A9")
        opt, fired = _rules.optimize(self._plan, self._ctx.world_size)
        return "\n".join([
            "== Logical plan ==", self._plan.render(), "",
            "== Optimized plan ==", opt.render(), "",
            _fired_line(fired),
        ])

    def _executable(self):
        """(scan tables, the PlanEntry) through the plan cache."""
        ctx = self._ctx
        tables = _lower.scan_tables(self._plan)

        def compile_plan():
            opt, fired = _rules.optimize(self._plan, ctx.world_size)
            # the cached executor holds frozen scan stubs, no tables
            opt = _lower.detach_scans(opt)
            return PlanEntry(opt, tuple(fired), _lower.build_executor(opt))

        entry, _hit = plan_executable(ctx, gated_fingerprint(self._plan), compile_plan)
        return tables, entry

    def collect(self):
        """Optimize, lower (both cached) and run the plan: an eager Table."""
        tables, entry = self._executable()
        for f in entry.fired:
            bump(f"plan.rule.{f}")
        return entry.fn(tables)

    def collect_async(self, block: bool = True):
        raise _not_ported("LazyFrame.collect_async (the serving scheduler)", "A9")

    def dispatch(self):
        raise _not_ported("LazyFrame.dispatch (the serving scheduler's deferred count)", "A9")


def _fired_line(fired) -> str:
    if not fired:
        return "Rewrites fired: (none)"
    counts: Dict[str, int] = {}
    for f in fired:
        counts[f] = counts.get(f, 0) + 1
    return "Rewrites fired: " + ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))


class LazyGroupBy:
    """``lf.groupby('k')`` builder: ``.agg({...})`` or a shortcut reducer."""

    def __init__(self, frame: LazyFrame, keys: List[str]):
        self._frame = frame
        self._keys = keys

    def agg(self, spec: Dict[str, TUnion[str, Sequence[str]]]) -> LazyFrame:
        return self._frame.groupby(self._keys, spec)

    def _all_values(self, op: str) -> LazyFrame:
        vals = [c for c in self._frame.columns if c not in self._keys]
        return self.agg({c: op for c in vals})

    def sum(self) -> LazyFrame:
        return self._all_values("sum")

    def min(self) -> LazyFrame:
        return self._all_values("min")

    def max(self) -> LazyFrame:
        return self._all_values("max")

    def mean(self) -> LazyFrame:
        return self._all_values("mean")

    def count(self) -> LazyFrame:
        return self._all_values("count")
