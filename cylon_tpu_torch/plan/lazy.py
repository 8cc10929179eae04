"""LazyFrame: the lazy query surface (counterpart of cylon_tpu/plan/lazy.py).

``Table.lazy()`` / ``DataFrame.lazy()`` return a :class:`LazyFrame`; each
method appends a logical node and nothing runs until ``.collect()``, which
optimizes (rules.py), lowers (lower.py) and runs the plan. The optimize +
lower product is cached per context under the plan's gated fingerprint
(``engine.plan_executable``), so collecting a plan of the same shape again
goes straight to execution. ``.explain()`` shows the plan before and after
the rewrites and which rules fired; ``.explain(analyze=True)`` runs it under
a forced query trace and prints each node's measured time, rows in and out,
collective bytes, critical-path share and the adaptive gates it took.

Telemetry: each ``collect()`` opens a query trace when tracing is on
(``CYLON_TPU_TORCH_TRACE``) and always observes its latency into the
plan-fingerprint histogram (``obs.metrics``). Under
``CYLON_TPU_TORCH_OBS_DIR`` the feedback re-coster (``plan/feedback.py``)
tunes the adaptive gates from the journaled evidence: its decisions ride
the fingerprint and apply around execution.

``collect_async`` submits the plan to the context's serving scheduler
(``serve/``) and returns a future; ``dispatch`` runs it in the calling
thread. The port's row counts are host-known once an op returns, so
``dispatch`` is ``collect`` (the JAX package's defers one count fetch).
:func:`gate_report` reads the counters of the engine's adaptive decisions
(``GATE_PREFIXES``).
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Sequence, Tuple, Union as TUnion

from .. import ordering as _ord
from ..engine import PlanEntry, plan_executable
from ..ops import sketch as _sketch
from ..ops import quant as _quant
from ..ops import stats as _stats
from ..parallel import spill as _spill
from ..parallel import topo as _topo
from ..obs import metrics as _obsmetrics
from ..obs import prof as _prof
from ..obs import store as _obsstore
from ..obs import trace as _obstrace
from ..utils.tracing import bump, report, span
from . import feedback as _feedback
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


def gated_fingerprint(plan: Node, ctx=None) -> tuple:
    """The executable identity of a plan: its structural fingerprint, the
    ordering, semi-filter, lane-packing, quantized-wire, spill (the forced
    spill tier and the skew split, ``spill.gate_state``) and topology
    gates (the kill switch and the raw mesh request, ``topo.gate_state``),
    which decide which rewrites fire and which paths the lowered ops take,
    and last the feedback component ``(active, Decisions)``
    (``feedback.fingerprint_component`` of the rest, the BASE, by which
    the observation store keys its profile). A gate flip or a tuned
    decision's flip re-optimizes instead of reusing an executor built
    under the other state. With ``ctx`` (the plan's context) the ranks of
    a ``torch.distributed`` world agree on the decisions
    (``feedback.agree``). The one copy of this recipe: the plan cache and
    the serving scheduler's groups and batch cache key through it."""
    base = (plan.fingerprint(), _ord.enabled(), _sketch.enabled(), _stats.enabled(),
            _quant.gate_state(), _spill.gate_state(), _topo.gate_state())
    comp = _feedback.fingerprint_component(base)
    if ctx is not None:
        comp = _feedback.agree(ctx, comp)
    return base + (comp,)


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
        fired.

        ``analyze=True`` RUNS the plan (through the same cached executor
        ``collect()`` uses) under a forced query trace and prints the
        optimized tree annotated per node with its measured wall time
        (total and self), rows in and out, collective MB shipped, its
        critical-path share and the adaptive gates it took. A diagnostic
        run: each node waits for its card's work, so the times are the
        node's own; its latency never lands in the fingerprint
        histogram."""
        if analyze:
            return self._explain_analyze()
        opt, fired = _rules.optimize(self._plan, self._ctx.world_size)
        return "\n".join([
            "== Logical plan ==", self._plan.render(), "",
            "== Optimized plan ==", opt.render(), "",
            _fired_line(fired),
        ])

    def _executable(self):
        """(scan tables, the gated fingerprint, the PlanEntry, hit) through
        the plan cache: the one copy of the compile recipe of ``collect()``,
        ``explain(analyze=True)`` and the serving scheduler's single runs.
        The entry carries the histogram key and the store's profile key
        (``feedback.base_key`` of the fingerprint without its feedback
        component, so a decision flip keeps feeding one profile), so a
        cache hit hashes nothing."""
        ctx = self._ctx
        tables = _lower.scan_tables(self._plan)
        fingerprint = gated_fingerprint(self._plan, ctx)

        def compile_plan():
            with span("plan.optimize"):
                opt, fired = _rules.optimize(self._plan, ctx.world_size)
            with span("plan.lower"):
                # the cached executor holds frozen scan stubs, no tables
                opt = _lower.detach_scans(opt)
                fn = _lower.build_executor(opt)
            return PlanEntry(opt, tuple(fired), fn, _obsmetrics.fingerprint_key(fingerprint),
                             _feedback.base_key(fingerprint[:-1]))

        entry, hit = plan_executable(ctx, fingerprint, compile_plan)
        return tables, fingerprint, entry, hit

    def collect(self):
        """Optimize, lower (both cached) and run the plan: an eager Table.
        Under a query trace (``plan.optimize``, ``plan.lower``,
        ``plan.execute`` and a ``plan.node.*`` span a node) when tracing is
        on; the latency lands in the plan-fingerprint histogram either
        way. The tuned decisions the executor was keyed under apply around
        its execution. The result's counts are host-known: no read is
        added."""
        return self.dispatch()

    def dispatch(self):
        """Run the plan in the calling thread: the execution
        ``collect()`` and the serving scheduler's single runs share (the
        JAX package's ``dispatch`` defers the result's one count fetch; the
        port's counts are host-known when an op returns, so the two
        calls are one)."""
        t_q = _time.perf_counter()
        with _obstrace.query_trace(type(self._plan).__name__, kind="plan"):
            tables, fingerprint, entry, hit = self._executable()
            if hit:
                # a cached optimize + lower: the spans anyway, so every
                # collect shows in tracing.report() (at about no cost)
                with span("plan.optimize"):
                    pass
                with span("plan.lower"):
                    pass
            for f in entry.fired:
                bump(f"plan.rule.{f}")
            # the tuned decisions the executor was keyed under, and this
            # execution's gate observations for the store (both nothing
            # while autotune or the store is off)
            with _feedback.applying(fingerprint[-1]), _obsstore.exec_obs(entry.obs_key):
                with span("plan.execute"):
                    out = entry.fn(tables)
            _obstrace.attach_result(out, hist_key=entry.hist_key, obs_key=entry.obs_key,
                                    label=entry.opt.label(), t0=t_q)
            return out

    def collect_async(self, block: bool = True):
        """Submit this plan to the context's serving scheduler
        (``serve.scheduler``) and return a
        :class:`~cylon_tpu_torch.serve.QueryFuture` at once: the scheduler's
        worker runs it, batching same-fingerprint plans over different
        bindings into one stacked execution, and ``result()`` hands the
        table to the caller::

            futs = [q.collect_async() for q in queries]   # admission-gated
            tables = [f.result() for f in futs]

        ``block=False`` sheds with
        :class:`~cylon_tpu_torch.serve.ServeOverloadError` instead of
        waiting when admission (``CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES``,
        ``_QUEUE_DEPTH``) is at capacity."""
        from ..serve.scheduler import submit as _serve_submit

        return _serve_submit(self, block=block)

    def _explain_analyze(self) -> str:
        """Run the plan through the cached executor under a forced query
        trace in ``analyze_mode``, under the tuned decisions it was keyed
        with, then render the optimized tree annotated from the measured
        span tree and the tuned gates (``feedback.describe``)."""
        t_q = _time.perf_counter()
        tables, fingerprint, entry, hit = self._executable()
        with _obstrace.analyze_mode():
            with _obstrace.query_trace(type(self._plan).__name__, kind="explain",
                                       force=True) as q:
                with _feedback.applying(fingerprint[-1]), _obsstore.exec_obs(entry.obs_key):
                    with span("plan.execute"):
                        out = entry.fn(tables)
                # no histogram key: a diagnostic run's latency must not land
                # in the fingerprint histogram collect() fills
                _obstrace.attach_result(out, label=entry.opt.label(), t0=t_q)
        tuned = _feedback.describe(fingerprint[:-1])
        return "\n".join([
            "== Logical plan ==", self._plan.render(), "",
            "== Analyzed plan (executed) ==",
            _render_analyzed(entry.opt, q), "",
            _fired_line(entry.fired),
            "Tuned gates:" + ("" if tuned else " (none)"),
            *(f"  {t}" for t in tuned),
            f"Plan fingerprint: {entry.hist_key}  plan-cache {'hit' if hit else 'miss'}"
            f"  total {q.wall_s() * 1e3:.1f} ms  rows out {out.row_count}",
        ])


def _fired_line(fired) -> str:
    if not fired:
        return "Rewrites fired: (none)"
    counts: Dict[str, int] = {}
    for f in fired:
        counts[f] = counts.get(f, 0) + 1
    return "Rewrites fired: " + ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))


# ----------------------------------------------------------------------
# explain(analyze=True) rendering
# ----------------------------------------------------------------------
def _node_exclusive(sp) -> Dict:
    """Per-node EXCLUSIVE aggregation over one ``plan.node.*`` span's
    subtree, stopping at nested ``plan.node.*`` spans (their bytes and
    gate decisions belong to the child's line): collective bytes, gate
    counters (:data:`GATE_PREFIXES`), and the summed wall of the direct
    child-node spans (for self time)."""
    agg = {"coll": 0, "gates": {}, "child_wall": 0.0}

    def fold(s, top: bool) -> None:
        if not top and s.name.startswith("plan.node."):
            agg["child_wall"] += s.dur_s()
            return
        v = s.attrs.get("coll_bytes")
        if isinstance(v, (int, float)):
            agg["coll"] += int(v)
        for name, cr in s.counters.items():
            if name.startswith(GATE_PREFIXES):
                agg["gates"][name] = agg["gates"].get(name, 0) + cr[0]
        for c in s.children:
            fold(c, False)

    fold(sp, True)
    return agg


def _render_analyzed(root, q) -> str:
    """The optimized tree, each line annotated from its measured
    ``plan.node`` span: wall/self ms, rows in->out, coll MB, the
    critical-path share ("crit 0%" marks a node off the path), gates."""
    order = _lower.plan_order(root)
    by_id: Dict[int, object] = {}
    for sp in q.all_spans():
        nid = sp.attrs.get("node_id")
        if nid is not None and sp.name.startswith("plan.node."):
            by_id[nid] = sp
    crit = _prof.node_crit_shares(q)
    lines: List[str] = []

    def rows_of(c) -> int:
        # a span-less child (a Shuffle peeled into the join) contributes
        # its own spanned inputs
        csp = by_id.get(order[id(c)])
        if csp is not None:
            return int(csp.attrs.get("rows_out") or 0)
        return sum(rows_of(g) for g in c.children)

    def walk(n, indent: int) -> None:
        prefix = "  " * indent + n.line()
        sp = by_id.get(order[id(n)])
        if sp is None:
            lines.append(prefix)
        else:
            agg = _node_exclusive(sp)
            wall = sp.dur_s() * 1e3
            self_ms = max(wall - agg["child_wall"] * 1e3, 0.0)
            parts = [f"{wall:.1f} ms (self {self_ms:.1f})"]
            rows_out = sp.attrs.get("rows_out")
            if rows_out is not None:
                if n.children:
                    parts.append(f"rows={sum(rows_of(c) for c in n.children)}->{rows_out}")
                else:
                    parts.append(f"rows={rows_out}")
            if agg["coll"]:
                parts.append(f"coll={agg['coll'] / 1e6:.2f} MB")
            if id(sp) in crit:
                parts.append(f"crit {crit[id(sp)] * 100:.0f}%")
            if agg["gates"]:
                parts.append("gates[" + ", ".join(
                    f"{k} x{v}" if v > 1 else k for k, v in sorted(agg["gates"].items())) + "]")
            lines.append(prefix + "  ** " + "  ".join(parts))
        for c in n.children:
            walk(c, indent + 1)

    walk(root, 0)
    return "\n".join(lines)


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
