"""Delta-aware recompute of cached plans over appendable tables
(counterpart of cylon_tpu/stream/delta.py).

An :class:`IncrementalView` keeps the result of one lazy plan as its
:class:`~cylon_tpu_torch.stream.ingest.AppendableTable` sources grow, and
runs on only the new rows wherever the plan's algebra allows. The deltas
are ordinary lazy plans over ordinary snapshot tables, so they ride the
shuffle and every gate of the planner (semi filter, lane packing,
quantized wire) unchanged.

DELTA ALGEBRA (anything outside it recomputes in full, counted
``stream.refresh.fallback``):

Filter / Project
    Distribute over appended rows: ``chain(T + dT) = chain(T) +
    chain(dT)``; the delta rides the chain.

Inner Join (at most one streaming Scan a side)
    ``(L+dL) join (R+dR) = L join R + dL join (R+dR) + L join dR``: term 1
    is the retained result, term 2 binds the delta against the current
    right snapshot, term 3 binds the retained previous left snapshot
    against the right delta. Outer joins do not decompose this way (their
    null-extended rows flip): full recompute.

GroupBy (root; ops sum / count / min / max)
    The retained result is itself the partial: sum, min and max merge by
    aggregating again, count by sum. The GroupBy rides inside each delta
    term's plan (the join-sum pushdown included), and the per-group
    partials, O(distinct keys) rows, merge on the host
    (:func:`_merge_partials`) in a fixed order: the previous result first,
    then each term's partials. ``mean`` does not merge from its own
    output: full recompute.

Sort / Limit / Union / nested joins
    Full recompute.

Every table a delta plan binds is stamped by ingest.py, and
``Scan._params`` reads the stamp, so ``gated_fingerprint`` tells every
refresh apart: cached executors, observation profiles and serving groups
never alias across generations.

``CYLON_TPU_TORCH_NO_IVM=1`` (declared below through ``env_gate``) turns
the delta path off: every refresh recomputes from the current snapshots.
It is the differential oracle of the tests and of ``chip_smoke.py``.

FAILURE DOMAIN: the ``stream.refresh`` fault seam fires before any state
is touched; any refresh failure surfaces as a typed
:class:`~cylon_tpu_torch.fault.errors.CylonError` with the view's retained
state (snapshots, result, generations) unchanged, so the previous result
stays queryable and the next refresh retries the same delta.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..fault import inject as _fault
from ..fault.errors import CylonError, QueryExecError
from ..obs import metrics as _obsmetrics
from ..obs import store as _obsstore
from ..plan import feedback as _feedback
from ..plan import lazy as _lazy
from ..plan import nodes as _nodes
from ..table import Table, concat as _concat_tables
from ..utils.envgate import env_gate
from ..utils.tracing import bump

#: CYLON_TPU_TORCH_NO_IVM=1 -> every refresh is a full recompute (the
#: differential oracle)
ivm_enabled, ivm_disabled = env_gate(
    "CYLON_TPU_TORCH_NO_IVM",
    keyed_via="full and delta refreshes bind differently stamped tables "
    "(snapshot against delta _stream_gen), so their fingerprints, and every "
    "cache keyed by them, already separate; the gate itself reaches no "
    "kernel",
    note="=1 disables incremental view maintenance: every stream refresh "
    "recomputes from the full current snapshots (the differential oracle)",
)

#: the merge operator of each mergeable aggregate (count merges by sum);
#: any other op (mean, ...) forces a full recompute
MERGE_OPS = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


class _Fragment:
    """One classified plan: the supported shape's pieces."""

    __slots__ = ("agg", "inner", "scans", "join", "left_scan", "right_scan")

    def __init__(self, agg, inner, scans, join, left_scan, right_scan):
        self.agg = agg          # GroupBy node or None
        self.inner = inner      # the plan below the GroupBy (or the root)
        self.scans = scans      # [(scan node, source index or None)]
        self.join = join        # Join node or None
        self.left_scan = left_scan    # (scan, source index or None) under the left
        self.right_scan = right_scan  # likewise on the right


def _chain_to_scan(node):
    """Descend a Filter/Project chain: (node reached, reached a Scan)."""
    while isinstance(node, (_nodes.Filter, _nodes.Project)):
        node = node.children[0]
    return node, isinstance(node, _nodes.Scan)


def _source_index(table, sources) -> Optional[int]:
    src = getattr(table, "_stream_src", None)
    for i, s in enumerate(sources):
        if src is not None and src() is s:
            return i
    return None


def classify(plan, sources) -> Optional[_Fragment]:
    """Dissect ``plan`` into the supported incremental fragment, or None
    (a full recompute). ``sources`` maps streaming Scans by position."""
    agg = None
    node = plan
    if isinstance(node, _nodes.GroupBy):
        if not all(op in MERGE_OPS for _c, op in node.aggs):
            return None
        agg = node
        node = node.children[0]
    probe, _ = _chain_to_scan(node)
    if isinstance(probe, _nodes.Scan):
        idx = _source_index(probe.table, sources)
        return _Fragment(agg, node, [(probe, idx)], None, None, None)
    if isinstance(probe, _nodes.Join):
        if probe.how != "inner":
            return None
        lscan, lok = _chain_to_scan(probe.children[0])
        rscan, rok = _chain_to_scan(probe.children[1])
        if not (lok and rok):
            return None
        l_idx = _source_index(lscan.table, sources)
        r_idx = _source_index(rscan.table, sources)
        return _Fragment(agg, node, [(lscan, l_idx), (rscan, r_idx)], probe,
                         (lscan, l_idx), (rscan, r_idx))
    return None


def _rebind(node, tmap):
    """Copy ``node``'s subtree with fresh Scans, binding the tables of
    ``tmap`` (id(original scan) -> Table); an unmapped Scan binds its own
    table (a fresh node, so ordinal churn never reaches the plan a user
    still holds)."""
    if isinstance(node, _nodes.Scan):
        t = tmap.get(id(node))
        return _nodes.Scan(t if t is not None else node.table)
    return node.with_children([_rebind(c, tmap) for c in node.children])


def _isnull(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


#: the null key of the host merge: NaN != NaN would split the null group
#: into one entry a partial row (the device groupby keeps one null group)
_NULL_KEY = object()


def _combiner(op) -> Callable:
    """Null-aware binary merge of one aggregate's partials."""
    mop = MERGE_OPS[op]
    if mop == "sum":
        base = lambda a, b: a + b  # noqa: E731
    elif mop == "min":
        base = min
    else:
        base = max

    def merge(a, b):
        if _isnull(a):
            return b
        if _isnull(b):
            return a
        return base(a, b)

    return merge


def _merge_partials(ctx, keys, aggs, parts):
    """Merge per-group aggregate partials on the host into one Table.

    The partials are O(distinct keys) rows read with ``to_pydict``; they
    merge in insertion order (the previous result first, then each term's
    partials), so float sums add in one fixed order, and the result takes
    the partials' dtypes, the schema of a full recompute."""
    agg_cols = [f"{c}_{op}" for c, op in aggs]
    combine = [_combiner(op) for _c, op in aggs]
    acc: Dict[tuple, list] = {}
    ref_dtypes: Dict[str, object] = {}
    for t in parts:
        d = t.to_pydict()
        for c in list(keys) + agg_cols:
            dt = getattr(d[c], "dtype", None)
            if c not in ref_dtypes and dt is not None and dt != object:
                ref_dtypes[c] = dt
        key_cols = [d[k] for k in keys]
        val_cols = [d[c] for c in agg_cols]
        for i in range(len(key_cols[0])):
            kt = tuple(_NULL_KEY if _isnull(col[i]) else col[i] for col in key_cols)
            vals = [col[i] for col in val_cols]
            cur = acc.get(kt)
            if cur is None:
                acc[kt] = vals
            else:
                for j, fn in enumerate(combine):
                    cur[j] = fn(cur[j], vals[j])
    data: Dict[str, object] = {}
    for j, k in enumerate(keys):
        data[k] = np.array([None if kt[j] is _NULL_KEY else kt[j] for kt in acc], dtype=object)
    for j, c in enumerate(agg_cols):
        data[c] = np.array([vals[j] for vals in acc.values()], dtype=object)
    # rebuilt through object arrays (nulls need them), handed to
    # from_pydict in the partials' dtypes: the incremental result carries
    # the schema of a full recompute
    for c, dt in ref_dtypes.items():
        col = data[c]
        if not any(v is None or v != v for v in col):
            data[c] = col.astype(dt)
    return Table.from_pydict(ctx, data)


class IncrementalView:
    """The maintained result of ``build(*snapshots)`` as the sources grow.

    ``build`` takes one snapshot :class:`Table` a source (by position) and
    returns a :class:`~cylon_tpu_torch.plan.lazy.LazyFrame`; static tables
    may be captured in its closure. ``refresh()`` brings the result up to
    the sources' current generations (incrementally where the fragment
    allows); ``result()`` refreshes if stale and returns the result."""

    def __init__(self, build: Callable, sources: Sequence, ctx=None):
        if not sources:
            raise ValueError("IncrementalView needs at least one source")
        self._build = build
        self._sources = list(sources)
        self.ctx = ctx if ctx is not None else sources[0].ctx
        self._lock = threading.RLock()
        self._gens: Optional[List[int]] = None
        self._prev: Optional[List] = None   # the retained snapshots at _gens
        self._result = None                 # the retained result Table
        #: refresh counts by mode
        self.stats = {"noop": 0, "full": 0, "fallback": 0, "inc": 0}

    # -- public surface ------------------------------------------------
    @property
    def generations(self) -> Optional[List[int]]:
        """The source generations the retained result reflects."""
        return None if self._gens is None else list(self._gens)

    def stale(self) -> bool:
        """Host-only check: has any source grown past the result?"""
        if self._gens is None:
            return True
        return any(s.generation != g for s, g in zip(self._sources, self._gens))

    def refresh(self):
        """Bring the result up to the sources' current generations and
        return it. Raises only :class:`CylonError` subclasses, with the
        retained state unchanged."""
        _mode, lf, commit = self._plan_refresh()
        if lf is None:
            return commit(None)
        return commit(lf.collect())

    def result(self):
        """The current result (refreshed first if stale)."""
        if self.stale():
            return self.refresh()
        with self._lock:
            return self._result

    # -- the refresh planner (shared with subscribe.py) ----------------
    def _plan_refresh(self):
        """Decide this refresh's mode and primary plan without touching the
        retained state: ``(mode, lf, commit)``, where ``lf`` is the plan to
        run (None for a no-op) and ``commit(table)`` finishes the refresh
        (the merge and the state swap) and returns the new result. Builds
        plans and snapshots only (a snapshot's encode uploads it)."""
        try:
            return self._plan_refresh_inner()
        except CylonError:
            raise
        except Exception as e:
            raise QueryExecError(f"stream refresh failed: {e}") from e

    def _plan_refresh_inner(self):
        with self._lock:
            # the refresh seam: before any plan runs or any retained state
            # is touched
            _fault.check("stream.refresh")
            t0 = time.perf_counter()
            cur_gens = [s.generation for s in self._sources]
            if self._gens is not None and cur_gens == self._gens and self._result is not None:
                bump("stream.refresh.noop")
                self.stats["noop"] += 1
                res = self._result
                return "noop", None, (lambda _t: res)
            cur = [s.table() for s in self._sources]
            if self._result is None or not ivm_enabled():
                return self._plan_full(cur_gens, cur, t0, "full")
            frag = classify(self._build(*cur).plan, self._sources)
            if frag is None:
                return self._plan_full(cur_gens, cur, t0, "fallback")
            return self._plan_incremental(frag, cur_gens, cur, t0)

    def _plan_full(self, cur_gens, cur, t0, mode):
        lf = self._build(*cur)

        def commit(table):
            with self._lock:
                self._gens, self._prev, self._result = cur_gens, cur, table
            self.stats[mode] += 1
            bump(f"stream.refresh.{mode}")
            self._journal(lf, t0)
            return table

        return mode, lf, commit

    def _plan_incremental(self, frag, cur_gens, cur, t0):
        sources, prev_gens, prev = self._sources, self._gens, self._prev
        deltas = [s.delta_table(g) if s.rows_since(g) > 0 else None
                  for s, g in zip(sources, prev_gens)]
        delta_rows = sum(s.rows_since(g) for s, g in zip(sources, prev_gens))
        # each term binds delta, current or previous snapshots into a fresh
        # copy of the inner plan; a GroupBy root rides inside each term and
        # only the partials merge on the host
        terms = []
        if frag.join is None:
            scan, idx = frag.scans[0]
            if idx is not None and deltas[idx] is not None:
                terms.append(_rebind(frag.inner, {id(scan): deltas[idx]}))
        else:
            (lscan, l_idx), (rscan, r_idx) = frag.left_scan, frag.right_scan
            if l_idx is not None and deltas[l_idx] is not None:
                # dL join R_current (covers dL join dR)
                terms.append(_rebind(frag.inner, {
                    id(lscan): deltas[l_idx],
                    id(rscan): cur[r_idx] if r_idx is not None else rscan.table,
                }))
            if r_idx is not None and deltas[r_idx] is not None:
                # L_previous (the retained build side) join dR
                terms.append(_rebind(frag.inner, {
                    id(lscan): prev[l_idx] if l_idx is not None else lscan.table,
                    id(rscan): deltas[r_idx],
                }))
        if not terms:
            # generations moved but no rows did (empty appends elsewhere):
            # the retained result is current
            res = self._result

            def commit_noop(_t):
                with self._lock:
                    self._gens, self._prev = cur_gens, cur
                bump("stream.refresh.noop")
                self.stats["noop"] += 1
                return res

            return "noop", None, commit_noop

        if frag.agg is not None:
            terms = [frag.agg.with_children([t]) for t in terms]
        primary = _lazy.LazyFrame(terms[0], self.ctx)
        rest = [_lazy.LazyFrame(t, self.ctx) for t in terms[1:]]
        prev_result = self._result

        def commit(table):
            parts = [table] + [r.collect() for r in rest]
            if frag.agg is not None:
                new_result = _merge_partials(self.ctx, list(frag.agg.keys), frag.agg.aggs,
                                             [prev_result] + parts)
            else:
                delta_out = parts[0] if len(parts) == 1 else _concat_tables(parts)
                new_result = _concat_tables([prev_result, delta_out])
            with self._lock:
                self._gens, self._prev, self._result = cur_gens, cur, new_result
            self.stats["inc"] += 1
            bump("stream.refresh.inc")
            bump("stream.refresh.delta_rows", rows=delta_rows)
            self._journal(primary, t0)
            return new_result

        return "inc", primary, commit

    def _journal(self, lf, t0: float) -> None:
        """Feed this refresh's wall latency to the observation store, under
        the executed plan's profile identity (the base of its gated
        fingerprint, as the re-coster reads it), and to the
        ``stream.refresh`` latency histogram."""
        dt = time.perf_counter() - t0
        bump("stream.refresh")
        try:
            fp = _lazy.gated_fingerprint(lf.plan)
            _obsstore.observe_latency(_feedback.base_key(fp[:-1]), dt)
        except Exception:
            pass  # observation is best-effort and never fails a refresh
        _obsmetrics.observe_latency("stream.refresh", dt)


def view(build: Callable, *sources, ctx=None) -> IncrementalView:
    """``stream.view(lambda l, r: ..., left_tab, right_tab)``."""
    return IncrementalView(build, sources, ctx=ctx)
