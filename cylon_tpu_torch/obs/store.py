"""The persistent observation store: a journal of what the obs layer
measures, keyed by plan fingerprint, surviving across runs (counterpart
of cylon_tpu/obs/store.py).

It persists per-node wall/rows/coll-MB, the gate decisions (semi-filter
selectivity, wire plan, spill tier, skew split, serve batch size), stage
clocks and the plan-fingerprint latencies: the evidence the feedback
re-coster (``plan/feedback.py``) tunes the engine's adaptive gates from.
Every absorbed ``exec`` or ``lat`` record re-costs its profile's tuned
decisions under hysteresis (``feedback.update_profile_decisions``).

LAYOUT (under ``CYLON_TPU_TORCH_OBS_DIR``; unset = the store is off and
every hook here is a cheap no-op):

``journal-<pid>.jsonl`` (one per writer process)
    Append-only, one JSON record per line, each writer owning its own
    file, so several processes can share one directory without
    coordinating writes. A torn or truncated tail line (the process died
    mid-write) is skipped on load. Records: ``exec`` (one per plan
    execution: the shuffle planner's measured counts, gate decisions,
    selectivity, device bytes allocated), ``lat`` (one per resolved query
    latency), ``trace`` (per-node wall/rows/coll bytes of a finished
    query trace), ``hist`` (an in-process latency histogram evicted by
    the bounded registry in :mod:`.metrics`).

``snapshot.json``
    The compacted store: bounded per-fingerprint PROFILES (count,
    geometric latency buckets, mean selectivity, observed bytes/row,
    hottest bucket, staged bytes, footprint distribution, per-node
    aggregates), the current tuned decisions and their hysteresis state,
    and a per-writer ``jseqs`` map of the journal record ids already
    folded in. Every ``COMPACT_EVERY`` own-journal records the
    owner re-reads the whole directory under a cross-process ``flock``,
    writes the merged snapshot (atomic tmp+rename) and truncates ITS OWN
    journal only, so concurrent writers never lose each other's records.
    The profile set is LRU-bounded (``PROFILE_CAP``).

KEYING: profiles are keyed by the plan's BASE gated fingerprint, without
the feedback component (``plan/feedback.base_key``), so a decision flip
re-keys the executor but keeps feeding the same profile.

THREADING + SYNC DISCIPLINE: all mutation is lock-serialized; the store
is host-only file I/O and dict math: it never touches a device.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import threading
from contextvars import ContextVar
from typing import Any, Dict, List, Optional

from ..fault import inject as _fault
from ..utils import envgate as _eg

#: journal records folded into the snapshot per compaction cycle; the
#: journal never holds more than this many lines plus the torn tail
COMPACT_EVERY = 256
#: bounded per-fingerprint profile set (LRU by last observation)
PROFILE_CAP = 512
#: bounded evicted-histogram set carried in the snapshot
HIST_CAP = 1024
#: latency buckets per decade — matches obs.metrics so merged histograms
#: stay exact
BUCKETS_PER_DECADE = 24

_lock = threading.RLock()
_STORES: Dict[str, "ObsStore"] = {}


def store() -> Optional["ObsStore"]:
    """The process's store for the current ``CYLON_TPU_TORCH_OBS_DIR`` (read
    per call — flips take effect on the next observation), or None when
    the knob is unset (everything downstream no-ops)."""
    d = _eg.OBS_DIR.get()
    if not d:
        return None
    s = _STORES.get(d)
    if s is None:
        with _lock:
            s = _STORES.get(d)
            if s is None:
                s = ObsStore(d)
                _STORES[d] = s
    return s


def reset_stores() -> None:
    """Drop every open store handle (tests; the files stay on disk)."""
    with _lock:
        for s in _STORES.values():
            s.close()
        _STORES.clear()


# ----------------------------------------------------------------------
# profile schema + latency-bucket math (mirrors obs.metrics.Histogram)
# ----------------------------------------------------------------------
def new_profile() -> Dict[str, Any]:
    return {
        "n": 0,              # exec observations
        "foot": _new_lat(),  # per-query device-bytes footprint (geometric
                             # buckets)
        "world": 0,
        "row_bytes": 0,      # last observed exchange row bytes
        "hot": 0,            # max observed hottest-bucket rows
        "mean_bucket": 0,    # last observed mean bucket rows
        "staged_max": 0,     # max observed per-shard staged bytes
        "tier_max": 0,       # highest spill tier observed
        "budget": 0,         # last effective shuffle byte budget
        "coll_sum": 0,       # total collective bytes shipped
        "rounds_sum": 0,
        "wire_n": 0,         # wire-narrowing engagements
        "relay_n": 0,
        # 2-D topology hop-mode evidence (parallel/topo.py): per
        # observation the exec record carries the cross-outer bytes of
        # BOTH hop modes (one measured, one modeled, both host-exact
        # formulas), accumulated by mode so the means compare regardless
        # of which ran
        "topo": None,        # last observed (outer, inner)
        "hop_n": 0,          # observations carrying hop evidence
        "hop2_n": 0,         # of those, ran two-hop
        "hop_i2_sum": 0,     # cross-outer bytes under two-hop
        "hop_i1_sum": 0,     # cross-outer bytes under flat (1-hop)
        "intra_sum": 0,      # inner-axis bytes actually shipped        # skew-split relays
        "sel_sum": 0.0,      # semi-filter selectivity accumulator
        "sel_n": 0,
        # straggler ledger (obs/prof.py stage clocks): the max per-stage
        # max/mean shard-time ratio per profiled execution
        "strag_sum": 0.0,
        "strag_n": 0,
        "stages": {},        # stage -> [count, ms_sum, straggler_max]
        "sketch_built": 0,
        "payoff_skip": 0,    # static size gate declined the sketch
        "static_budget": 0,  # the ctx's untuned budget (proposal baseline)
        "lat": _new_lat(),
        # serving-only latency window (samples carrying a batch size B):
        # the serve-bucket proposer judges this, never the pooled `lat`,
        # which also holds serial collect latencies no bucket can change
        "serve_lat": _new_lat(),
        "serve_b": {},       # str(B) -> count of batched resolutions
        "nodes": {},         # node name -> [count, wall_ms, rows, coll]
        "dec": {},           # tuned decisions (plan/feedback.py)
        "pend": {},          # hysteresis: field -> [candidate, streak]
        "flips": 0,
        "seq": 0,            # LRU clock
    }


def _new_lat() -> Dict[str, Any]:
    return {"b": {}, "n": 0, "total": 0.0, "min": None, "max": 0.0}


def lat_record(lat: Dict[str, Any], seconds: float) -> None:
    s = max(float(seconds), 1e-9)
    b = str(int(math.floor(math.log10(s) * BUCKETS_PER_DECADE)))
    lat["b"][b] = lat["b"].get(b, 0) + 1
    lat["n"] += 1
    lat["total"] += s
    lat["min"] = s if lat["min"] is None else min(lat["min"], s)
    lat["max"] = max(lat["max"], s)


def lat_quantile(lat: Dict[str, Any], q: float) -> float:
    """Upper bucket edge holding the q-quantile, clamped to [min, max] —
    the shared read-off (obs.metrics.bucket_quantile) over the profile's
    string-keyed buckets."""
    from .metrics import bucket_quantile

    n = lat.get("n", 0)
    if not n:
        return 0.0
    edge = bucket_quantile(
        {int(b): c for b, c in lat["b"].items()}, q
    )
    lo = lat["min"] if lat["min"] is not None else edge
    return min(max(edge, lo), lat["max"])


def lat_merge(into: Dict[str, Any], other: Dict[str, Any]) -> None:
    for b, c in other.get("b", {}).items():
        into["b"][b] = into["b"].get(b, 0) + c
    into["n"] += other.get("n", 0)
    into["total"] += other.get("total", 0.0)
    om = other.get("min")
    if om is not None:
        into["min"] = om if into["min"] is None else min(into["min"], om)
    into["max"] = max(into["max"], other.get("max", 0.0))


# ----------------------------------------------------------------------
# directory-level machinery (shared by load and merge-compaction)
# ----------------------------------------------------------------------
def _journal_files(directory: str) -> List[tuple]:
    """``[(writer_id, path)]`` of every journal in the directory, sorted
    for deterministic replay order; the legacy single-writer
    ``journal.jsonl`` reads as writer ''."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in sorted(names):
        if name == "journal.jsonl":
            out.append(("", os.path.join(directory, name)))
        elif name.startswith("journal-") and name.endswith(".jsonl"):
            out.append((name[8:-6], os.path.join(directory, name)))
    return out


@contextlib.contextmanager
def _dir_lock(directory: str):
    """Exclusive CROSS-PROCESS compaction lock: ``flock`` on
    ``<dir>/store.lock``. Two writers compacting concurrently would
    otherwise lose the first snapshot's fold (last rename wins); under
    the flock each fold reads the other's just-written snapshot. Reads
    need no lock — snapshot replacement is an atomic rename and journal
    appends are line-granular (a torn tail is the already-handled skip
    case). Yields True when the exclusive lock is HELD; False on
    platforms without fcntl (or an unlockable volume) — the caller must
    then skip any multi-writer fold-and-truncate, because an unlocked
    concurrent compaction could overwrite another writer's fold."""
    f = None
    try:
        import fcntl

        f = open(os.path.join(directory, "store.lock"), "a+")
        fcntl.flock(f, fcntl.LOCK_EX)
    except (ImportError, OSError):
        if f is not None:
            with contextlib.suppress(OSError):
                f.close()
            f = None
    try:
        yield f is not None
    finally:
        if f is not None:
            with contextlib.suppress(OSError):
                import fcntl

                fcntl.flock(f, fcntl.LOCK_UN)
                f.close()


def _evict_caps(profiles: Dict, hists: Dict) -> None:
    while len(profiles) > PROFILE_CAP:
        oldest = min(profiles, key=lambda fp: profiles[fp].get("seq", 0))
        del profiles[oldest]
    while len(hists) > HIST_CAP:
        hists.pop(next(iter(hists)))


def _absorb_record(profiles: Dict, hists: Dict, rec: Dict, seq: int) -> int:
    """Fold one journal record into the profile/hist dicts; returns the
    advanced LRU clock. Pure host dict math — shared verbatim by the
    live absorb path, initial load, and merge-compaction."""
    kind = rec.get("k")
    if kind == "hist":
        h = hists.get(rec.get("key", ""))
        lat = {
            "b": rec.get("b", {}), "n": rec.get("n", 0),
            "total": rec.get("total", 0.0), "min": rec.get("min"),
            "max": rec.get("max", 0.0),
        }
        if h is None:
            hists[rec.get("key", "")] = {
                "label": rec.get("label", ""), **lat,
            }
        else:
            lat_merge(h, lat)
        return seq
    fp = rec.get("fp")
    if not fp:
        return seq
    p = profiles.get(fp)
    if p is None:
        p = profiles[fp] = new_profile()
    if kind == "exec":
        p["n"] += 1
        if rec.get("world"):
            p["world"] = int(rec["world"])
        if rec.get("row_bytes"):
            p["row_bytes"] = int(rec["row_bytes"])
        p["hot"] = max(p["hot"], int(rec.get("hot", 0)))
        if rec.get("mean_bucket"):
            p["mean_bucket"] = int(rec["mean_bucket"])
        p["staged_max"] = max(p["staged_max"], int(rec.get("staged", 0)))
        p["tier_max"] = max(p["tier_max"], int(rec.get("tier", 0)))
        if rec.get("budget"):
            p["budget"] = int(rec["budget"])
        p["coll_sum"] += int(rec.get("coll", 0))
        p["rounds_sum"] += int(rec.get("rounds", 0))
        p["wire_n"] += 1 if rec.get("wire") else 0
        p["relay_n"] += 1 if rec.get("relay") else 0
        if rec.get("static_budget"):
            p["static_budget"] = int(rec["static_budget"])
        # 2-D topology hop evidence: both modes' cross-outer bytes per
        # observation (one measured, one modeled — see note_shuffle)
        if rec.get("topo") is not None:
            p["topo"] = list(rec["topo"])
            p["hop_n"] = p.get("hop_n", 0) + 1
            ran2 = bool(rec.get("hop2"))
            p["hop2_n"] = p.get("hop2_n", 0) + (1 if ran2 else 0)
            inter = int(rec.get("inter", 0))
            alt = int(rec.get("inter_alt", -1))
            if ran2:
                p["hop_i2_sum"] = p.get("hop_i2_sum", 0) + inter
                if alt >= 0:
                    p["hop_i1_sum"] = p.get("hop_i1_sum", 0) + alt
            else:
                p["hop_i1_sum"] = p.get("hop_i1_sum", 0) + inter
                if alt >= 0:
                    p["hop_i2_sum"] = p.get("hop_i2_sum", 0) + alt
            p["intra_sum"] = p.get("intra_sum", 0) + int(rec.get("intra", 0))
        sels = rec.get("sel")
        if sels:
            for s in sels:
                p["sel_sum"] += float(s)
                p["sel_n"] += 1
        p["sketch_built"] += int(rec.get("sketch_built", 0))
        p["payoff_skip"] += int(rec.get("payoff_skip", 0))
        # stage-clock evidence (obs/prof.py): per-stage ms + straggler
        # ratios; the record-level max ratio drives the skew-trigger
        # hysteresis streak (one sample per profiled exec)
        if rec.get("strag") is not None:
            p["strag_sum"] = p.get("strag_sum", 0.0) + float(rec["strag"])
            p["strag_n"] = p.get("strag_n", 0) + 1
        for stage, (ms, ratio) in (rec.get("stg") or {}).items():
            agg = p.setdefault("stages", {}).setdefault(stage, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] = round(agg[1] + float(ms), 3)
            agg[2] = max(agg[2], float(ratio))
        # sort evidence (note_sort): per-impl [n, ms_sum, passes_sum,
        # alt_passes_sum]
        for impl, (n_s, ms, passes, alt) in (rec.get("sort") or {}).items():
            ev = p.setdefault("sort_ev", {}).setdefault(
                impl, [0, 0.0, 0, 0]
            )
            ev[0] += int(n_s)
            ev[1] = round(ev[1] + float(ms), 3)
            ev[2] += int(passes)
            ev[3] += int(alt)
        # shuffle-codec evidence (note_codec): same shape as sort_ev
        for impl, (n_c, ms, passes, alt) in (rec.get("codec") or {}).items():
            ev = p.setdefault("codec_ev", {}).setdefault(
                impl, [0, 0.0, 0, 0]
            )
            ev[0] += int(n_c)
            ev[1] = round(ev[1] + float(ms), 3)
            ev[2] += int(passes)
            ev[3] += int(alt)
        # footprint: device bytes the resource ledger attributed to this
        # execution (a batched exec divides by its query count, so the
        # distribution stays per query)
        dev = rec.get("dev")
        if dev:
            qn = max(int(rec.get("qn") or 1), 1)
            lat_record(p.setdefault("foot", _new_lat()), float(dev) / qn)
    elif kind == "lat":
        lat_record(p["lat"], float(rec.get("s", 0.0)))
        b = rec.get("b")
        if b:
            key = str(int(b))
            p.setdefault("serve_b", {})
            p["serve_b"][key] = p["serve_b"].get(key, 0) + 1
            lat_record(p.setdefault("serve_lat", _new_lat()), float(rec.get("s", 0.0)))
    elif kind == "trace":
        for name, wall_ms, rows, coll in rec.get("nodes", []):
            agg = p["nodes"].setdefault(name, [0, 0.0, 0, 0])
            agg[0] += 1
            agg[1] += float(wall_ms)
            agg[2] += int(rows)
            agg[3] += int(coll)
    else:
        return seq
    seq += 1
    p["seq"] = seq
    # re-cost the tuned decisions from the updated evidence (the
    # hysteresis lives with the proposers in plan/feedback). The record
    # kind scopes which gates re-propose, so a streak counts
    # gate-relevant observations: one exec record a query for the
    # shuffle-side gates, one latency sample for the serve bucket; trace
    # records advance nothing
    if kind in ("exec", "lat"):
        from ..plan import feedback as _fb

        _fb.update_profile_decisions(p, kind)
    return seq


def _read_dir(directory: str) -> tuple:
    """Merged durable view of one observation directory: the snapshot
    plus every writer's journal replayed (records a writer already
    folded are skipped via its ``jseqs`` entry; torn/garbled lines are
    skipped and counted). Returns ``(profiles, hists, jseqs,
    skipped_lines, per_writer_line_counts)`` where ``jseqs`` holds the
    max record id durable per writer — what a compaction stamps into the
    next snapshot."""
    profiles: Dict[str, Dict[str, Any]] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    jseqs: Dict[str, int] = {}
    try:
        with open(os.path.join(directory, "snapshot.json")) as f:
            snap = json.load(f)
        profiles = dict(snap.get("profiles", {}))
        hists = dict(snap.get("hists", {}))
        if "jseqs" in snap:
            jseqs = {str(k): int(v) for k, v in snap["jseqs"].items()}
        elif snap.get("jseq"):
            # v1 single-writer snapshot: its folded seq covers the
            # legacy journal.jsonl writer
            jseqs = {"": int(snap["jseq"])}
    except (OSError, ValueError):
        pass  # no/garbled snapshot: profiles rebuild from the journals
    seq = max([p.get("seq", 0) for p in profiles.values()] + [0])
    skipped = 0
    lines: Dict[str, int] = {}
    for writer, path in _journal_files(directory):
        folded = jseqs.get(writer, 0)
        seen = folded
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        skipped += 1
                        continue
                    if not isinstance(rec, dict):
                        skipped += 1
                        continue
                    i = rec.get("i")
                    if isinstance(i, int):
                        if i <= folded:
                            continue  # already folded into the snapshot
                        seen = max(seen, i)
                    seq = _absorb_record(profiles, hists, rec, seq)
                    lines[writer] = lines.get(writer, 0) + 1
        except OSError:
            continue
        if seen:
            jseqs[writer] = seen
    _evict_caps(profiles, hists)
    return profiles, hists, jseqs, skipped, lines


# ----------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------
class ObsStore:
    """One observation directory: profiles + own journal + merge-aware
    compaction. ``writer_id`` defaults to the process id — every process
    appends to its own ``journal-<pid>.jsonl``, so N processes share one
    directory with no write coordination (tests pass explicit ids to
    simulate multiple writers in one process)."""

    def __init__(
        self,
        directory: str,
        compact_every: int = COMPACT_EVERY,
        writer_id: Optional[str] = None,
    ):
        self.dir = directory
        self.compact_every = int(compact_every)
        self.writer_id = str(os.getpid()) if writer_id is None else writer_id
        self.journal_path = os.path.join(
            directory, f"journal-{self.writer_id}.jsonl"
        )
        self.snapshot_path = os.path.join(directory, "snapshot.json")
        self._lock = threading.RLock()
        self._jf = None
        self._jlines = 0
        self._since_flush = 0
        #: journal write failed (disk full / readonly / fault seam): the
        #: store DEGRADES to in-memory-only telemetry — profiles keep
        #: absorbing, we just stop persisting. Never re-armed for this store's lifetime
        #: (a flapping volume must not turn every query into a failed
        #: syscall); a fresh process / reset_stores() retries.
        self.journal_degraded = False
        self._rec_seq = 0   # own monotone journal record id (replay dedup)
        self._seq = 0
        self._jseqs: Dict[str, int] = {}
        self.profiles: Dict[str, Dict[str, Any]] = {}
        self.hists: Dict[str, Dict[str, Any]] = {}
        self.skipped_lines = 0  # torn/garbled journal lines on load
        self._load()

    # -- load / persistence --------------------------------------------
    def _load(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        # merge-on-load: the snapshot plus EVERY writer's journal — a
        # crash mid-append costs at most the records after the last
        # complete line of one journal, never the store; records the
        # snapshot already folded are skipped per-writer so the window
        # between a compaction's snapshot rename and its journal
        # truncate never double-absorbs.
        (self.profiles, self.hists, self._jseqs,
         self.skipped_lines, lines) = _read_dir(self.dir)
        self._seq = max(
            [p.get("seq", 0) for p in self.profiles.values()] + [0]
        )
        self._rec_seq = self._jseqs.get(self.writer_id, 0)
        self._jlines = lines.get(self.writer_id, 0)
        # prime the decision caches for the feedback layer
        from ..plan import feedback as _fb

        for p in self.profiles.values():
            p["_dec"] = _fb.effective_decisions(p)

    def _journal_file(self):
        if self._jf is None:
            self._jf = open(self.journal_path, "a")
        return self._jf

    #: journal appends ride OS buffering; an explicit flush happens every
    #: FLUSH_EVERY records (+ close/compact), bounding both the syscall
    #: load on the query-resolution hot path and the crash-loss window —
    #: an unflushed tail is exactly the torn-line case the loader skips
    FLUSH_EVERY = 32

    def record(self, rec: Dict[str, Any]) -> None:
        """Absorb one observation record into its profile AND append it
        to the journal; compacts past ``compact_every`` records.

        GRACEFUL DEGRADATION (the ``obs.journal`` fault seam exercises
        this): a journal write failure — a full/readonly volume — must
        never fail the query that produced the observation. The in-
        memory absorb above already happened; the store flips to
        in-memory-only mode (``journal_degraded``, counted once under
        ``obs.journal_degraded``) and stops issuing writes."""
        with self._lock:
            self._rec_seq += 1
            rec.setdefault("i", self._rec_seq)
            self._absorb(rec)
            if self.journal_degraded:
                return
            try:
                _fault.check("obs.journal")
                jf = self._journal_file()
                jf.write(json.dumps(rec, separators=(",", ":")) + "\n")
                self._since_flush += 1
                if self._since_flush >= self.FLUSH_EVERY:
                    jf.flush()
                    self._since_flush = 0
            except OSError:
                self.journal_degraded = True
                # lazy: utils.tracing routes through obs.trace -> this
                # module; the rollup primitive underneath is cycle-free
                from .metrics import rollup_count

                rollup_count("obs.journal_degraded")
                return
            self._jlines += 1
            if self._jlines >= self.compact_every:
                self.compact()

    def flush(self) -> None:
        """Flush the buffered journal tail to disk: multi-writer callers
        (a server beside a worker) use this to make records visible to other
        processes' loads before the FLUSH_EVERY cadence would."""
        with self._lock:
            if self._jf is not None:
                with contextlib.suppress(OSError):
                    self._jf.flush()
                self._since_flush = 0

    def compact(self) -> None:
        """Fold the DIRECTORY — snapshot plus every writer's journal,
        re-read fresh under the cross-process flock — into a new merged
        snapshot (atomic tmp+rename), then truncate OWN journal only.
        Concurrent writers keep appending; their durable records fold in
        (their ``jseqs`` advance so their own later compaction skips
        them), their journals are never touched, and the merged view is
        adopted in memory — so a long-lived writer also SEES its
        neighbors' profiles after each compaction, not just at load."""
        with self._lock:
            # flush own buffered tail first: the disk fold below must
            # see every record this process holds
            if self._jf is not None:
                with contextlib.suppress(OSError):
                    self._jf.flush()
                self._since_flush = 0
            with _dir_lock(self.dir) as locked:
                if not locked and len(_journal_files(self.dir)) > 1:
                    # no cross-process lock available and other writers
                    # exist: an unlocked fold racing their compaction
                    # could overwrite records. Correctness beats bounds —
                    # leave the journal growing; single-writer
                    # directories still compact (the pre-multi-writer
                    # behavior, which needed no lock)
                    return
                profiles, hists, jseqs, _skipped, _lines = _read_dir(self.dir)
                # own jseq stays monotone even when a record was absorbed
                # in memory but never journaled (full/readonly volume)
                jseqs[self.writer_id] = max(
                    jseqs.get(self.writer_id, 0), self._rec_seq
                )
                # jseq entries whose journal file is ALREADY gone (reaped
                # by an earlier compaction) have nothing left to dedup —
                # drop them so dead pids don't accumulate in the snapshot
                on_disk = {w for w, _p in _journal_files(self.dir)}
                jseqs = {
                    w: s for w, s in jseqs.items()
                    if w in on_disk or w == self.writer_id
                }
                tmp = self.snapshot_path + ".tmp"
                try:
                    with open(tmp, "w") as f:
                        json.dump(
                            {"v": 2, "jseqs": jseqs,
                             "profiles": {
                                 fp: {k: v for k, v in p.items()
                                      if not k.startswith("_")}
                                 for fp, p in profiles.items()
                             },
                             "hists": hists},
                            f, separators=(",", ":"),
                        )
                    os.replace(tmp, self.snapshot_path)
                    if self._jf is not None:
                        self._jf.close()
                        self._jf = None
                    open(self.journal_path, "w").close()
                    # reap DEAD writers' journals: their records are all
                    # in the snapshot just renamed (the fold read them)
                    # and a dead pid can never append again — without
                    # this, every short-lived process sharing the
                    # directory leaves a file each load/compact must
                    # re-parse forever. Live or unverifiable writers
                    # (non-pid test ids, the legacy '' writer) are left
                    # alone: unlinking a file a live writer holds open
                    # would silently orphan its future appends.
                    self._reap_dead_journals()
                except OSError:
                    with contextlib.suppress(OSError):
                        os.unlink(tmp)
                    return
            # adopt the merged view (includes concurrent writers' records)
            from ..plan import feedback as _fb

            self.profiles = profiles
            self.hists = hists
            self._jseqs = jseqs
            self._seq = max(
                [p.get("seq", 0) for p in profiles.values()] + [0]
            )
            self._jlines = 0
            self._since_flush = 0
            for p in self.profiles.values():
                p["_dec"] = _fb.effective_decisions(p)

    def _evict(self) -> None:
        _evict_caps(self.profiles, self.hists)

    def _reap_dead_journals(self) -> None:
        """Unlink journals of writers that are provably dead (numeric
        pid, ``os.kill(pid, 0)`` fails). Called under the compaction
        flock, right after the merged snapshot rename — every record the
        file held is durable in the snapshot, and the owner can never
        append again. The stale ``jseqs`` entry is dropped by the NEXT
        compaction (it keys on the file's absence), so a crash between
        the rename and this unlink still dedups correctly."""
        for writer, path in _journal_files(self.dir):
            if writer == self.writer_id or not writer.isdigit():
                continue
            try:
                os.kill(int(writer), 0)
                continue  # alive (or a recycled pid): never touch it
            except ProcessLookupError:
                pass
            except OSError:
                continue  # no permission to signal: assume alive
            with contextlib.suppress(OSError):
                os.unlink(path)

    def close(self) -> None:
        with self._lock:
            if self._jf is not None:
                with contextlib.suppress(OSError):
                    self._jf.close()
                self._jf = None

    # -- absorption ----------------------------------------------------
    def _absorb(self, rec: Dict[str, Any]) -> None:
        """Fold one live record into this store's state (the shared
        :func:`_absorb_record` fold plus on-the-fly cap eviction)."""
        self._seq = _absorb_record(self.profiles, self.hists, rec, self._seq)
        if len(self.profiles) > PROFILE_CAP or len(self.hists) > HIST_CAP:
            self._evict()

    # -- read side ------------------------------------------------------
    def dec_tuple(self, fp: str) -> Optional[tuple]:
        """The profile's cached effective-decision tuple (Decisions field
        order): a lock-free read for the fingerprint hot path; None when
        the fingerprint has no profile yet."""
        p = self.profiles.get(fp)
        if p is None:
            return None
        return p.get("_dec")

    def profile_snapshot(self, fp: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            p = self.profiles.get(fp)
            if p is None:
                return None
            return json.loads(json.dumps(
                {k: v for k, v in p.items() if not k.startswith("_")}))

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """{fingerprint: flat profile summary}."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for fp, p in self.profiles.items():
                lat = p["lat"]
                out[fp] = {
                    "n": p["n"],
                    "lat_n": lat["n"],
                    "p50_ms": lat_quantile(lat, 0.50) * 1e3,
                    "p99_ms": lat_quantile(lat, 0.99) * 1e3,
                    "mean_sel": (
                        p["sel_sum"] / p["sel_n"] if p["sel_n"] else None
                    ),
                    "bytes_per_row": p["row_bytes"] or None,
                    "coll_mb_mean": (
                        p["coll_sum"] / p["n"] / 1e6 if p["n"] else 0.0
                    ),
                    "hot": p["hot"],
                    "staged_max": p["staged_max"],
                    "tier_max": p["tier_max"],
                    "strag_mean": (
                        round(
                            p.get("strag_sum", 0.0) / p["strag_n"], 2
                        )
                        if p.get("strag_n") else None
                    ),
                    "stages": {
                        stage: {
                            "count": a[0],
                            "ms": round(a[1], 3),
                            "straggler": round(a[2], 2),
                        }
                        for stage, a in sorted(
                            p.get("stages", {}).items(),
                            key=lambda kv: -kv[1][1],
                        )
                    },
                    "foot_n": p.get("foot", {}).get("n", 0),
                    "foot_p95": int(
                        lat_quantile(p.get("foot") or _new_lat(), 0.95)
                    ),
                    "serve_b": dict(p.get("serve_b", {})),
                    "dec": {k: v for k, v in p.get("dec", {}).items() if v is not None},
                    "flips": p.get("flips", 0),
                    "nodes": {
                        name: {
                            "count": a[0],
                            "wall_ms": round(a[1], 3),
                            "rows": a[2],
                            "coll_mb": round(a[3] / 1e6, 3),
                        }
                        for name, a in sorted(
                            p["nodes"].items(), key=lambda kv: -kv[1][1]
                        )
                    },
                }
        return out


# ----------------------------------------------------------------------
# the execution-observation context (one per plan execution)
# ----------------------------------------------------------------------
_EXEC: "ContextVar[Optional[Dict[str, Any]]]" = ContextVar(
    "cylon_tpu_obs_exec", default=None
)


@contextlib.contextmanager
def exec_obs(obs_key: Optional[str]):
    """Collect one plan execution's gate observations under ``obs_key``
    (the base-fingerprint key) and journal them on exit. No-op (and
    allocation-free on the note side) when the store is disabled."""
    s = store()
    if s is None or not obs_key:
        yield None
        return
    rec: Dict[str, Any] = {"k": "exec", "fp": obs_key}
    token = _EXEC.set(rec)
    try:
        yield rec
    finally:
        _EXEC.reset(token)
        s.record(rec)


def recording() -> bool:
    """Is an execution record open here? The gate a call site reads
    before it computes a note's arguments."""
    return _EXEC.get() is not None


def note_shuffle(
    world: int,
    row_bytes: int,
    hot: int,
    mean_bucket: int,
    staged: int,
    tier: int,
    rounds: int,
    coll: int,
    budget: int,
    static_budget: int = 0,
    wire: bool = False,
    relay: bool = False,
    topo: Optional[tuple] = None,
    hop2: bool = False,
    intra: int = 0,
    inter: int = 0,
    inter_alt: int = -1,
) -> None:
    """Fold one shuffle's planner measurements into the active exec
    record (table._shuffle_many phase 1 — data the host already holds).

    ``topo``/``hop2``/``intra``/``inter`` carry the 2-D topology
    evidence (parallel/topo.py): the declared (outer, inner) shape,
    whether the two-hop decomposition ran, and the exact per-axis
    collective bytes it shipped. ``inter_alt`` is the OTHER hop mode's
    modeled cross-outer bytes for the same plan (both formulas are
    host-exact), so a hop-mode proposer can compare the modes on every
    observation regardless of which one ran; -1 = no topology, no
    evidence."""
    rec = _EXEC.get()
    if rec is None:
        return
    rec["world"] = int(world)
    rec["row_bytes"] = int(row_bytes)
    rec["hot"] = max(rec.get("hot", 0), int(hot))
    rec["mean_bucket"] = int(mean_bucket)
    rec["staged"] = max(rec.get("staged", 0), int(staged))
    rec["tier"] = max(rec.get("tier", 0), int(tier))
    rec["rounds"] = rec.get("rounds", 0) + int(rounds)
    rec["coll"] = rec.get("coll", 0) + int(coll)
    rec["budget"] = int(budget)
    if static_budget:
        rec["static_budget"] = int(static_budget)
    if wire:
        rec["wire"] = True
    if relay:
        rec["relay"] = True
    if topo is not None:
        rec["topo"] = list(topo)
        rec["hop2"] = bool(hop2)
        rec["intra"] = rec.get("intra", 0) + int(intra)
        rec["inter"] = rec.get("inter", 0) + int(inter)
        if inter_alt >= 0:
            rec["inter_alt"] = rec.get("inter_alt", 0) + int(inter_alt)


def note_semi(
    sel: Optional[float] = None,
    built: bool = False,
    payoff_skip: bool = False,
) -> None:
    """Record a semi-filter observation on the active exec record:
    measured selectivity (from the count pass), a sketch build, or the
    static size gate declining."""
    rec = _EXEC.get()
    if rec is None:
        return
    if sel is not None:
        rec.setdefault("sel", []).append(round(float(sel), 4))
    if built:
        rec["sketch_built"] = rec.get("sketch_built", 0) + 1
    if payoff_skip:
        rec["payoff_skip"] = rec.get("payoff_skip", 0) + 1


def note_stages(stages: Dict[str, tuple]) -> None:
    """Fold one profiled execution's stage clocks into the active exec
    record (obs/prof.py — seconds and ratios the profiler already
    derived on the host): per-stage ``[ms_sum, straggler_max]`` plus the
    record-level ``strag`` (the max per-stage max/mean shard-time
    ratio). Contextvar + dict math only."""
    rec = _EXEC.get()
    if rec is None or not stages:
        return
    d = rec.setdefault("stg", {})
    worst = rec.get("strag", 0.0)
    for stage, (sec, ratio) in stages.items():
        e = d.setdefault(stage, [0.0, 0.0])
        e[0] = round(e[0] + float(sec) * 1e3, 3)
        e[1] = max(e[1], round(float(ratio), 3))
        worst = max(worst, float(ratio))
    rec["strag"] = round(worst, 3)


def note_sort(
    impl: str, sec: float, passes: int, alt_passes: int
) -> None:
    """Fold one sort's evidence into the active exec record: its host
    wall seconds under ``impl`` (the port's one engine, ``radix``: kernel
    K1) and its pass count (``alt_passes``: what another engine would
    have paid, 0 where there is none). Contextvar + dict math only."""
    rec = _EXEC.get()
    if rec is None:
        return
    ev = rec.setdefault("sort", {}).setdefault(impl, [0, 0.0, 0, 0])
    ev[0] += 1
    ev[1] = round(ev[1] + float(sec) * 1e3, 3)
    ev[2] += int(passes)
    ev[3] += int(alt_passes)


def note_codec(
    impl: str, sec: float, passes: int, alt_passes: int
) -> None:
    """Fold one shuffle round's codec evidence into the active exec
    record: pack + compact host wall seconds under ``impl`` (the port's
    kernels B2a/B2b and B3, ``cuda``, or their plain versions on the CPU,
    ``plain``) and the row passes they make. Contextvar + dict math
    only."""
    rec = _EXEC.get()
    if rec is None:
        return
    ev = rec.setdefault("codec", {}).setdefault(impl, [0, 0.0, 0, 0])
    ev[0] += 1
    ev[1] = round(ev[1] + float(sec) * 1e3, 3)
    ev[2] += int(passes)
    ev[3] += int(alt_passes)


def note_dev_bytes(n: int) -> None:
    """Fold device bytes the resource ledger attributed to the active
    plan execution into its exec record: the per-fingerprint FOOTPRINT
    evidence. Pure contextvar + dict math; the bytes were already
    host-known."""
    if not n:
        return
    rec = _EXEC.get()
    if rec is None:
        return
    rec["dev"] = rec.get("dev", 0) + int(n)


def note_batch_queries(qn: int) -> None:
    """Stamp the active exec record with the number of queries a batched
    execution served, so its footprint absorbs as per-query bytes."""
    rec = _EXEC.get()
    if rec is not None:
        rec["qn"] = int(qn)


def observe_latency(obs_key: Optional[str], seconds: float,
                    batch_b: Optional[int] = None) -> None:
    """Journal one resolved query latency (called from
    ``obs.trace.attach_result``; file I/O only, never a sync). A served
    query carries its batch size ``batch_b``, the serve-bucket proposer's
    evidence."""
    if not obs_key:
        return
    s = store()
    if s is None:
        return
    rec: Dict[str, Any] = {"k": "lat", "fp": obs_key, "s": round(seconds, 6)}
    if batch_b:
        rec["b"] = int(batch_b)
    s.record(rec)


def record_trace(q) -> None:
    """Journal a finished query trace's per-node wall/rows/coll bytes
    (called from obs.trace._maybe_finish when tracing is active)."""
    obs_key = getattr(q, "obs_key", None)
    if not obs_key:
        return
    s = store()
    if s is None:
        return
    nodes: List[list] = []
    for sp in q.all_spans():
        if sp.name.startswith("plan.node."):
            nodes.append([
                sp.name[len("plan.node."):],
                round(sp.dur_s() * 1e3, 3),
                int(sp.attrs.get("rows_out") or 0),
                int(sp.attrs.get("coll_bytes") or 0),
            ])
    if nodes:
        s.record({"k": "trace", "fp": obs_key, "nodes": nodes})


def absorb_histogram(key: str, hist, label: str = "") -> None:
    """Flush an in-process latency histogram evicted by the bounded
    registry (obs.metrics) into the store, so eviction never loses an
    observation."""
    s = store()
    if s is None:
        return
    s.record({
        "k": "hist", "key": key, "label": label,
        "b": {str(b): c for b, c in hist.buckets.items()},
        "n": hist.n, "total": round(hist.total_s, 6),
        "min": None if hist.n == 0 else hist.min_s, "max": hist.max_s,
    })
