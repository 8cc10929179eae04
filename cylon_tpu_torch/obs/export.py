"""Exporters: the flight-recorder ring, Chrome trace-event JSON, and the
live ops endpoint (counterpart of cylon_tpu/obs/export.py).

FLIGHT RING
    A bounded deque of the last N finished :class:`~.trace.QueryTrace`
    objects (``CYLON_TPU_TORCH_TRACE_RING`` caps N, default 64): the
    "what just happened" buffer of a serving process.

CHROME TRACE
    :func:`write_chrome` renders traces as Chrome trace-event JSON (the
    ``traceEvents`` array form), loadable in Perfetto or
    ``chrome://tracing``. One track (tid) per query; spans are complete
    ("X") events carrying rows, collective bytes and gate counters in
    ``args``, and on a card ``device_ms`` from the span's CUDA events
    (waited for here, at export, never on the query's path). Timestamps
    are microseconds on the shared ``perf_counter`` clock.

``CYLON_TPU_TORCH_TRACE_EXPORT=<path>`` writes the ring to ``<path>`` at
interpreter exit (registered on the first recorded trace).

OPS ENDPOINT
    :class:`OpsServer`, a stdlib ``ThreadingHTTPServer`` on loopback that
    context init starts when ``CYLON_TPU_TORCH_METRICS_PORT`` is set
    (:func:`ensure_ops_server`):

    - ``/metrics``: Prometheus text exposition (version 0.0.4) of the
      rollup, the per-fingerprint latency quantiles, the resource
      ledger's device/host/disk/lease watermarks and the SLO rule states;
    - ``/healthz``: 200 while no SLO rule (obs/slo.py) is in BREACH, 503
      otherwise, with the breached rules as ``reasons``;
    - ``/queries``: the flight-recorder ring as JSON.

    Every request is host dict work; a scrape never touches a device.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

from ..utils import envgate as _eg

_ring_lock = threading.Lock()
_RING: "deque" = deque()
_ATEXIT = [False]  # guarded by _ring_lock


def ring_capacity() -> int:
    """Flight-ring capacity from CYLON_TPU_TORCH_TRACE_RING (>=1; default 64).
    Read per record so a serving process can resize without restart."""
    raw = _eg.TRACE_RING.get()
    try:
        n = int(raw)
    except ValueError:
        n = 64
    return max(n, 1)


def record(q) -> None:
    """Append a finished QueryTrace to the ring (evicting the oldest past
    capacity) and lazily register the exit exporter."""
    cap = ring_capacity()
    with _ring_lock:
        _RING.append(q)
        while len(_RING) > cap:
            _RING.popleft()
        if not _ATEXIT[0]:
            _ATEXIT[0] = True
            atexit.register(_export_at_exit)


def traces() -> List:
    """Snapshot of the ring, oldest first."""
    with _ring_lock:
        return list(_RING)


def reset_ring() -> None:
    with _ring_lock:
        _RING.clear()


def _export_at_exit() -> None:  # pragma: no cover - exit hook
    path = _eg.TRACE_EXPORT.get()
    if not path:
        return
    try:
        write_chrome(path)
    except Exception as e:
        import sys

        print(f"[cylon_tpu_torch] trace export to {path} failed: {e}",
              file=sys.stderr)


# ----------------------------------------------------------------------
# Chrome trace-event rendering
# ----------------------------------------------------------------------
def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def _span_args(sp) -> Dict:
    args: Dict = {}
    if sp.rows is not None:
        args["rows"] = int(sp.rows)
    dev = sp.device_ms(wait=True)
    if dev is not None:
        args["device_ms"] = round(dev, 6)
    for k, v in sp.attrs.items():
        args[k] = _json_safe(v)
    for name, (count, rows) in sp.counters.items():
        args[f"ctr:{name}"] = count if not rows else [count, rows]
    return args


def chrome_events(trace_list: Optional[List] = None) -> List[Dict]:
    """The traceEvents array: per query one thread_name metadata event,
    one query-level "X" event, and one "X" event per span."""
    if trace_list is None:
        trace_list = traces()
    pid = os.getpid()
    events: List[Dict] = []
    for q in trace_list:
        tid = q.qid
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": f"{q.kind}:{q.name} #{q.qid}"},
        })
        qargs: Dict = {"kind": q.kind, "thread": q.thread}
        if q.hist_key:
            qargs["fingerprint"] = q.hist_key
        dev = q.device_resolved_s()
        if dev is not None:
            qargs["device_resolved_ms"] = round(dev * 1e3, 3)
        dev_ms = q.device_ms(wait=True)
        if dev_ms is not None:
            qargs["device_ms"] = round(dev_ms, 6)
        for k, v in q.attrs.items():
            if k.startswith("__"):
                continue  # structured carriers (e.g. prof profiles)
            qargs[k] = _json_safe(v)
        for name, (count, rows) in q.counters.items():
            qargs[f"ctr:{name}"] = count if not rows else [count, rows]
        events.append({
            "ph": "X", "name": f"query:{q.name}", "cat": q.kind,
            "pid": pid, "tid": tid, "ts": q.t0 * 1e6,
            "dur": max(q.wall_s() * 1e6, 0.0), "args": qargs,
        })
        for root in q.spans:
            for sp in root.walk():
                events.append({
                    "ph": "X", "name": sp.name, "cat": "span",
                    "pid": pid, "tid": tid, "ts": sp.t0 * 1e6,
                    "dur": max(sp.dur_s() * 1e6, 0.0),
                    "args": _span_args(sp),
                })
        events.extend(_prof_events(q, pid))
    return events


def _prof_events(q, pid: int) -> List[Dict]:
    """Per-shard stage tracks of a profiled query: each attached
    StageProfile (obs/prof.py) renders one track per shard —
    tid ``"<qid>/s<shard>"`` — with one complete event per stage, laid
    out in pipeline order inside the profile's measured device window.
    Stage boundaries within the window are apportioned (the engine never
    synced per stage — that is the point); the per-shard DURATIONS are
    the stage clocks, so a straggler shard reads directly off the
    timeline in Perfetto."""
    from . import prof as _prof_mod

    profiles = q.attrs.get(_prof_mod.PROF_ATTR) or []
    events: List[Dict] = []
    named = set()
    for pi, p in enumerate(profiles):
        shard_secs = p.shard_seconds(wait=True)
        if not shard_secs:
            continue  # window never resolved
        secs = p.seconds(wait=True)
        cursor = p.t0
        for stage in _prof_mod.STAGE_ORDER:
            if stage not in shard_secs:
                continue
            per_shard = shard_secs[stage]
            for s, dur in enumerate(per_shard):
                tid = f"{q.qid}/s{s}"
                if tid not in named:
                    named.add(tid)
                    events.append({
                        "ph": "M", "name": "thread_name", "cat": "prof",
                        "pid": pid, "tid": tid,
                        "args": {
                            "name": f"shard {s} stage clocks #{q.qid}"
                        },
                    })
                events.append({
                    "ph": "X", "name": f"prof.{stage}", "cat": "prof",
                    "pid": pid, "tid": tid, "ts": cursor * 1e6,
                    "dur": max(float(dur) * 1e6, 0.0),
                    "args": {
                        "shard": s, "kind": p.kind, "profile": pi,
                        "straggler_ratio": round(
                            p.stragglers().get(stage, 1.0), 3
                        ),
                    },
                })
            cursor += secs.get(stage, 0.0)
    return events


def chrome_doc(trace_list: Optional[List] = None) -> Dict:
    return {
        "traceEvents": chrome_events(trace_list),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "cylon_tpu_torch.obs"},
    }


def write_chrome(path: str, trace_list: Optional[List] = None) -> int:
    """Write the Chrome trace JSON; returns the event count."""
    doc = chrome_doc(trace_list)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


def load_chrome(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def validate_chrome(doc: Dict) -> List[str]:
    """Schema-check a Chrome trace document (the trace-smoke CI gate and
    the round-trip test both run this). Returns problem strings."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents: missing or not a list"]
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        for k in ("ph", "name", "pid", "tid"):
            if k not in e:
                problems.append(f"event {i}: missing {k!r}")
        if e.get("ph") == "X":
            for k in ("ts", "dur"):
                if not isinstance(e.get(k), (int, float)):
                    problems.append(f"event {i}: X event needs numeric {k!r}")
        if "args" in e and not isinstance(e["args"], dict):
            problems.append(f"event {i}: args must be an object")
    return problems


def summarize(doc: Dict) -> Dict[int, Dict]:
    """Per-track (tid) summary of a Chrome trace doc: query name, wall
    ms, span count, and total-time-by-span-name (the round-trip
    assertions read it)."""
    tracks: Dict[int, Dict] = {}
    for e in doc.get("traceEvents", []):
        if e.get("cat") == "prof":
            continue  # per-shard stage tracks summarize separately
        tid = e.get("tid")
        t = tracks.setdefault(
            tid, {"name": "", "query_ms": 0.0, "spans": 0, "by_name": {}}
        )
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            t["name"] = e.get("args", {}).get("name", "")
        elif e.get("ph") == "X":
            if str(e.get("name", "")).startswith("query:"):
                t["query_ms"] = e["dur"] / 1e3
                t["args"] = e.get("args", {})
            else:
                t["spans"] += 1
                agg = t["by_name"].setdefault(e["name"], [0, 0.0])
                agg[0] += 1
                agg[1] += e["dur"] / 1e3
    return tracks


# ----------------------------------------------------------------------
# Prometheus text exposition (the /metrics substrate)
# ----------------------------------------------------------------------
def _prom_name(name: str) -> str:
    """Metric-name sanitization: dots and dashes become underscores; the
    result matches the exposition grammar ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    import re

    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_val(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text() -> str:
    """The whole observability stack as Prometheus text exposition
    (format version 0.0.4): rollup counters/spans/gauges (prefixed
    ``cylon_tpu_torch_``; spans render count + seconds-total, gauges
    render current value + ``_peak``), per-fingerprint latency quantile
    summaries, resource-ledger watermarks and SLO rule states. Pure host
    reads."""
    from . import metrics as _metrics
    from . import resource as _resource
    from . import slo as _slo

    lines: List[str] = []

    def fam(name, kind, help_text):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")

    # ---- the rollup: counters / spans / gauges -----------------------
    for raw, s in sorted(_metrics.snapshot().items()):
        if raw.startswith(("ledger.", "slo.state.")):
            # re-exposed by the dedicated ledger and SLO sections below
            # (with peaks, with rule labels): the rollup copies would
            # duplicate the family
            continue
        base = "cylon_tpu_torch_" + _prom_name(raw)
        if s.get("last") is not None:
            # gauge family (rollup_value writers): current + process peak
            fam(base, "gauge", f"gauge {raw} (cylon_tpu_torch rollup)")
            lines.append(f"{base} {_fmt_val(s['last'])}")
            fam(base + "_peak", "gauge", f"process peak of {raw}")
            lines.append(f"{base}_peak {_fmt_val(s['max_s'])}")
        elif s.get("total_s", 0.0) > 0.0:
            # span family: event count + total seconds
            fam(base + "_count", "counter", f"span count {raw}")
            lines.append(f"{base}_count {_fmt_val(s['count'])}")
            fam(base + "_seconds_total", "counter", f"span seconds {raw}")
            lines.append(f"{base}_seconds_total {_fmt_val(s['total_s'])}")
        else:
            fam(base + "_total", "counter", f"counter {raw}")
            lines.append(f"{base}_total {_fmt_val(s['count'])}")
            if s.get("rows"):
                fam(base + "_rows_total", "counter", f"rows of {raw}")
                lines.append(f"{base}_rows_total {_fmt_val(s['rows'])}")

    # ---- per-fingerprint latency quantiles (summary form) ------------
    rep = _metrics.latency_report()
    if rep:
        name = "cylon_tpu_torch_query_latency_seconds"
        fam(name, "summary",
            "per-plan-fingerprint query latency (collect to the result's "
            "host-known counts)")
        for key, q in sorted(rep.items()):
            lbl = f'fingerprint="{_prom_escape(key)}"'
            for quant, field in (("0.5", "p50_s"), ("0.95", "p95_s"),
                                 ("0.99", "p99_s")):
                lines.append(
                    f'{name}{{{lbl},quantile="{quant}"}} '
                    f"{_fmt_val(q[field])}"
                )
            lines.append(f"{name}_count{{{lbl}}} {_fmt_val(q['count'])}")
            lines.append(
                f"{name}_sum{{{lbl}}} "
                f"{_fmt_val(q['mean_s'] * q['count'])}"
            )

    # ---- resource-ledger watermarks ----------------------------------
    leds = _resource.ledgers()
    if leds:
        snaps = [led.snapshot() for led in leds]
        # device bytes are per-context (summed); host/disk arenas are
        # process-global (identical in every snapshot — take one)
        agg = {
            "device_bytes": sum(s["device_bytes"] for s in snaps),
            "device_peak_bytes": sum(s["device_peak"] for s in snaps),
            "live_tables": sum(s["live_tables"] for s in snaps),
            "host_bytes": snaps[0]["host_bytes"],
            "host_peak_bytes": snaps[0]["host_peak"],
            "disk_bytes": snaps[0]["disk_bytes"],
            "disk_peak_bytes": snaps[0]["disk_peak"],
            "serve_lease_bytes": sum(s["serve_lease_bytes"] for s in snaps),
            "serve_lease_count": sum(s["serve_lease_count"] for s in snaps),
            "leaked_tables": sum(len(led.leaks()) for led in leds),
        }
        for k, v in agg.items():
            name = f"cylon_tpu_torch_ledger_{k}"
            fam(name, "gauge", f"resource ledger: {k.replace('_', ' ')}")
            lines.append(f"{name} {_fmt_val(v)}")

    # ---- SLO rule states ---------------------------------------------
    states = _slo.state_gauges()
    if states:
        name = "cylon_tpu_torch_slo_state"
        fam(name, "gauge", "SLO rule state: 0=OK 1=WARN 2=BREACH")
        for rule, st in sorted(states.items()):
            lines.append(f'{name}{{rule="{_prom_escape(rule)}"}} {_fmt_val(st)}')

    return "\n".join(lines) + "\n"


def validate_prometheus(text: str) -> List[str]:
    """Strict line-format check of a text exposition (the ops-smoke CI
    gate parses every scraped line with this — no client library, no new
    deps). Returns problem strings; [] = clean."""
    import re

    name_re = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
    label_re = (
        r"\{" + name_re + r'="(?:\\.|[^"\\])*"'
        r"(?:," + name_re + r'="(?:\\.|[^"\\])*")*\}'
    )
    value_re = r"(?:[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))"
    sample = re.compile(
        f"^{name_re}(?:{label_re})? {value_re}(?: [-+]?[0-9]+)?$"
    )
    help_re = re.compile(f"^# HELP {name_re} .*$")
    type_re = re.compile(
        f"^# TYPE ({name_re}) (counter|gauge|summary|histogram|untyped)$"
    )
    problems: List[str] = []
    typed = set()
    for i, line in enumerate(text.split("\n"), 1):
        if not line:
            continue
        if line.startswith("# HELP "):
            if not help_re.match(line):
                problems.append(f"line {i}: malformed HELP: {line!r}")
        elif line.startswith("# TYPE "):
            m = type_re.match(line)
            if not m:
                problems.append(f"line {i}: malformed TYPE: {line!r}")
            elif m.group(1) in typed:
                problems.append(f"line {i}: duplicate TYPE for {m.group(1)}")
            else:
                typed.add(m.group(1))
        elif line.startswith("#"):
            continue  # comments are legal
        elif not sample.match(line):
            problems.append(f"line {i}: malformed sample: {line!r}")
    return problems


# ----------------------------------------------------------------------
# the flight ring as JSON (the /queries substrate)
# ----------------------------------------------------------------------
def queries_json(trace_list: Optional[List] = None) -> List[Dict]:
    """The ring, oldest first, as JSON-safe dicts: qid/kind/name/
    fingerprint/wall + device-resolved ms, attrs and counters."""
    if trace_list is None:
        trace_list = traces()
    out: List[Dict] = []
    for q in trace_list:
        dev = q.device_resolved_s()
        out.append({
            "qid": q.qid,
            "kind": q.kind,
            "name": q.name,
            "label": q.label,
            "fingerprint": q.hist_key,
            "wall_ms": round(q.wall_s() * 1e3, 3),
            "device_resolved_ms": (
                None if dev is None else round(dev * 1e3, 3)
            ),
            "thread": q.thread,
            "attrs": {
                k: _json_safe(v) for k, v in q.attrs.items()
                if not k.startswith("__")
            },
            "counters": {
                k: (c if not r else [c, r])
                for k, (c, r) in q.counters.items()
            },
        })
    return out


# ----------------------------------------------------------------------
# the stdlib HTTP ops server
# ----------------------------------------------------------------------
class OpsServer:
    """``/metrics`` + ``/healthz`` + ``/queries`` on a daemon thread.
    Stdlib-only (http.server); start() returns the bound port (pass 0
    for an ephemeral one, as the tests do). Binds
    LOOPBACK by default: the endpoint is unauthenticated and ``/queries``
    carries query labels/attrs, so exposing it beyond the host is an
    explicit operator decision (``CYLON_TPU_TORCH_METRICS_PORT=0.0.0.0:9100``)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._port = int(port)
        self._host = host
        self._httpd = None
        self._thread = None

    def start(self) -> int:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence per-request stderr
                pass

            def _reply(self, code, body, ctype):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                from . import slo as _slo

                try:
                    if path == "/metrics":
                        # a scrape drives the SLO evaluation cadence
                        _slo.monitor().evaluate()
                        self._reply(
                            200, prometheus_text(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        ok, reasons = _slo.monitor().healthy()
                        self._reply(200 if ok else 503,
                                    json.dumps({"ok": ok, "reasons": reasons}),
                                    "application/json")
                    elif path == "/queries":
                        self._reply(
                            200, json.dumps(queries_json()),
                            "application/json",
                        )
                    else:
                        self._reply(404, '{"error": "not found"}',
                                    "application/json")
                except ConnectionError:  # client went away mid-reply
                    pass                 # (reset or broken pipe)

        self._httpd = ThreadingHTTPServer(
            (self._host, self._port), _Handler
        )
        self._httpd.daemon_threads = True
        import threading as _threading

        self._thread = _threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="cylon-tpu-torch-opsd",
        )
        self._thread.start()
        self._port = self._httpd.server_address[1]
        return self._port

    @property
    def port(self) -> int:
        return self._port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


_ops_lock = threading.Lock()
_OPS_SERVER: List[Optional[OpsServer]] = [None]
_OPS_FAILED: List[Optional[str]] = [None]  # knob value whose bind failed


def ensure_ops_server() -> Optional[OpsServer]:
    """Start the process ops server when ``CYLON_TPU_TORCH_METRICS_PORT`` is
    set (idempotent; context init calls this). Returns the server, or
    None when the knob is unset. A failed bind (port in use) is reported
    once and does not fail context creation — observability must never
    take the engine down."""
    raw = _eg.METRICS_PORT.get()
    if not raw:
        return None
    with _ops_lock:
        if _OPS_SERVER[0] is not None:
            return _OPS_SERVER[0]
        if _OPS_FAILED[0] == raw:
            # this exact knob value already failed: report once, then
            # stay quiet — a worker pool creating many contexts must not
            # retry the bind and spam the error per context (a CHANGED
            # value retries)
            return None
        # "9100" binds loopback; "host:9100" (e.g. 0.0.0.0:9100) opts
        # into a wider bind for an off-host Prometheus scrape
        host, _, port_s = raw.rpartition(":")
        try:
            srv = (
                OpsServer(int(port_s), host=host) if host
                else OpsServer(int(raw))
            )
            srv.start()
        except (ValueError, OSError) as e:
            import sys

            _OPS_FAILED[0] = raw
            print(
                f"[cylon_tpu_torch] ops server on CYLON_TPU_TORCH_METRICS_PORT={raw} "
                f"failed: {e}", file=sys.stderr,
            )
            return None
        _OPS_FAILED[0] = None
        _OPS_SERVER[0] = srv
    return srv
