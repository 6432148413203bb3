"""Chrome trace-event JSON export (Perfetto-loadable) and trace analysis: a
copy of the JAX package's ``obs/export.py``, stdlib only.

``write_chrome_trace`` turns :class:`~repro_torch.obs.tracer.SpanTracer`
records into the Chrome trace-event format (`ph`/`ts`/`dur`/`pid`/`tid`
in microseconds) that https://ui.perfetto.dev and chrome://tracing load
directly. Each tracer *track* (draft worker, refine dispatch, scoring
pre-pass, flush decisions, admission, terminal) becomes its own named
thread row; per-request flow arrows (`ph` s/t/f bound by ``id``) connect
admission through packing to the terminal status.

``stage_breakdown`` summarises the spans by track and name;
``validate_trace`` checks the schema and that every request's chain runs
from admission to its terminal event.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.obs.tracer import NullTracer, SpanRecord, SpanTracer

__all__ = [
    "to_trace_events",
    "write_chrome_trace",
    "load_trace",
    "stage_breakdown",
    "validate_trace",
]

PID = 1  # single-process serve; tracks map to tids

# Stable tid order so Perfetto rows come out in pipeline order.
_KNOWN_TRACKS = (
    "admission",
    "scoring",
    "draft_worker",
    "refine_dispatch",
    "flush",
    "terminal",
)


def _track_tids(records: Sequence[SpanRecord]) -> Dict[str, int]:
    tids: Dict[str, int] = {}
    for t in _KNOWN_TRACKS:
        tids[t] = len(tids) + 1
    for r in records:
        if r.track not in tids:
            tids[r.track] = len(tids) + 1
    # Only keep tracks that actually appear, preserving assigned ids.
    seen = {r.track for r in records}
    return {t: tid for t, tid in tids.items() if t in seen}


def to_trace_events(records: Sequence[SpanRecord]) -> List[Dict[str, Any]]:
    """Records -> Chrome trace-event dicts (ts/dur in microseconds)."""
    tids = _track_tids(records)
    events: List[Dict[str, Any]] = []
    for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": PID,
                "tid": tid,
                "args": {"name": track},
            }
        )
    for r in records:
        tid = tids[r.track]
        ev: Dict[str, Any] = {
            "ph": r.ph,
            "name": r.name,
            "cat": r.track,
            "pid": PID,
            "tid": tid,
            "ts": r.ts * 1e6,
            "args": dict(r.args),
        }
        if r.ph == "X":
            ev["dur"] = r.dur * 1e6
        elif r.ph == "i":
            ev["s"] = "t"  # thread-scoped instant
        events.append(ev)
        if r.flow_id is not None and r.flow_ph in ("s", "t", "f"):
            flow: Dict[str, Any] = {
                "ph": r.flow_ph,
                "name": "request",
                "cat": "request",
                "id": r.flow_id,
                "pid": PID,
                "tid": tid,
                "ts": r.ts * 1e6,
            }
            if r.flow_ph == "f":
                flow["bp"] = "e"  # bind to enclosing slice
            events.append(flow)
    return events


TracerOrRecords = Union[SpanTracer, NullTracer, Sequence[SpanRecord]]


def _records_of(src: TracerOrRecords) -> List[SpanRecord]:
    if hasattr(src, "records"):
        return list(src.records())  # type: ignore[union-attr]
    return list(src)  # type: ignore[arg-type]


def write_chrome_trace(
    path: str,
    tracer_or_records: TracerOrRecords,
    metadata: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Write a ``{"traceEvents": [...]}`` JSON file; returns the dict."""
    records = _records_of(tracer_or_records)
    doc: Dict[str, Any] = {
        "traceEvents": to_trace_events(records),
        "displayTimeUnit": "ms",
    }
    if metadata:
        doc["otherData"] = dict(metadata)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def stage_breakdown(
    trace_or_events: Union[Dict[str, Any], Iterable[Dict[str, Any]]],
) -> List[Dict[str, Any]]:
    """Per-(track, span) time breakdown from ``"X"`` events.

    Returns rows sorted by total time descending:
    ``{"track", "name", "count", "total_ms", "mean_ms", "max_ms"}``.
    """
    events = (
        trace_or_events.get("traceEvents", [])
        if isinstance(trace_or_events, dict)
        else list(trace_or_events)
    )
    agg: Dict[tuple, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        key = (ev.get("cat", ""), ev.get("name", ""))
        row = agg.setdefault(
            key,
            {"track": key[0], "name": key[1], "count": 0, "total_ms": 0.0, "max_ms": 0.0},
        )
        dur_ms = float(ev.get("dur", 0.0)) / 1e3
        row["count"] += 1
        row["total_ms"] += dur_ms
        row["max_ms"] = max(row["max_ms"], dur_ms)
    rows = sorted(agg.values(), key=lambda r: -r["total_ms"])
    for r in rows:
        r["mean_ms"] = r["total_ms"] / r["count"] if r["count"] else 0.0
    return rows


def validate_trace(
    trace: Dict[str, Any],
    expected_requests: Optional[int] = None,
) -> List[str]:
    """Structural checks; returns a list of problems (empty = valid).

    Checks the trace-event schema (ph/ts/pid/tid present, X events carry
    dur, flow s/f events pair up by id) and — the acceptance criterion —
    that every request's span chain runs admission→terminal: each
    ``request_admitted`` instant has a matching ``request_terminal``
    with the same ``request_id``, and vice versa. With
    ``expected_requests`` set, the chain count must match the ledger.
    """
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]

    flow_starts: Dict[Any, int] = {}
    flow_finishes: Dict[Any, int] = {}
    admitted: Dict[Any, Dict[str, Any]] = {}
    terminal: Dict[Any, Dict[str, Any]] = {}

    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None:
            problems.append(f"event {i}: missing ph")
            continue
        for field in ("pid", "tid"):
            if field not in ev:
                problems.append(f"event {i} ({ph} {ev.get('name')}): missing {field}")
        if ph != "M" and "ts" not in ev:
            problems.append(f"event {i} ({ph} {ev.get('name')}): missing ts")
        if ph == "X":
            if "dur" not in ev:
                problems.append(f"event {i} (X {ev.get('name')}): missing dur")
            elif float(ev["dur"]) < 0:
                problems.append(f"event {i} (X {ev.get('name')}): negative dur")
        if ph in ("s", "t", "f") and "id" not in ev:
            problems.append(f"event {i} (flow {ph}): missing id")
        if ph == "s":
            flow_starts[ev.get("id")] = flow_starts.get(ev.get("id"), 0) + 1
        elif ph == "f":
            flow_finishes[ev.get("id")] = flow_finishes.get(ev.get("id"), 0) + 1
        name = ev.get("name")
        if name == "request_admitted":
            rid = ev.get("args", {}).get("request_id")
            admitted[rid] = ev
        elif name == "request_terminal":
            rid = ev.get("args", {}).get("request_id")
            terminal[rid] = ev

    for fid, n in flow_starts.items():
        if flow_finishes.get(fid, 0) == 0:
            problems.append(f"flow id {fid}: start without finish")
    for fid in flow_finishes:
        if fid not in flow_starts:
            problems.append(f"flow id {fid}: finish without start")

    for rid in admitted:
        if rid not in terminal:
            problems.append(f"request {rid}: admitted but no terminal event")
    for rid in terminal:
        if rid not in admitted:
            problems.append(f"request {rid}: terminal but no admission event")

    if expected_requests is not None:
        chains = len(set(admitted) & set(terminal))
        if chains != expected_requests:
            problems.append(
                f"admission->terminal chains {chains} != expected requests {expected_requests}"
            )
    return problems
