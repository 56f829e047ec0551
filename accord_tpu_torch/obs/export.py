"""Export FlightRecorder events as Chrome trace_event JSON.

The emitted file loads directly in Perfetto (https://ui.perfetto.dev) or
chrome://tracing: one process per node (pid = node id), one named thread
per track (``txn``, ``net``, ``stage_host``, ``device``, ``deltas``, ...),
txn lifecycle rendered as async spans with flow arrows linking the
coordinator slice to replica status transitions and device dispatches.

Also a tiny CLI::

    python -m accord_tpu_torch.obs.export --summarize trace.json

prints a per-stage time breakdown (span counts, total/mean duration) so a
trace can be read without a UI.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional, Tuple

# Stable thread ordering inside each node's process row; unknown tracks
# sort after these, alphabetically.
_TRACK_ORDER = ("txn", "net", "stage_host", "device", "exec", "deltas")


def _track_key(tid: str) -> Tuple[int, str]:
    try:
        return (_TRACK_ORDER.index(tid), tid)
    except ValueError:
        return (len(_TRACK_ORDER), tid)


def to_chrome_trace(events: Iterable[dict]) -> dict:
    """Convert recorder events into a ``{"traceEvents": [...]}`` document.

    Recorder events carry string track names in ``tid``; Chrome wants
    integer thread ids, so tracks are numbered per-process (in
    `_TRACK_ORDER`) and named via ``thread_name`` metadata. Events are
    stably sorted by timestamp so per-track ``ts`` is monotone while
    same-ts events keep their recorded order.
    """
    evs = list(events)
    tracks: Dict[Tuple[int, str], int] = {}
    for ev in evs:
        key = (ev["pid"], ev["tid"])
        if key not in tracks:
            tracks[key] = 0  # numbered below, once all tracks are known

    pids = sorted({pid for pid, _ in tracks})
    out: List[dict] = []
    for pid in pids:
        out.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                    "args": {"name": f"node {pid}"}})
        names = sorted((t for p, t in tracks if p == pid), key=_track_key)
        for i, tname in enumerate(names):
            tracks[(pid, tname)] = i
            out.append({"ph": "M", "pid": pid, "tid": i,
                        "name": "thread_name", "args": {"name": tname}})
            out.append({"ph": "M", "pid": pid, "tid": i,
                        "name": "thread_sort_index",
                        "args": {"sort_index": i}})

    body = []
    for ev in evs:
        ev = dict(ev)
        ev["tid"] = tracks[(ev["pid"], ev.pop("tid"))]
        body.append(ev)
    body.sort(key=lambda e: e["ts"])
    out.extend(body)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_trace(path: str, events: Iterable[dict]) -> dict:
    doc = to_chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    return doc


# -- summarize ---------------------------------------------------------------

def summarize(doc: dict) -> dict:
    """Per-stage breakdown of a trace document (or raw recorder events).

    Complete (X) spans aggregate by name: count + total/mean wall dur.
    Async (b/e) spans match begin/end the way the trace viewer does --
    global ids by (cat, id), process-local ids (``id2.local``) by
    (pid, cat, id) -- and aggregate the timestamp delta by name.
    Instants aggregate counts only.
    """
    events = doc["traceEvents"] if isinstance(doc, dict) else list(doc)
    spans: Dict[str, Dict[str, float]] = {}
    instants: Dict[str, int] = {}
    open_async: Dict[tuple, float] = {}

    def span(name: str, dur: float) -> None:
        s = spans.setdefault(name, {"count": 0, "total_us": 0.0})
        s["count"] += 1
        s["total_us"] += dur

    def async_key(ev: dict) -> tuple:
        local = ev.get("id2", {}).get("local")
        if local is not None:
            return (ev["pid"], ev.get("cat", ""), str(local), ev["name"])
        return (ev.get("cat", ""), str(ev.get("id")), ev["name"])

    for ev in events:
        ph = ev.get("ph")
        if ph == "X":
            span(ev["name"], float(ev.get("dur", 0)))
        elif ph == "i":
            instants[ev["name"]] = instants.get(ev["name"], 0) + 1
        elif ph == "b":
            open_async[async_key(ev)] = float(ev["ts"])
        elif ph == "e":
            t0 = open_async.pop(async_key(ev), None)
            if t0 is not None:
                span(ev["name"], float(ev["ts"]) - t0)
    for s in spans.values():
        s["mean_us"] = round(s["total_us"] / s["count"], 3) if s["count"] else 0.0
        s["total_us"] = round(s["total_us"], 3)
    return {"spans": spans, "instants": instants,
            "unclosed_async": len(open_async)}


def format_summary(summary: dict) -> str:
    lines = [f"{'span':<24}{'count':>10}{'total_us':>16}{'mean_us':>12}"]
    for name in sorted(summary["spans"],
                       key=lambda n: -summary["spans"][n]["total_us"]):
        s = summary["spans"][name]
        lines.append(f"{name:<24}{s['count']:>10}{s['total_us']:>16.1f}"
                     f"{s['mean_us']:>12.3f}")
    if summary["instants"]:
        lines.append("")
        lines.append(f"{'instant':<24}{'count':>10}")
        for name in sorted(summary["instants"],
                           key=lambda n: -summary["instants"][n]):
            lines.append(f"{name:<24}{summary['instants'][name]:>10}")
    if summary.get("unclosed_async"):
        lines.append("")
        lines.append(f"unclosed async spans: {summary['unclosed_async']}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m accord_tpu_torch.obs.export",
        description="Summarize a recorded Perfetto trace.")
    ap.add_argument("--summarize", metavar="TRACE_JSON", required=True,
                    help="path to a trace written by bench.py --trace")
    ns = ap.parse_args(argv)
    with open(ns.summarize) as f:
        doc = json.load(f)
    print(format_summary(summarize(doc)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
