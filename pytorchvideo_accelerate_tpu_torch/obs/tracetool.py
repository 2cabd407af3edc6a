"""`pva-torch-trace`: merge trace rings and flight records into one timeline
(the port's copy of the JAX package's `obs/tracetool.py`; for the same
inputs its merged file and its summary line are the JAX tool's).

Each process of a run (the trainer's ranks, the servers) keeps its own
bounded trace ring (obs/trace.py, dumped as `trace_ring.json`, rank r > 0:
`trace_ring.rank<r>.json`) and its own flight recorder
(`flight_record.json`). Diagnosing a request that crossed processes needs
all of them on one wall-clock axis:

    pva-torch-trace --out merged.json run_a/trace_ring.json \\
        run_b/trace_ring.json run_a/flight_record.json

- trace rings (`{"traceEvents": [...]}`) merge verbatim: their events
  already carry wall-clock microsecond timestamps and the recording pid;
- flight records (`{"events": [...]}`) become Perfetto instant events
  (`ph: "i"`), so watchdog stalls, warnings and profile windows line up
  against the spans around them;
- the output is Chrome trace-event JSON sorted by timestamp: load it in
  Perfetto or chrome://tracing, or grep it for a `trace_id` from a
  latency-histogram exemplar or `/stats` `slowest_traces`.

The summary line (stdout) gives the event, trace and process counts and the
slowest root spans. Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

_FLIGHT_TID = 0  # flight-record events carry thread NAMES, not idents


def flight_to_events(record: dict) -> List[dict]:
    """Convert one flight-record dump into Perfetto instant events."""
    pid = record.get("pid", 0)
    out = []
    for evt in record.get("events", ()):
        args = {k: v for k, v in evt.items()
                if k not in ("ts", "kind", "name")}
        out.append({
            "name": f"{evt.get('kind', 'event')}:{evt.get('name', '?')}",
            "ph": "i",
            "s": "p",  # process-scoped instant
            "ts": round(float(evt.get("ts", 0.0)) * 1e6, 1),
            "pid": pid,
            "tid": _FLIGHT_TID,
            "args": args,
        })
    return out


def events_of(payload: dict) -> List[dict]:
    """Events from one parsed input, whichever shape it is."""
    if "traceEvents" in payload:
        return list(payload["traceEvents"])
    if "events" in payload:
        return flight_to_events(payload)
    raise ValueError(
        "input is neither a trace ring ('traceEvents') nor a flight "
        "record ('events')")


def merge_exports(payloads: Sequence[dict]) -> dict:
    """Merge already-parsed payloads into one timestamp-sorted timeline."""
    events: List[dict] = []
    for payload in payloads:
        events.extend(events_of(payload))
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def merge_paths(paths: Sequence[str]) -> dict:
    """Merge the readable inputs; unreadable/torn ones (a crash dump cut
    off mid-write is exactly the situation this tool serves) are skipped
    with a stderr warning. Raises only when NOTHING could be loaded."""
    payloads = []
    skipped = []
    for path in paths:
        try:
            with open(path) as f:
                payloads.append(json.load(f))
        except (OSError, ValueError) as e:
            skipped.append(path)
            print(f"pva-torch-trace: skipping {path}: {e}", file=sys.stderr)
    if not payloads:
        raise ValueError(
            f"no readable inputs among {list(paths)} "
            f"({len(skipped)} skipped)")
    return merge_exports(payloads)


def summarize(merged: dict, slowest: int = 5) -> dict:
    """Counts + slowest roots: the scriptable sanity check of a merge."""
    events = merged.get("traceEvents", [])
    traces: Dict[str, set] = {}
    roots: List[dict] = []
    for e in events:
        args = e.get("args", {})
        tid = args.get("trace_id")
        if tid:
            traces.setdefault(tid, set()).add(e.get("pid"))
            if "parent_id" not in args and e.get("ph") == "X":
                roots.append(e)
    roots.sort(key=lambda e: -float(e.get("dur", 0.0)))
    return {
        "events": len(events),
        "traces": len(traces),
        "pids": sorted({e.get("pid") for e in events}),
        # traces whose events span >1 process: the cross-process proof
        "traces_multiprocess": sum(
            1 for pids in traces.values() if len(pids) > 1),
        "slowest": [{"trace_id": e["args"]["trace_id"], "name": e["name"],
                     "dur_ms": round(float(e.get("dur", 0.0)) / 1e3, 3)}
                    for e in roots[:slowest]],
    }


def linked_traces(merged: dict, require_names: Sequence[str] = (),
                  min_pids: int = 1) -> List[str]:
    """Trace ids whose events span >= `min_pids` processes AND include
    every name in `require_names` (e.g. a request whose trace holds both
    its HTTP root and its device dispatch)."""
    by_trace: Dict[str, dict] = {}
    for e in merged.get("traceEvents", []):
        tid = e.get("args", {}).get("trace_id")
        if not tid:
            continue
        rec = by_trace.setdefault(tid, {"pids": set(), "names": set()})
        rec["pids"].add(e.get("pid"))
        rec["names"].add(e.get("name"))
    return sorted(
        tid for tid, rec in by_trace.items()
        if len(rec["pids"]) >= min_pids
        and all(n in rec["names"] for n in require_names))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="pva-torch-trace",
        description="merge trace rings + flight records from N processes "
                    "into one Chrome/Perfetto timeline")
    ap.add_argument("inputs", nargs="+",
                    help="trace_ring.json / flight_record.json files")
    ap.add_argument("--out", default="",
                    help="write the merged timeline here (omit to only "
                         "print the summary)")
    ap.add_argument("--slowest", type=int, default=5,
                    help="how many slowest root spans to summarize")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0
    try:
        merged = merge_paths(args.inputs)
    except (OSError, ValueError) as e:
        print(f"pva-torch-trace: {e}", file=sys.stderr)
        return 2
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merged, f)
    summary = summarize(merged, slowest=args.slowest)
    if args.out:
        summary["out"] = args.out
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
