"""Render a saved profiler record as a text timeline.

Ref: records/show_timestamps.ipynb visualizes the reference profiler's
cumulative timestamp stream (profiler/profiler.py:33-43) to find pipeline
bubbles. Same purpose here, as a CLI over `Profiler.save()` JSON: one line
per event with its absolute offset, the delta to the previous event, and a
proportional bar so bubbles (large deltas between turn events) stand out in
a terminal instead of a notebook. A record of the port's recorder (`prof`
with `enabled` set) also holds its spans: they render as a second timeline
of `name:start` / `name:stop` events, with each span name's count, mean
host ms and mean device ms.

Usage:
    python tools/show_timestamps.py record.json [--top 20]
"""

import argparse
import json


def render(stream, top=0, width=50):
    """stream: [(event, t_seconds), ...] -> list of printable lines."""
    if not stream:
        return ["(empty stream)"]
    lines = []
    deltas = []
    prev = stream[0][1]
    for name, t in stream:
        deltas.append(t - prev)
        prev = t
    dmax = max(deltas) or 1e-9
    for (name, t), d in zip(stream, deltas):
        bar = "#" * max(0, round(width * d / dmax))
        lines.append(f"{t * 1e3:10.3f}ms  +{d * 1e3:8.3f}ms  {name:28s} {bar}")
    if top:
        ranked = sorted(zip(deltas, (n for n, _ in stream)), reverse=True)
        lines.append("")
        lines.append(f"top {top} gaps:")
        for d, name in ranked[:top]:
            lines.append(f"  +{d * 1e3:8.3f}ms before {name}")
    return lines


def span_stream(spans):
    """A saved record's spans as a timestamp stream: `name:start` and
    `name:stop` events in time order, in seconds from the first."""
    evs = sorted([(sp["t0_ns"], f"{sp['name']}:start") for sp in spans]
                 + [(sp["t1_ns"], f"{sp['name']}:stop") for sp in spans])
    return [(name, (t - evs[0][0]) / 1e9) for t, name in evs]


def span_summary(spans):
    """{name: (count, mean host ms, mean device ms or None)}."""
    by = {}
    for sp in spans:
        by.setdefault(sp["name"], []).append(sp)
    out = {}
    for name, group in by.items():
        dev = [sp["device_ms"] for sp in group
               if sp.get("device_ms") is not None]
        out[name] = (len(group),
                     sum(sp["t1_ns"] - sp["t0_ns"] for sp in group)
                     / len(group) / 1e6,
                     sum(dev) / len(dev) if dev else None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("record", help="JSON written by Profiler.save()")
    ap.add_argument("--top", type=int, default=10,
                    help="also list the N largest inter-event gaps")
    args = ap.parse_args(argv)
    with open(args.record) as f:
        rec = json.load(f)
    for line in render([tuple(e) for e in rec.get("stream", [])],
                       top=args.top):
        print(line)
    if rec.get("summary"):
        print("\nspan summary:")
        for name, row in rec["summary"].items():
            print(f"  {name:28s} {row['mean_ms']:9.3f}ms x{row['count']}")
    if rec.get("spans"):
        print("\nspans:")
        for line in render(span_stream(rec["spans"]), top=args.top):
            print(line)
        print("\nby span (count, mean host ms, mean device ms):")
        for name, (n, host, dev) in span_summary(rec["spans"]).items():
            dev = "-" if dev is None else f"{dev:.3f}ms"
            print(f"  {name:28s} x{n:<6d} {host:9.3f}ms {dev:>10s}")
        print(f"counters: {rec.get('counters', {})}")


if __name__ == "__main__":
    main()
