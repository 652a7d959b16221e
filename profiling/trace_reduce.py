"""Reduce a ``jax.profiler`` trace to device busy share and the top kernels.

For every device stream in the trace: the traced window (first event start to
last event end), the busy time (the union of its event intervals), the busy
share of the window, and the kernels and copies that took the most time, with
their counts.  ``MemcpyD2H`` events on a compute stream are the host reading a
device value back, one per ``lax.cond`` predicate on a GPU.

    python profiling/trace_reduce.py TRACE_DIR [TRACE_DIR ...]

``TRACE_DIR`` is the directory given to ``jax.profiler.trace``; the newest
``*.trace.json.gz`` below it is read.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys


def newest_trace(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def reduce_trace(path: str, top: int = 12) -> list[dict]:
    """One summary per device stream, in stream order."""
    with gzip.open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    procs, threads = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            procs[e["pid"]] = e["args"]["name"]
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            threads[(e["pid"], e["tid"])] = e["args"]["name"]
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and procs.get(e.get("pid"), "").startswith("/device:"):
            spans[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"], e["name"]))

    out = []
    for (pid, tid), evs in sorted(spans.items()):
        evs.sort()
        busy, cur_start, cur_end = 0.0, None, None
        per_name = collections.defaultdict(lambda: [0.0, 0])
        for start, end, name in evs:
            per_name[name][0] += end - start
            per_name[name][1] += 1
            if cur_end is None or start > cur_end:
                if cur_end is not None:
                    busy += cur_end - cur_start
                cur_start, cur_end = start, end
            else:
                cur_end = max(cur_end, end)
        busy += cur_end - cur_start
        window = max(end for _, end, _ in evs) - evs[0][0]
        ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
        out.append({
            "stream": f"{procs[pid]} / {threads.get((pid, tid), tid)}",
            "events": len(evs),
            "window_ms": window / 1e3,
            "busy_ms": busy / 1e3,
            "busy_share": busy / window if window > 0 else float("nan"),
            "d2h_copies": sum(c for n, (_, c) in per_name.items() if "MemcpyD2H" in n),
            "top": [(n, t / 1e3, c) for n, (t, c) in ranked[:top]],
        })
    return out


def format_summary(summary: list[dict]) -> str:
    lines = []
    for s in summary:
        lines.append(
            f" {s['stream']}: {s['events']} events, window {s['window_ms']:.3f} ms, "
            f"busy {s['busy_ms']:.3f} ms ({100 * s['busy_share']:.2f}%), "
            f"{s['d2h_copies']} MemcpyD2H")
        lines += [f"   {t:10.3f} ms  x {c:5d}  {n}" for n, t, c in s["top"]]
    return "\n".join(lines)


def main(argv: list[str]) -> int:
    for trace_dir in argv:
        print(f"== {trace_dir}")
        print(format_summary(reduce_trace(newest_trace(trace_dir))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
