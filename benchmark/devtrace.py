"""Reduction of a ``torch.profiler`` trace (Chrome JSON, CUPTI device
activity) to what the metric readers and the breakdown read.

The window is from the start of the first job's annotation to the end of
the last one's, on the host's timeline; device operations (kernels, copies,
sets) are clipped to it.  Busy time is the union of their intervals.  An
idle gap of the device is named by the innermost host event (a torch op, a
CUDA runtime call, or the job's annotation itself, which means Python
between torch calls) running on the jobs' thread at the gap's midpoint.
"""

from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def summarize(path: str, job_name: str) -> Dict:
    """jobs, window_s, busy_s, device_s (summed operation time), n_ops,
    ops_by_name and gaps_by_name ({name: seconds}), all from the trace at
    `path`; jobs 0 where the trace holds no job annotation."""
    with open(path) as fh:
        data = json.load(fh)
    events = data["traceEvents"] if isinstance(data, dict) else data
    jobs = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name") == job_name]
    if not jobs:
        return dict(jobs=0)
    w0 = min(float(e["ts"]) for e in jobs)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in jobs)
    tid = (jobs[0].get("pid"), jobs[0].get("tid"))
    dev, host = [], []
    ops_by_name: Dict[str, float] = collections.defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                ops_by_name[_short(e.get("name", "?"))] += (b - a) * 1e-6
        elif cat in HOST_CATS and (e.get("pid"), e.get("tid")) == tid:
            host.append((a, b, e.get("name", "?")))
    busy = _union(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return dict(jobs=len(jobs), window_s=(w1 - w0) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                device_s=sum(b - a for a, b in dev) * 1e-6, n_ops=len(dev),
                ops_by_name=dict(ops_by_name),
                gaps_by_name=_name_gaps(gaps, host, job_name))


def _name_gaps(gaps, host, job_name) -> Dict[str, float]:
    """Sum the gaps by the innermost host event open at each midpoint; the
    job's own annotation there means host code between torch calls."""
    host.sort(key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    out: Dict[str, float] = collections.defaultdict(float)
    stack: List[Tuple[float, float, str]] = []
    k = 0
    for a, b in gaps:
        mid = (a + b) / 2
        hi = bisect.bisect_right(starts, mid)
        while k < hi:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        name = stack[-1][2] if stack else "(between jobs)"
        if name == job_name:
            name = "(host code in the job, outside torch calls)"
        out[_short(name)] += (b - a) * 1e-6
    return dict(out)


def breakdown(summary: Dict) -> Dict:
    """The ten device operations that took most time and the ten host
    events under which the device stood idle longest, [name, seconds]."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return dict(device_ops=top(summary.get("ops_by_name", {})),
                idle_gaps=top(summary.get("gaps_by_name", {})))
