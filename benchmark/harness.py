"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``:
its configuration's file, its traffic mix's file (which names its jobs),
and one reader a metric under ``metrics/``.  Set-up makes the inputs from
the seed, builds the mix's jobs and runs one to warm every shape the mix
uses; the window is a closed loop of whole jobs, one at a time, started
until the clock passes the run's seconds.  After the window the device's
peak memory is read, the program's state is let go, and every job's answer
is compared with the plain reference of its input.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JOB_SPAN = "bench.job"
# a --trace 1 run profiles the jobs that start in the window's first this
# many seconds (whole jobs), so that a trace stays a few hundred MB
TRACE_SECONDS = 10.0
FORBIDDEN = ("jax", "jaxlib", "flax", "hga_tpu")


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module of its own."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = f"benchmark.{kind}." + re.sub(r"[^0-9A-Za-z_]", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its configuration, mix and metrics."""

    def __init__(self, bench: Dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(ROOT,
                                             cfgs[self.entry["config"]]["file"]))
        self.mix = load_json(os.path.join(HERE, "traffic",
                                          f"{self.entry['traffic']}.json"))
        self.jobs_mod = load_module("jobs", self.mix["jobs"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]

    def metrics(self, trace: bool) -> List[Dict]:
        return self.per_layer if trace else self.end_to_end


class Window:
    """What the window did: jobs (input index a job), seconds, work."""

    def __init__(self):
        self.inputs: List[int] = []
        self.t0 = self.t1 = 0.0
        self.work = 0.0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Run:
    """What a metric reader reads: the cell, set-up seconds, the window,
    the mix's jobs (their shapes), the device, and the trace's summary (or
    None)."""

    def __init__(self, cell, setup_s, window, jobs, device_kind, trace):
        self.cell, self.setup_s, self.window = cell, setup_s, window
        self.jobs, self.device_kind, self.trace = jobs, device_kind, trace

    @property
    def n_jobs(self) -> int:
        return len(self.window.inputs)


def _reservoir(rng: np.random.Generator, size: int):
    """Keep a uniform sample of `size` items of a stream (algorithm R)."""
    kept: List = []
    seen = [0]

    def offer(item_fn: Callable[[], object]) -> None:
        seen[0] += 1
        if len(kept) < size:
            kept.append(item_fn())
        else:
            j = int(rng.integers(0, seen[0]))
            if j < size:
                kept[j] = item_fn()
    return kept, offer


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run_cell(bench: Dict, name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             config_override: Optional[Callable[[Dict], Dict]] = None
             ) -> Tuple[Dict, List[str]]:
    """One run; returns the result line's object and the check lines."""
    import torch

    from benchmark import gen

    cell = Cell(bench, name)
    config = cell.config if config_override is None else config_override(
        cell.config)
    jobs = cell.jobs_mod.Jobs(config, cell.mix, seed, device)
    jobs.job(0)                                   # warm-up: every shape
    _sync(device)
    setup_s = time.perf_counter() - t_start

    kept, offer = _reservoir(gen.rng_for(seed, 99), cell.mix["check_sample"])
    summaries: List = []
    win = Window()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    win.t0 = time.perf_counter()
    n = 0
    while True:
        i = n % jobs.n_inputs
        with (torch.profiler.record_function(JOB_SPAN) if prof is not None
              else contextlib.nullcontext()):
            res = jobs.job(i)
            _sync(device)
        win.inputs.append(i)
        win.work += jobs.work(i)
        summaries.append(jobs.summary(res))
        offer(lambda: (len(win.inputs) - 1, res))
        del res
        n += 1
        elapsed = time.perf_counter() - win.t0
        if prof is not None and elapsed >= TRACE_SECONDS:
            prof.__exit__(None, None, None)       # the traced jobs end here
            traced, prof = prof, None
        if elapsed >= seconds:
            break
    win.t1 = time.perf_counter()
    tsum = None
    if trace:
        if prof is not None:
            prof.__exit__(None, None, None)
            traced = prof
        from benchmark import devtrace as T

        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            traced.export_chrome_trace(path)
            del traced
            tsum = T.summarize(path, JOB_SPAN)
        finally:
            os.remove(path)

    dev_info = device_info(device)
    if tsum is not None:
        dev_info.update(busy_s=tsum.get("busy_s", 0.0),
                        window_s=tsum.get("window_s", 0.0))
    run = Run(cell, setup_s, win, jobs, dev_info["kind"], tsum)
    metrics = {}
    for m in cell.metrics(trace):
        v = load_module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])

    # the check, once the peak is read and the program's state let go
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    limits = cell.jobs_mod.LIMITS
    checks, failed = check(jobs, limits, win.inputs, summaries,
                           [(j, jobs.answer(r)) for j, r in kept])
    del kept
    lines = [f"check {k}: {v} (limit {limits[k]})" for k, v in checks.items()]
    correct = failed == 0 and all(v <= limits[k] for k, v in checks.items())
    out = dict(correct=bool(correct), attempted=len(win.inputs),
               failed=failed, metrics=metrics, device=dev_info)
    if tsum is not None:
        from benchmark import devtrace as T

        out["breakdown"] = T.breakdown(tsum)
    out["checks"] = {k: dict(value=v, limit=limits[k])
                     for k, v in checks.items()}
    return out, lines


def check(jobs, limits: Dict, inputs: List[int], summaries: List,
          kept: List) -> Tuple[Dict, int]:
    """Every job's summary and each sampled job's whole answer against the
    reference of its input: the largest reading of each number, and the
    jobs with any reading above its limit."""
    refs = {i: jobs.reference(i) for i in sorted(set(inputs))}
    worst: Dict[str, float] = {k: 0 for k in limits}
    bad = set()
    for j, (i, s) in enumerate(zip(inputs, summaries)):
        for k, v in jobs.compare(s, refs[i]).items():
            worst[k] = max(worst[k], v)
            if v > limits[k]:
                bad.add(j)
    for j, ans in kept:
        for k, v in jobs.compare(ans, refs[inputs[j]]).items():
            worst[k] = max(worst[k], v)
            if v > limits[k]:
                bad.add(j)
    return worst, len(bad)


def device_info(device: str) -> Dict:
    import torch

    if device.startswith("cuda"):
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=1,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
