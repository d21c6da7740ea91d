"""Start P rank processes with torchrun's environment and run one function in
each (the tests' and chip_smoke.py's launcher; users run ``torchrun``).

    from hga_tpu_torch.parallel.launch import launch
    outs = launch("my_module:worker", 2, "/path/to/outdir", {"n": 3})

Each rank process gets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` as torchrun sets
them, joins the world through ``mesh.init_distributed`` (over a
``file://`` store in `outdir`, so concurrent launches never race for a
port; the backend by its rule), calls ``module.function(**kwargs)`` and
writes the dict it returns, with the rank, the backend and whether ``jax``
or ``hga_tpu`` were loaded, to ``outdir/rank<r>.json``.  `launch` returns
those dicts in rank order.  A rank that fails, or a run past `timeout`,
stops every rank and raises with the failing rank's output
(``outdir/rank<r>.log``).
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(target: str, nprocs: int, outdir: str,
           kwargs: Optional[Dict] = None, *, device: str = "cpu",
           threads: int = 1, timeout: float = 600.0,
           pythonpath: Sequence[str] = ()) -> List[Dict]:
    """Run ``target`` ("module:function") in `nprocs` rank processes on
    `device` ranks; returns each rank's result dict, in rank order.
    `pythonpath` adds import roots for the target's module."""
    os.makedirs(outdir, exist_ok=True)
    for f in [".store"] + [f"rank{r}.json" for r in range(nprocs)]:
        if os.path.exists(os.path.join(outdir, f)):
            os.remove(os.path.join(outdir, f))
    spec = dict(target=target, kwargs=kwargs or {}, device=device,
                threads=threads, outdir=outdir,
                init_method="file://" + os.path.join(os.path.abspath(outdir),
                                                     ".store"))
    paths = [_ROOT, *pythonpath, os.environ.get("PYTHONPATH", "")]
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in paths if p),
                WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs),
                MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                OMP_NUM_THREADS=str(threads))
    procs = []
    for r in range(nprocs):
        env = dict(base, RANK=str(r), LOCAL_RANK=str(r))
        logf = open(os.path.join(outdir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "hga_tpu_torch.parallel.launch",
             json.dumps(spec)], env=env, stdout=logf,
            stderr=subprocess.STDOUT, cwd=_ROOT), logf))
    t_end = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [r for r, (p, _) in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if time.monotonic() > t_end:
                failed = "timeout"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, (p, _) in enumerate(procs) if p.returncode]
            failed = bad[0] if bad else None
    finally:
        for p, logf in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            logf.close()
    if failed is not None:
        r = 0 if failed == "timeout" else failed
        with open(os.path.join(outdir, f"rank{r}.log")) as fh:
            tail = fh.read()[-4000:]
        what = (f"timed out after {timeout} s" if failed == "timeout"
                else f"rank {r} exited with code {procs[r][0].returncode}")
        raise RuntimeError(f"launch {target} on {nprocs} ranks: {what}; "
                           f"rank {r}'s output:\n{tail}")
    outs = []
    for r in range(nprocs):
        with open(os.path.join(outdir, f"rank{r}.json")) as fh:
            outs.append(json.load(fh))
    return outs


def _child(spec: Dict) -> int:
    import torch
    import torch.distributed as dist

    from hga_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(spec["threads"])
    backend = init_distributed(device=spec["device"],
                               init_method=spec["init_method"])
    mod, fn = spec["target"].split(":")
    out = dict(getattr(importlib.import_module(mod), fn)(**spec["kwargs"]))
    rank = dist.get_rank()
    out.update(rank=rank, world=dist.get_world_size(), backend=backend,
               jax_loaded="jax" in sys.modules,
               hga_tpu_loaded="hga_tpu" in sys.modules)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(spec["outdir"], f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(_child(json.loads(sys.argv[1])))
