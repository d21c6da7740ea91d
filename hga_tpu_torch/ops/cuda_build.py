"""Build of the port's hand-written CUDA kernels (``csrc/*.cu``).

Each library is one source compiled by ``nvcc`` (``-gencode
arch=compute_90a,code=sm_90a``) into ``hga_tpu_torch/_build/`` as a shared
library with a plain C interface, keyed by a hash of its source and the
flags, and loaded with ctypes by its wrapper module (ops/myers_cuda.py for
myers, myers_gate and myers_votes, ops/align_cuda.py, ops/kmer_cuda.py, and
the harness kernels' exp/vpu_micro.py, exp/myers_micro.py,
exp/sw_variants.py).  ``build_all``
starts one ``nvcc`` per library, all at once, and waits for them together.
The ptxas report (registers, spills) of each build is kept beside the
library; ``sass_opcodes`` counts the instructions of each kernel in a built
library (``cuobjdump -sass``).
"""

from __future__ import annotations

import collections
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Counter, Dict, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> its source in csrc/
SOURCES = {"myers": "myers.cu", "myers_gate": "myers_gate.cu",
           "myers_votes": "myers_votes.cu", "sw": "sw.cu",
           "vpu_micro": "vpu_micro.cu", "myers_micro": "myers_micro.cu",
           "sw_variants": "sw_variants.cu", "kmer": "kmer.cu"}

# what the last build of each library did: lib path, seconds, cached, ptxas
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _paths(name: str):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as fh:
        h.update(fh.read())
    stem = os.path.join(BUILD_DIR, f"libhga_{name}_{h.hexdigest()[:16]}")
    return stem + ".so", stem + ".ptxas.txt"


def _start(name: str, force: bool
           ) -> Optional[Tuple[subprocess.Popen, float]]:
    """Start nvcc for one library (returns it and its start time), or
    record the cached build (None)."""
    lib, log = _paths(name)
    if os.path.exists(lib) and not force:
        info = dict(lib=lib, seconds=0.0, cached=True, ptxas="")
        if os.path.exists(log):
            with open(log) as fh:
                info["ptxas"] = fh.read()
        BUILD_INFO[name] = info
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", f"{lib}.{os.getpid()}.tmp",
           os.path.join(CSRC, SOURCES[name])]
    t0 = time.perf_counter()
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), t0


def _finish(name: str, started: Tuple[subprocess.Popen, float]) -> None:
    lib, log = _paths(name)
    proc, t0 = started
    _, err = proc.communicate()
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                           f"({proc.returncode}):\n{err}")
    with open(log, "w") as fh:
        fh.write(err)
    os.replace(f"{lib}.{os.getpid()}.tmp", lib)
    BUILD_INFO[name] = dict(lib=lib, seconds=dt, cached=False, ptxas=err)


def build_all(force: bool = False) -> Dict[str, str]:
    """Compile every library in SOURCES, one nvcc each, all started
    together; returns {name: library path}."""
    procs = {name: _start(name, force) for name in SOURCES}
    try:
        for name, started in procs.items():
            if started is not None:
                _finish(name, started)
    finally:
        for started in procs.values():
            if started is not None and started[0].poll() is None:
                started[0].kill()
                started[0].wait()
    return {name: str(BUILD_INFO[name]["lib"]) for name in SOURCES}


def build(name: str) -> str:
    """Compile one library (once per source hash); returns its path."""
    started = _start(name, False)
    if started is not None:
        _finish(name, started)
    return str(BUILD_INFO[name]["lib"])


_SASS_FUNC = re.compile(r"Function : (\S+)")
_SASS_INSN = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_]*)")


def sass_opcodes(name: str) -> Dict[str, Counter[str]]:
    """{mangled kernel name: opcode counts (modifiers dropped)} of one
    built library, from the toolkit's ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", build(name)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    funcs: Dict[str, Counter[str]] = {}
    cur: Optional[Counter[str]] = None
    for line in out.splitlines():
        m = _SASS_FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), collections.Counter())
            continue
        m = _SASS_INSN.match(line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return funcs
