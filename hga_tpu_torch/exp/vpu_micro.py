"""Harness: the H100's int32 add/max issue rate (X3), and a bf16 matmul.

Counterpart of exp/vpu_micro.py.  ``vpu_chains_cuda`` launches X3
(``csrc/vpu_micro.cu`` ``vpu_kernel<C, STEPS>``), which replaces the Pallas
kernel ``kernel`` inside ``make`` (exp/vpu_micro.py:16-25): on every element
of an (R, 128) int32 tile, C independent chains x_c = x + c, STEPS steps of
x_g = max(x_g + 1, x_g) (g = step % C), summed.  Adds wrap as two's
complement, so a chain stops at INT32_MAX.

What bounds it on an H100: integer issue rate alone (STEPS add/max
instructions per element against 8 bytes); the kernel runs one element per
thread with the chains in registers and STEPS unrolled, over enough copies
of the tile (`reps`) to keep 2048 threads resident on every SM for four
waves.  The rate is reported twice: from the source's 2 operations a step,
and from the add and min/max instructions the SASS holds (``cuobjdump
-sass``; nvcc fuses a step's add and max into one VIADDMNMX), which is what
ran.  Its share of the data sheet's 16.7e12 int32 operations/s
(utils/benchmarks.INT32_OPS_PER_S) tests the figure every bound in PERF.md
uses.

The wrapper checks dtype, shape and contiguity and raises on anything else.
On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
returns the plain version ``chains``.  There is no fallback.

    python -m hga_tpu_torch.exp.vpu_micro [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.utils import spans
from hga_tpu_torch.utils.benchmarks import INT32_OPS_PER_S, time_ms
from hga_tpu_torch.utils.device import resolve_device

THREADS = 128                 # one element a thread (csrc kThreads)
RESIDENT_THREADS_PER_SM = 2048
WAVES = 4
BUILT = {(c, s) for c in (1, 2, 4, 8) for s in (16, 2048)}   # (C, STEPS)
# SASS opcodes of the chains' adds and maxima (VIADDMNMX fuses both)
ADD_MAX_OPS = ("IADD3", "IADD", "VIADD", "IMNMX", "VIMNMX", "VIADDMNMX")
BF16_TFLOPS = 989.0           # H100 SXM dense bf16 (NVIDIA data sheet)

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("vpu_micro"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_vpu_launch.argtypes = [vp, ci, ci, ci, ci, vp, vp]
        lib.hga_vpu_launch.restype = ci
        lib.hga_vpu_attrs.argtypes = [ci, ci, ctypes.POINTER(ci),
                                      ctypes.POINTER(ci)]
        lib.hga_vpu_attrs.restype = ci
        _LIB = lib
    return _LIB


def kernel_attrs(C: int, steps: int) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of one instantiation."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().hga_vpu_attrs(C, steps, ctypes.byref(regs),
                               ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> their two's-complement int32 value (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def chains(x: torch.Tensor, C: int = 1, steps: int = 2048) -> torch.Tensor:
    """The plain version: the same chains in int64 wrapped to int32 after
    every add.  The chains are independent, so they step together: chain g
    takes the steps s = g, g + C, ..."""
    xs = _wrap32(x.to(torch.int64)[None]
                 + torch.arange(C, dtype=torch.int64,
                                device=x.device).view(C, *[1] * x.dim()))
    for s in range(steps // C):
        xs = torch.maximum(_wrap32(xs + 1), xs)
    rem = steps % C                       # chains 0..rem-1 take one more
    if rem:
        xs[:rem] = torch.maximum(_wrap32(xs[:rem] + 1), xs[:rem])
    acc = xs[0]
    for g in range(1, C):
        acc = _wrap32(acc + xs[g])
    return acc.to(torch.int32)


def default_reps(n: int, dev: torch.device) -> int:
    """Copies of an n-element tile that fill every SM with resident threads
    for WAVES waves."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(65535, math.ceil(
        WAVES * sms * RESIDENT_THREADS_PER_SM / n)))


def vpu_chains_cuda(x: torch.Tensor, C: int = 1, steps: int = 2048,
                    reps: int = 1) -> torch.Tensor:
    """X3: the chains of every element of x (int32, 2-D, contiguous),
    computed `reps` times (reps, *x.shape); bit-exact with ``chains``.  On
    a CPU tensor: the plain version, repeated."""
    if x.dtype != torch.int32:
        raise ValueError(f"x must be int32, got {x.dtype}")
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty 2-D tile, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 1 <= reps <= 65535:
        raise ValueError(f"reps must be in 1..65535, got {reps}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"x lies on {x.device}")
    if not x.is_cuda:
        return chains(x, C, steps).expand(reps, *x.shape)
    if (C, steps) not in BUILT:
        raise ValueError(f"no kernel for C={C}, STEPS={steps}: built "
                         f"{sorted(BUILT)}")
    out = torch.empty((reps, *x.shape), dtype=torch.int32, device=x.device)
    with spans.launch("vpu_chains_cuda"):
        run_kernel(x, C, steps, out)
    return out


def run_kernel(x: torch.Tensor, C: int, steps: int, out: torch.Tensor
               ) -> None:
    """Launch X3 on the current stream: out (reps, *x.shape)."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().hga_vpu_launch(x.data_ptr(), x.numel(), C, steps,
                                    out.shape[0], out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"vpu kernel launch failed: CUDA error {err}")


def sass_add_max() -> Dict[Tuple[int, int], Dict[str, int]]:
    """{(C, STEPS): add and min/max opcode counts} of each instantiation's
    SASS: the instructions a thread actually issues."""
    out = {}
    for fn, ops in cuda_build.sass_opcodes("vpu_micro").items():
        m = re.search(r"vpu_kernelILi(\d+)ELi(\d+)E", fn)
        if m:
            out[int(m.group(1)), int(m.group(2))] = {
                op: ops[op] for op in ADD_MAX_OPS if ops[op]}
    return out


def bench(R: int = 128, C: int = 1, steps: int = 2048, device="cuda",
          label: str = "", sass: Optional[Dict] = None) -> Dict:
    """Time one (R, C) probe; returns its rates.  On the card: the kernel
    over default_reps copies, CUDA events; on the CPU: the plain version."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 100, (R, 128)).astype(np.int32)).to(dev)
    reps = default_reps(x.numel(), dev) if dev.type == "cuda" else 1
    sets = [(x + i,) for i in range(4)]           # distinct inputs
    ms = time_ms(lambda a: vpu_chains_cuda(a, C, steps, reps), sets,
                 20 if dev.type == "cuda" else 2, dev)
    elems = x.numel() * reps
    row = dict(R=R, C=C, steps=steps, reps=reps, threads=elems,
               ms=ms, device=dev.type,
               lane_ops_per_s=2 * steps * elems / (ms * 1e-3))
    msg = (f"{label or 'int32'} R={R} C={C} ({dev.type}): "
           f"{row['lane_ops_per_s'] / 1e9:9.1f} G lane-ops/s (the source's "
           f"add and max a step)")
    if sass is not None and (C, steps) in sass:
        per_thread = sum(sass[C, steps].values())
        row.update(sass_add_max=sass[C, steps],
                   sass_per_step=per_thread / steps,
                   instr_per_s=per_thread * elems / (ms * 1e-3))
        row["share"] = row["instr_per_s"] / INT32_OPS_PER_S
        msg += (f"  {row['instr_per_s'] / 1e9:9.1f} G add/max lane-instr/s "
                f"(SASS {per_thread} a thread) = {row['share']:.3f} of the "
                f"data sheet's {INT32_OPS_PER_S / 1e12:.1f} T")
    print(msg, flush=True)
    return row


def bench_mxu(M: int = 512, K: int = 512, N: int = 512,
              device="cuda") -> Dict:
    """bf16 matrix product rate of torch.matmul (a plain large product, as
    the reference leaves jnp.dot to XLA): 32 dependent products."""
    dev = resolve_device(device)
    g = np.random.default_rng(0)
    a = torch.from_numpy(g.normal(size=(M, K))).to(dev, torch.bfloat16)
    b = torch.from_numpy(np.random.default_rng(1).normal(size=(K, N))).to(
        dev, torch.bfloat16)

    def many(a, b):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(32):
            c = torch.matmul(a + acc.to(torch.bfloat16), b)
            acc = acc + c[0, 0].float()
        return acc

    ms = time_ms(many, [(a, b)], 3, dev) / 32
    tflops = 2 * M * K * N / (ms * 1e-3) / 1e12
    print(f"mxu bf16 {M}x{K}x{N}: {tflops:6.2f} TFLOP/s "
          f"(data sheet {BF16_TFLOPS:.0f}, {dev.type})", flush=True)
    return dict(M=M, K=K, N=N, ms=ms, tflops=tflops, device=dev.type)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sass = sass_add_max() if dev.type == "cuda" else None
    rows = [bench(R=128, C=C, device=dev, sass=sass) for C in (1, 2, 4, 8)]
    rows += [bench(R=8, C=4, device=dev, sass=sass),
             bench(R=8, C=8, device=dev, sass=sass)]
    rows.append(bench_mxu(device=dev))
    return rows


if __name__ == "__main__":
    main()
