"""Harness: Myers with the targets staged in slabs of columns (X1), beside K1'.

Counterpart of exp/myers_micro.py.  ``run_b`` launches X1
(``csrc/myers_micro.cu`` ``myers_slab_kernel<W>``), which replaces the
Pallas kernel ``_kernel_b`` (exp/myers_micro.py:58): K1's function, ``dist``
and ``tend`` per pair, from precomputed query bit-planes
(ops.myers.query_planes) and the targets, read in slabs of BLK columns.

The knobs are the reference's.  BLK is the columns per slab.  S was the pair
tile (S * 128 pairs a grid step, S sublanes of 128 lanes); on Hopper a block
holds 16 * S pairs, one a thread (S = 8 gives K1's 128 threads), and those
pairs share each staged slab of BLK * 16 * S int8 codes in shared memory.

What bounds it on an H100: as K1, about 20 int32 operations per word,
column and pair, serial within a pair (integer issue rate); the design stages
each slab coalesced as 32-bit words and runs its columns unrolled by 8.

The wrapper takes the port's layouts (planes (N, W), targets (N, Lt)), not
the (G, S, 128) TPU tiling.  It checks dtype, shape and contiguity and
raises on anything else, also when the slab exceeds 227 KB a block or
W > MAX_WORDS.  On a CUDA tensor it launches the kernel (or raises); on a
CPU tensor it returns the plain version (ops.myers.myers_batch_from_planes,
myers_batch's recurrence).  There is no fallback.

    python -m hga_tpu_torch.exp.myers_micro [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.ops.myers import (MAX_WORDS, MyersResult, myers_batch,
                                     myers_batch_from_planes, n_words,
                                     query_planes)
from hga_tpu_torch.ops import myers_cuda as MC
from hga_tpu_torch.utils.benchmarks import time_ms
from hga_tpu_torch.utils.device import resolve_device

# launches of the kernel by its wrapper (reset with reset_launches())
LAUNCHES: Dict[str, int] = {"run_b_cuda": 0}

SMEM_MAX = 232448            # shared memory a block may opt in to (227 KB)
MAX_THREADS = 1024

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("myers_micro"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_myers_slab_launch.argtypes = [vp] * 7 + [ci] * 6 + [vp] * 3
        lib.hga_myers_slab_launch.restype = ci
        lib.hga_myers_slab_attrs.argtypes = [ci, ctypes.POINTER(ci),
                                             ctypes.POINTER(ci)]
        lib.hga_myers_slab_attrs.restype = ci
        _LIB = lib
    return _LIB


def kernel_attrs(W: int) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of one instantiation."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().hga_myers_slab_attrs(W, ctypes.byref(regs),
                                      ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def pairs_per_block(S: int) -> int:
    return 16 * S


def _check(qlen, tlen, q0, q1, vq, mend, t, S: int, BLK: int) -> None:
    named = (("qlen", qlen), ("tlen", tlen), ("q0", q0), ("q1", q1),
             ("vq", vq), ("mend", mend), ("t", t))
    for name, x in named:
        if x.device != t.device or x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"{name} lies on {x.device}; all operands must "
                             "lie on one CUDA device (or on the CPU)")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t.dim() != 2 or q0.dim() != 2:
        raise ValueError("planes must be (N, W) and t (N, Lt)")
    N, Lt = t.shape
    W = q0.shape[1]
    if any(x.shape != (N, W) for x in (q0, q1, vq, mend)) or \
            qlen.shape != (N,) or tlen.shape != (N,):
        raise ValueError(f"shape mismatch: planes {tuple(q0.shape)}, t "
                         f"{tuple(t.shape)}, qlen {tuple(qlen.shape)}, "
                         f"tlen {tuple(tlen.shape)}")
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"W={W} words outside 1..{MAX_WORDS}")
    P = pairs_per_block(S)
    if S < 1 or BLK < 1 or P > MAX_THREADS:
        raise ValueError(f"S={S}, BLK={BLK}: need S >= 1, BLK >= 1 and "
                         f"16 * S <= {MAX_THREADS}")
    if BLK * P > SMEM_MAX:
        raise ValueError(f"a slab of BLK={BLK} columns x {P} pairs = "
                         f"{BLK * P} bytes exceeds {SMEM_MAX} bytes of shared "
                         "memory a block")


def kernel_operands(qlen, tlen, q0, q1, vq, mend, t, S: int):
    """The kernel's device operands: planes transposed (W, N), targets as
    int8 codes (any code outside 0..3 as 4) transposed (Lt, Np) and padded
    with code 4 to Np = a whole number of blocks, and fresh outputs."""
    N, Lt = t.shape
    P = pairs_per_block(S)
    Np = -(-N // P) * P
    t8 = torch.full((Lt, Np), 4, dtype=torch.int8, device=t.device)
    t8[:, :N] = torch.where((t >= 0) & (t < 4), t, 4).t().to(torch.int8)
    planes = tuple(x.t().contiguous() for x in (q0, q1, vq, mend))
    outs = tuple(torch.empty(N, dtype=torch.int32, device=t.device)
                 for _ in range(2))
    return planes, t8, qlen, tlen, N, outs


def run_kernel(planes, t8, qlen, tlen, N, outs, S: int, BLK: int) -> None:
    """Launch X1 on the current stream."""
    q0, q1, vq, mend = planes
    W = q0.shape[0]
    Lt, Np = t8.shape
    dist, tend = outs
    with torch.cuda.device(t8.device):
        stream = torch.cuda.current_stream(t8.device).cuda_stream
        err = _lib().hga_myers_slab_launch(
            q0.data_ptr(), q1.data_ptr(), vq.data_ptr(), mend.data_ptr(),
            t8.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N, Np, Lt, W,
            pairs_per_block(S), BLK, dist.data_ptr(), tend.data_ptr(),
            stream)
    if err:
        raise RuntimeError(f"myers slab kernel launch failed: CUDA error "
                           f"{err}")


def run_b(qlen: torch.Tensor, tlen: torch.Tensor, q0: torch.Tensor,
          q1: torch.Tensor, vq: torch.Tensor, mend: torch.Tensor,
          t: torch.Tensor, S: int = 8, BLK: int = 64) -> MyersResult:
    """X1: batched semi-global edit distance from query planes; bit-exact
    with ops.myers.myers_batch.  Lengths int32 (N,), planes int32 (N, W),
    targets int32 (N, Lt), on one CUDA device (CPU tensors: the plain
    version)."""
    _check(qlen, tlen, q0, q1, vq, mend, t, S, BLK)
    if not t.is_cuda:
        return myers_batch_from_planes(q0, q1, vq, mend, t, qlen, tlen)
    planes, t8, qlen, tlen, N, outs = kernel_operands(
        qlen, tlen, q0, q1, vq, mend, t, S)
    if N:
        run_kernel(planes, t8, qlen, tlen, N, outs, S, BLK)
        LAUNCHES["run_b_cuda"] += 1
    return MyersResult(*outs)


def prep(N: int, Lq: int, Lt: int, device, seed: int = 0):
    """Uniform random pairs at full length (the reference's inputs):
    returns the run_b operands and (q, t, qlen, tlen), on `device`."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 4, (N, Lq)).astype(np.int32))
    t = torch.from_numpy(rng.integers(0, 4, (N, Lt)).astype(np.int32))
    ql = torch.full((N,), Lq, dtype=torch.int32)
    tl = torch.full((N,), Lt, dtype=torch.int32)
    q, t, ql, tl = (x.to(device) for x in (q, t, ql, tl))
    planes = query_planes(q, ql, n_words(Lq))
    return (ql, tl, *planes, t), (q, t, ql, tl)


def target_sets(ops, n_sets: int = 4):
    """n_sets copies of run_b's operands with distinct targets ((t + i) % 5:
    code 4 stays a non-matching code)."""
    return [(*ops[:-1], ((ops[-1] + i) % 5).contiguous())
            for i in range(n_sets)]


SHAPES = ((4096, 128, 192, 32, 8),     # W 5 (the reference's config-3 shape)
          (4096, 31, 192, 32, 8),      # W 1
          (8192, 128, 192, 32, 8))     # the bench shape (hga-torch bench)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    reps = 20 if dev.type == "cuda" else 2
    rows = []
    for N, Lq, Lt, BLK, S in SHAPES:
        ops, (q, t, ql, tl) = prep(N, Lq, Lt, dev)
        got = run_b(*ops, S=S, BLK=BLK)
        ref = myers_batch(q, t, ql, tl)
        ok = bool(torch.equal(got.dist, ref.dist)
                  and torch.equal(got.tend, ref.tend))
        sets = target_sets(ops)
        k1_sets = [(q, s[-1], ql, tl) for s in sets]     # K1', same pairs
        ms = time_ms(lambda *a: run_b(*a, S=S, BLK=BLK), sets, reps, dev)
        k1_ms = time_ms(MC.myers_batch_cuda, k1_sets, reps, dev)
        cells = N * Lq * Lt
        row = dict(N=N, Lq=Lq, Lt=Lt, W=n_words(Lq), BLK=BLK, S=S, ok=ok,
                   ms=ms, gcups=cells / (ms * 1e-3) / 1e9, k1_ms=k1_ms,
                   k1_gcups=cells / (k1_ms * 1e-3) / 1e9, device=dev.type)
        msg = (f"Lq={Lq} S={S} BLK={BLK} N={N} ({dev.type}): ok={ok} "
               f"ms={ms:.4f} GCUPS={row['gcups']:.1f}  K1' ms={k1_ms:.4f} "
               f"K1' GCUPS={row['k1_gcups']:.1f}")
        if dev.type == "cuda":
            # the launches alone: the wrappers' torch preprocessing differs
            # (X1 takes query planes and transposed int8 targets, K1' the
            # codes as they are)
            row["kernel_ms"] = time_ms(
                lambda *k: run_kernel(*k, S=S, BLK=BLK),
                [kernel_operands(*a, S=S) for a in sets], reps, dev)
            row["k1_kernel_ms"] = time_ms(
                MC.run_kernel, [MC.kernel_operands(*a) for a in k1_sets],
                reps, dev)
            msg += (f"  kernels alone: X1 {row['kernel_ms']:.4f} ms, K1' "
                    f"{row['k1_kernel_ms']:.4f} ms")
        rows.append(row)
        print(msg, flush=True)
    return rows


if __name__ == "__main__":
    main()
