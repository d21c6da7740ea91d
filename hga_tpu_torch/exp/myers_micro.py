"""Harness: Myers from query planes, a pair split across lanes (X1), beside K1'.

Counterpart of exp/myers_micro.py.  ``run_b`` launches X1
(``csrc/myers_micro.cu`` ``myers_slab_kernel<WL>``), which replaces the
Pallas kernel ``_kernel_b`` (exp/myers_micro.py:58): K1's function, ``dist``
and ``tend`` per pair, from precomputed query bit-planes
(ops.myers.query_planes) and the targets, read in slabs of BLK columns.

The knobs are the reference's.  BLK is the columns per slab.  S was the pair
tile (S * 128 pairs a grid step, S sublanes of 128 lanes); on Hopper a block
holds 16 * S pairs, packed into groups of A = ceil(W / ceil(W / 32)) lanes
(P = 32 // A pairs a warp), min(ceil(16 S / P), 32) warps a block, each warp
running its groups in turn (slab_geometry).  Each warp stages its own pairs'
slabs of BLK columns in shared memory by asynchronous copies, two buffers
deep, the next slab landing while this one runs.

What bounds it on an H100: as K1, about 20 int32 operations per word,
column and pair (integer issue rate); see csrc/myers_micro.cu for the
design.  No word cap: up to 128 words a pair's words sit in registers, past
that in a device scratch the wrapper allocates.

The wrapper takes the port's layouts (planes (N, W), targets (N, Lt),
int32, row-major, as they are: no copy a call), not the (G, S, 128) TPU
tiling.  It checks dtype, shape and contiguity and raises on anything else,
also when a block's slabs exceed 227 KB of shared memory.  On a CUDA tensor
it launches the kernel (or raises); on a CPU tensor it returns the plain
version (ops.myers.myers_batch_from_planes, myers_batch's recurrence).
There is no fallback.

    python -m hga_tpu_torch.exp.myers_micro [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.ops.myers import (MyersResult, myers_batch,
                                     myers_batch_from_planes, n_words,
                                     query_planes)
from hga_tpu_torch.ops import myers_cuda as MC
from hga_tpu_torch.utils import spans
from hga_tpu_torch.utils.benchmarks import time_ms
from hga_tpu_torch.utils.device import resolve_device

SMEM_MAX = 232448 - 32 * 2 * 8  # dynamic shared memory a block (227 KB less
                                # the kernel's 32 x 2 mbarriers)
MAX_WARPS = 32                  # warps a block
REGISTER_WORDS = 4              # words a lane kept in registers (W <= 128)
PLANES = 6                      # q0, q1, vq, mend, pv, mv: a word's state

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("myers_micro"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_myers_slab_launch.argtypes = ([vp] * 7 + [ci] * 5
                                              + [vp] * 4)
        lib.hga_myers_slab_launch.restype = ci
        lib.hga_myers_slab_attrs.argtypes = [ci, ctypes.POINTER(ci),
                                             ctypes.POINTER(ci)]
        lib.hga_myers_slab_attrs.restype = ci
        _LIB = lib
    return _LIB


def kernel_attrs(W: int) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of the instantiation
    that runs W words."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().hga_myers_slab_attrs(W, ctypes.byref(regs),
                                      ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def pairs_per_block(S: int) -> int:
    return 16 * S


class SlabGeometry(NamedTuple):
    wl: int        # words a lane (ceil(W / 32))
    lanes: int     # lanes a pair, A
    pairs: int     # pairs a warp, P
    warps: int     # warps a block
    row: int       # int32 words a staged row (pitch A mod 32)
    smem: int      # dynamic shared memory a block (slabs, mask tables)
    blocks: int    # blocks of 16 S pairs
    words: int     # uint32 words of the device scratch (0: registers)


def slab_geometry(N: int, W: int, S: int, BLK: int) -> SlabGeometry:
    """X1's launch geometry, as csrc/myers_micro.cu computes it."""
    wl = -(-W // 32)
    A = -(-W // wl)
    P = 32 // A
    pairs = pairs_per_block(S)
    warps = min(-(-pairs // P), MAX_WARPS)
    span = BLK + A - 1
    row = span + (A - span) % 32
    blocks = -(-N // pairs)
    words = 0 if wl <= REGISTER_WORDS else blocks * warps * PLANES * wl * 32
    peq = 5 * wl * 32 if wl <= REGISTER_WORDS else 0   # match-mask table
    return SlabGeometry(wl, A, P, warps, row,
                        warps * (2 * P * row + peq) * 4, blocks, words)


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
    if W < 1:
        raise ValueError("the planes hold no word (W = 0)")
    if S < 1 or BLK < 1:
        raise ValueError(f"S={S}, BLK={BLK}: need S >= 1 and BLK >= 1")
    geo = slab_geometry(N, W, S, BLK)
    if geo.smem > SMEM_MAX:
        raise ValueError(f"slabs of BLK={BLK} columns for {geo.warps} warps "
                         f"of {geo.pairs} pairs, two buffers each, take "
                         f"{geo.smem} bytes, which exceeds {SMEM_MAX} bytes "
                         "of shared memory a block")


def kernel_operands(qlen, tlen, q0, q1, vq, mend, t, S: int, BLK: int = 64):
    """The kernel's device operands: the caller's planes and targets as
    they are, the words' device scratch past REGISTER_WORDS words a lane
    (else None), and fresh outputs.  Raises, with the byte count, where
    device memory cannot hold the scratch."""
    N, Lt = t.shape
    geo = slab_geometry(N, q0.shape[1], S, BLK)
    scratch = None
    if geo.words:
        free, _ = torch.cuda.mem_get_info(t.device)
        if 4 * geo.words > free:
            raise ValueError(f"the words' device scratch takes "
                             f"{4 * geo.words} bytes; {free} are free")
        scratch = torch.empty(geo.words, dtype=torch.int32, device=t.device)
    outs = tuple(torch.empty(N, dtype=torch.int32, device=t.device)
                 for _ in range(2))
    return (q0, q1, vq, mend), t, qlen, tlen, scratch, outs


def run_kernel(planes, t, qlen, tlen, scratch, outs, S: int,
               BLK: int) -> None:
    """Launch X1 on the current stream."""
    q0, q1, vq, mend = planes
    N, Lt = t.shape
    dist, tend = outs
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = _lib().hga_myers_slab_launch(
            q0.data_ptr(), q1.data_ptr(), vq.data_ptr(), mend.data_ptr(),
            t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N, Lt,
            q0.shape[1], pairs_per_block(S), BLK,
            None if scratch is None else scratch.data_ptr(),
            dist.data_ptr(), tend.data_ptr(), stream)
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
    *ops, outs = kernel_operands(qlen, tlen, q0, q1, vq, mend, t, S, BLK)
    if t.shape[0]:
        with spans.launch("run_b_cuda"):
            run_kernel(*ops, outs, S, BLK)
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
            # the launches alone (X1's wrapper only allocates its outputs;
            # K1''s builds its route's operands)
            row["kernel_ms"] = time_ms(
                lambda *k: run_kernel(*k, S=S, BLK=BLK),
                [kernel_operands(*a, S=S, BLK=BLK) for a in sets], reps, dev)
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
