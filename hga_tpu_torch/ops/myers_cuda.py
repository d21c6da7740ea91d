"""L3 — the two hand-written CUDA Myers kernels (K1', K2) and their wrappers.

Counterpart of ``hga_tpu.ops.myers_pallas``:

* ``myers_batch_cuda`` launches K1' (``csrc/myers_gate.cu``
  ``myers_gate_kernel<W, G>``), which replaces the Pallas kernel
  ``_myers_kernel`` (hga_tpu/ops/myers_pallas.py:47) — the overlap gate of
  the long-read and short-read routes.  One pair runs on a group of G lanes,
  lane w owning query word w and taking target column s - w at step s (a
  pipeline across words), or on one thread (G = 1); the query bit-planes
  are built in the kernel from the caller's row-major (N, Lq) codes, and
  each warp stages its pairs' target rows in shared memory.  G comes from
  ``GATE_GROUP`` by W, a fixed table that the chip measurement filled in
  (chip_smoke.py phase 6, PERF.md).
* ``myers_batch_planes_cuda`` launches K2 (``csrc/myers.cu``
  ``myers_kernel<W>``), which replaces ``_myers_planes_kernel``
  (hga_tpu/ops/myers_pallas.py:106) — the correction/polish DP whose Pv/Mv
  planes feed the traceback: one thread per pair from query planes (W, N)
  and transposed (Lt, N) targets that its wrapper prepares.

What bounds them on an H100: about 20 int32 ALU operations per word, column
and pair (integer issue rate); K2 also writes 2 * 4 * W bytes per pair and
column (~24 MB per correction batch) to device memory.  See csrc/*.cu and
PERF.md for what each design does about it.

Each wrapper checks dtype, shape and contiguity and raises on anything
else.  On a CUDA tensor it launches its kernel (or raises); on a CPU tensor
it returns its plain version from ops/myers.py — only because the tensor
lies on the CPU, which is how the CPU tests run the port.  There is no
fallback from a CUDA tensor to the plain version.

The kernels are built at first use with nvcc (``-gencode
arch=compute_90a,code=sm_90a``) from ``csrc/myers_gate.cu`` and
``csrc/myers.cu`` into ``hga_tpu_torch/_build/`` (ops/cuda_build.py), keyed
by a hash of the source and flags, and loaded with ctypes.  Each launch
goes on ``torch.cuda.current_stream()``; the wrapper raises when the launch
reports an error.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.ops.myers import (MAX_WORDS, MyersResult, myers_batch,
                                     myers_batch_planes, n_words,
                                     query_planes)

# launches of each kernel by its wrapper (reset with reset_launches())
LAUNCHES: Dict[str, int] = {"myers_batch_cuda": 0,
                            "myers_batch_planes_cuda": 0}

THREADS = 128              # threads a block, both kernels


def group_width(W: int) -> int:
    """K1' lanes a pair in the split design: the smallest power of two
    >= W."""
    return 1 << (W - 1).bit_length()


# K1' lanes a pair (G) by query words W: 1 (a thread per pair) or
# group_width(W).  chip_smoke.py phase 6 times both at W 4, 5 and 14 (W 1
# has one design): the split design ran 1.6-2.4x faster at each on an H100
# (PERF.md), so every W takes it; each W between takes the choice of the
# nearest measured W.
GATE_GROUP: Dict[int, int] = {W: group_width(W)
                              for W in range(1, MAX_WORDS + 1)}

_LIB: Optional[ctypes.CDLL] = None        # K2 (csrc/myers.cu)
_GATE_LIB: Optional[ctypes.CDLL] = None   # K1' (csrc/myers_gate.cu)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("myers"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_myers_launch.argtypes = [vp] * 7 + [ci] * 3 + [vp] * 5
        lib.hga_myers_launch.restype = ci
        lib.hga_myers_attrs.argtypes = [ci] + [ctypes.POINTER(ci)] * 2
        lib.hga_myers_attrs.restype = ci
        _LIB = lib
    return _LIB


def _gate_lib() -> ctypes.CDLL:
    global _GATE_LIB
    if _GATE_LIB is None:
        lib = ctypes.CDLL(cuda_build.build("myers_gate"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_myers_gate_launch.argtypes = [vp] * 4 + [ci] * 5 + [vp] * 3
        lib.hga_myers_gate_launch.restype = ci
        lib.hga_myers_gate_attrs.argtypes = [ci, ci] + \
            [ctypes.POINTER(ci)] * 2
        lib.hga_myers_gate_attrs.restype = ci
        _GATE_LIB = lib
    return _GATE_LIB


def kernel_attrs(W: int, planes: bool = False,
                 group: Optional[int] = None) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of one instantiation:
    K2 at W, or K1' at W with `group` lanes a pair (GATE_GROUP's choice by
    default)."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    if planes:
        err = _lib().hga_myers_attrs(W, ctypes.byref(regs),
                                            ctypes.byref(local))
    else:
        err = _gate_lib().hga_myers_gate_attrs(
            W, group or GATE_GROUP[W], ctypes.byref(regs),
            ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def gate_blocks(N: int, G: int) -> int:
    """K1' blocks for N pairs: THREADS / G pairs a block."""
    return -(-N // (THREADS // G))


def _check(q, t, qlen, tlen) -> Tuple[int, int, int]:
    for name, x in (("q", q), ("t", t), ("qlen", qlen), ("tlen", tlen)):
        if x.device != q.device or x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"{name} lies on {x.device}; all operands must "
                             "lie on one CUDA device (or on the CPU)")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 2 or t.dim() != 2:
        raise ValueError("q and t must be 2-D (N, L)")
    N, Lq = q.shape
    if t.shape[0] != N or qlen.shape != (N,) or tlen.shape != (N,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, t "
                         f"{tuple(t.shape)}, qlen {tuple(qlen.shape)}, "
                         f"tlen {tuple(tlen.shape)}")
    W = n_words(Lq)
    if W > MAX_WORDS:
        raise ValueError(f"Lq={Lq} needs {W} words > {MAX_WORDS}")
    return N, W, t.shape[1]


def kernel_operands(q, t, qlen, tlen, group: Optional[int] = None):
    """K1' device operands for one batch: the caller's codes and lengths
    as they are, W, the lanes a pair (GATE_GROUP's choice unless `group`
    names 1 or group_width(W), which timing comparisons do), and fresh
    outputs."""
    N, W, _ = _check(q, t, qlen, tlen)
    G = GATE_GROUP[W] if group is None else group
    if G not in (1, group_width(W)):
        raise ValueError(f"group={G}: K1' runs 1 or {group_width(W)} lanes "
                         f"a pair at W={W}")
    outs = tuple(torch.empty(N, dtype=torch.int32, device=q.device)
                 for _ in range(2))
    return q, t, qlen, tlen, W, G, outs


def run_kernel(q, t, qlen, tlen, W, G, outs) -> None:
    """Launch K1' on the current stream."""
    (N, Lq), Lt = q.shape, t.shape[1]
    dist, tend = outs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _gate_lib().hga_myers_gate_launch(
            q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N,
            Lq, Lt, W, G, dist.data_ptr(), tend.data_ptr(), stream)
    if err:
        raise RuntimeError(f"myers gate kernel launch failed: CUDA error "
                           f"{err}")


def planes_operands(q, t, qlen, tlen):
    """K2's device operands for one batch: transposed query planes (W, N),
    transposed targets (Lt, N), lengths, and fresh outputs (dist, tend and
    the (Lt, N, W) Pv/Mv planes)."""
    N, W, Lt = _check(q, t, qlen, tlen)
    dev = q.device
    qp = tuple(x.t().contiguous() for x in query_planes(q, qlen, W))
    outs = [torch.empty(N, dtype=torch.int32, device=dev) for _ in range(2)]
    outs += [torch.empty((Lt, N, W), dtype=torch.int32, device=dev)
             for _ in range(2)]
    return qp, t.t().contiguous(), qlen, tlen, outs


def run_planes_kernel(qp, tT, qlen, tlen, outs) -> None:
    """Launch K2 on the current stream."""
    (q0, q1, vq, mend), (dist, tend, pvp, mvp) = qp, outs
    W, N = q0.shape
    Lt = tT.shape[0]
    with torch.cuda.device(q0.device):
        stream = torch.cuda.current_stream(q0.device).cuda_stream
        err = _lib().hga_myers_launch(
            q0.data_ptr(), q1.data_ptr(), vq.data_ptr(), mend.data_ptr(),
            tT.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N, Lt, W,
            dist.data_ptr(), tend.data_ptr(), pvp.data_ptr(), mvp.data_ptr(),
            stream)
    if err:
        raise RuntimeError(f"myers kernel launch failed: CUDA error {err}")


def myers_batch_cuda(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                     tlen: torch.Tensor) -> MyersResult:
    """K1': batched semi-global edit distance; bit-exact with
    ops.myers.myers_batch.  q, t int32 (N, Lq), (N, Lt) on one CUDA device
    (CPU tensors: the plain version)."""
    _check(q, t, qlen, tlen)
    if not q.is_cuda:
        return myers_batch(q, t, qlen, tlen)
    *ops, outs = kernel_operands(q, t, qlen, tlen)
    if q.shape[0]:
        run_kernel(*ops, outs)
        LAUNCHES["myers_batch_cuda"] += 1
    return MyersResult(*outs)


def myers_batch_planes_cuda(q: torch.Tensor, t: torch.Tensor,
                            qlen: torch.Tensor, tlen: torch.Tensor):
    """K2: myers_batch_cuda + per-column Pv/Mv planes int32 (Lt, N, W);
    bit-exact with ops.myers.myers_batch_planes (CPU tensors: the plain
    version)."""
    _check(q, t, qlen, tlen)
    if not q.is_cuda:
        return myers_batch_planes(q, t, qlen, tlen)
    qp, tT, qlen, tlen, outs = planes_operands(q, t, qlen, tlen)
    if q.shape[0]:
        run_planes_kernel(qp, tT, qlen, tlen, outs)
        LAUNCHES["myers_batch_planes_cuda"] += 1
    return MyersResult(dist=outs[0], tend=outs[1]), outs[2], outs[3]
