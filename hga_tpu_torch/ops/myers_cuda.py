"""L3 — the two hand-written CUDA Myers kernels (K1, K2) and their wrappers.

Counterpart of ``hga_tpu.ops.myers_pallas``:

* ``myers_batch_cuda`` launches K1 (``csrc/myers.cu`` ``myers_kernel<W,
  false>``), which replaces the Pallas kernel ``_myers_kernel``
  (hga_tpu/ops/myers_pallas.py:47) — the long-read overlap gate.
* ``myers_batch_planes_cuda`` launches K2 (``myers_kernel<W, true>``), which
  replaces ``_myers_planes_kernel`` (hga_tpu/ops/myers_pallas.py:106) — the
  correction/polish DP whose Pv/Mv planes feed the traceback.

What bounds them on an H100: about 20 int32 ALU operations per word, column
and pair, serial within a pair — integer issue rate, and at the main path's
4096 pairs per launch (32 blocks of 128 threads on 132 SMs) occupancy; K2
also writes 2 * 4 * W bytes per pair and column (~24 MB per correction
batch) to device memory.  The design answers correctness first: one thread
per pair, words unrolled into registers by a W template, uint32 arithmetic,
coalesced column-major target reads.  Speed is later work (see PERF.md).

Each wrapper checks dtype, shape and contiguity and raises on anything
else.  On a CUDA tensor it launches its kernel (or raises); on a CPU tensor
it returns its plain version from ops/myers.py — only because the tensor
lies on the CPU, which is how the CPU tests run the port.  There is no
fallback from a CUDA tensor to the plain version.

The kernels are built at first use with nvcc (``-gencode
arch=compute_90a,code=sm_90a``) from ``csrc/myers.cu`` into
``hga_tpu_torch/_build/`` (ops/cuda_build.py), keyed by a hash of the source
and flags, and loaded with ctypes.  Each launch goes on
``torch.cuda.current_stream()``; the wrapper raises when the launch reports
an error.
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

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("myers"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_myers_launch.argtypes = [vp] * 7 + [ci, ci, ci] + [vp] * 5
        lib.hga_myers_launch.restype = ci
        lib.hga_myers_attrs.argtypes = [ci, ci, ctypes.POINTER(ci),
                                        ctypes.POINTER(ci)]
        lib.hga_myers_attrs.restype = ci
        _LIB = lib
    return _LIB


def kernel_attrs(W: int, planes: bool) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of one instantiation."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().hga_myers_attrs(W, int(planes), ctypes.byref(regs),
                                 ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


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


def kernel_operands(q, t, qlen, tlen, planes: bool):
    """The kernel's device operands for one batch: transposed query planes
    (W, N), transposed targets (Lt, N), lengths, and fresh outputs."""
    N, W, Lt = _check(q, t, qlen, tlen)
    dev = q.device
    qp = tuple(x.t().contiguous() for x in query_planes(q, qlen, W))
    outs = [torch.empty(N, dtype=torch.int32, device=dev) for _ in range(2)]
    if planes:
        outs += [torch.empty((Lt, N, W), dtype=torch.int32, device=dev)
                 for _ in range(2)]
    return qp, t.t().contiguous(), qlen, tlen, outs


def run_kernel(qp, tT, qlen, tlen, outs) -> None:
    """Launch K1 (two outputs) or K2 (four) on the current stream."""
    (q0, q1, vq, mend), (dist, tend) = qp, outs[:2]
    W, N = q0.shape
    Lt = tT.shape[0]
    pvp = outs[2].data_ptr() if len(outs) == 4 else None
    mvp = outs[3].data_ptr() if len(outs) == 4 else None
    with torch.cuda.device(q0.device):
        stream = torch.cuda.current_stream(q0.device).cuda_stream
        err = _lib().hga_myers_launch(
            q0.data_ptr(), q1.data_ptr(), vq.data_ptr(), mend.data_ptr(),
            tT.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N, Lt, W,
            dist.data_ptr(), tend.data_ptr(), pvp, mvp, stream)
    if err:
        raise RuntimeError(f"myers kernel launch failed: CUDA error {err}")


def _launch(q, t, qlen, tlen, planes: bool):
    qp, tT, qlen, tlen, outs = kernel_operands(q, t, qlen, tlen, planes)
    if q.shape[0]:
        run_kernel(qp, tT, qlen, tlen, outs)
        LAUNCHES["myers_batch_planes_cuda" if planes
                 else "myers_batch_cuda"] += 1
    res = MyersResult(dist=outs[0], tend=outs[1])
    return (res, outs[2], outs[3]) if planes else (res, None, None)


def myers_batch_cuda(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                     tlen: torch.Tensor) -> MyersResult:
    """K1: batched semi-global edit distance; bit-exact with
    ops.myers.myers_batch.  q, t int32 (N, Lq), (N, Lt) on one CUDA device
    (CPU tensors: the plain version)."""
    _check(q, t, qlen, tlen)
    if not q.is_cuda:
        return myers_batch(q, t, qlen, tlen)
    res, _, _ = _launch(q, t, qlen, tlen, planes=False)
    return res


def myers_batch_planes_cuda(q: torch.Tensor, t: torch.Tensor,
                            qlen: torch.Tensor, tlen: torch.Tensor):
    """K2: myers_batch_cuda + per-column Pv/Mv planes int32 (Lt, N, W);
    bit-exact with ops.myers.myers_batch_planes (CPU tensors: the plain
    version)."""
    _check(q, t, qlen, tlen)
    if not q.is_cuda:
        return myers_batch_planes(q, t, qlen, tlen)
    return _launch(q, t, qlen, tlen, planes=True)
