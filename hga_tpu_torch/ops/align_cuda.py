"""L3 — the hand-written CUDA banded Smith-Waterman kernel (K3) and its
wrapper.

``banded_sw_batch_cuda`` launches K3 (``csrc/sw.cu`` ``sw_kernel``), which
replaces the Pallas kernel ``_sw_kernel`` (hga_tpu/ops/align_pallas.py:66)
— the scored refine of the short-read overlap route (compute_overlaps and
compute_overlaps_cross with ``overlap_refine="sw"``).  Bit-exact with its
plain version ``ops.align.banded_sw_batch``.

What bounds it on an H100: about 12 int32 operations per in-band cell,
serial along a row within a pair; the design is the simple one (one thread
per pair, the row's band in shared memory, 32 threads a block) and runs
latency-bound above that (see csrc/sw.cu and PERF.md).

The wrapper checks dtype, shape and contiguity and raises on anything else.
On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
returns the plain version — only because the tensor lies on the CPU, which
is how the CPU tests run the port.  There is no fallback from a CUDA tensor
to the plain version.  The library is built at first use from
``csrc/sw.cu`` (ops/cuda_build.py) and loaded with ctypes; each launch goes
on ``torch.cuda.current_stream()``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.ops.align import SWResult, banded_sw_batch, check_scores

# launches of the kernel by its wrapper (reset with reset_launches())
LAUNCHES: Dict[str, int] = {"banded_sw_batch_cuda": 0}

THREADS = 32               # pairs per block (csrc/sw.cu kThreads)
SMEM_MAX = 232448          # shared memory a block may opt in to (227 KB)

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("sw"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_sw_launch.argtypes = [vp] * 4 + [ci] * 7 + [vp] * 5
        lib.hga_sw_launch.restype = ci
        lib.hga_sw_attrs.argtypes = [ci, ctypes.POINTER(ci),
                                     ctypes.POINTER(ci)]
        lib.hga_sw_attrs.restype = ci
        _LIB = lib
    return _LIB


def kernel_attrs(smem: bool = True) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of the shared-memory
    (or device-scratch) instantiation."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().hga_sw_attrs(int(smem), ctypes.byref(regs),
                              ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def _check(q, t, qlen, tlen) -> None:
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
    N = q.shape[0]
    if t.shape[0] != N or qlen.shape != (N,) or tlen.shape != (N,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, t "
                         f"{tuple(t.shape)}, qlen {tuple(qlen.shape)}, "
                         f"tlen {tuple(tlen.shape)}")


def kernel_operands(q, t, qlen, tlen, band: int):
    """The kernel's device operands for one batch: transposed codes (L, N),
    lengths, the band clamped to max(Lq, Lt) (the same cell set), the
    device scratch when the band does not fit shared memory (else None),
    and fresh outputs."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, max(Lq, Lt))
    scratch = None
    if (2 * band + 2) * THREADS * 4 > SMEM_MAX:
        scratch = torch.empty((2 * band + 2, N), dtype=torch.int32,
                              device=q.device)
    outs = tuple(torch.empty(N, dtype=torch.int32, device=q.device)
                 for _ in range(3))
    return (q.t().contiguous(), t.t().contiguous(), qlen, tlen, band,
            scratch, outs)


def run_kernel(qT, tT, qlen, tlen, band, scratch, outs, match=2,
               mismatch=-4, gap=-3) -> None:
    """Launch K3 on the current stream."""
    Lq, N = qT.shape
    Lt = tT.shape[0]
    score, qend, tend = outs
    with torch.cuda.device(qT.device):
        stream = torch.cuda.current_stream(qT.device).cuda_stream
        err = _lib().hga_sw_launch(
            qT.data_ptr(), tT.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            N, Lq, Lt, band, match, mismatch, gap,
            None if scratch is None else scratch.data_ptr(),
            score.data_ptr(), qend.data_ptr(), tend.data_ptr(), stream)
    if err:
        raise RuntimeError(f"sw kernel launch failed: CUDA error {err}")


def banded_sw_batch_cuda(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                         tlen: torch.Tensor, band: int = 64, match: int = 2,
                         mismatch: int = -4, gap: int = -3) -> SWResult:
    """K3: batched banded local SW, score + end cell; bit-exact with
    ops.align.banded_sw_batch.  q, t int32 (N, Lq), (N, Lt), lengths int32
    (N,), on one CUDA device (CPU tensors: the plain version)."""
    _check(q, t, qlen, tlen)
    check_scores(band, gap)
    if not q.is_cuda:
        return banded_sw_batch(q, t, qlen, tlen, band=band, match=match,
                               mismatch=mismatch, gap=gap)
    *ops, outs = kernel_operands(q, t, qlen, tlen, band)
    if q.shape[0]:
        run_kernel(*ops, outs, match=match, mismatch=mismatch, gap=gap)
        LAUNCHES["banded_sw_batch_cuda"] += 1
    return SWResult(*outs)
