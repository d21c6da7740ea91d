"""L3 — the hand-written CUDA banded Smith-Waterman kernels (K3', K3) and
their wrapper.

``banded_sw_batch_cuda`` launches one of two kernels of ``csrc/sw.cu``,
both replacing the Pallas kernel ``_sw_kernel``
(hga_tpu/ops/align_pallas.py:66) — the scored refine of the short-read
overlap route (compute_overlaps and compute_overlaps_cross with
``overlap_refine="sw"``).  Both are bit-exact with the plain version
``ops.align.banded_sw_batch``.  The route follows from the shape alone
(``route``):

* ``"diag"``, K3' ``sw_diag_kernel<K>``: a warp per pair along the
  anti-diagonals, lane l holding query slots l*K .. l*K + K - 1, for
  Lq <= 256 (K = 1, 2, 4, 8, the smallest with 32 K >= Lq) when the warps'
  reversed target windows (Lt + 64 K int32 each) fit 227 KB of shared
  memory: 4 warps a block, 2 or 1 when 4 windows do not fit.  It reads the
  caller's row-major (N, L) codes.  Counted under ``banded_sw_batch_cuda``.
* ``"rows"``, K3 ``sw_kernel<SMEM>``: a thread per pair sweeping rows, for
  every other shape (any Lq; the row's 2 * band + 2 cells in shared memory,
  or in a device scratch above band 907).  It reads transposed (L, N)
  copies.  Counted under ``banded_sw_batch_cuda_rows``.

The band is clamped to max(Lq, Lt) first (the same cell set); for K3' it
only sets the per-slot bounds, for K3 it also sizes the row buffer.

What bounds K3' on an H100: about 12 int32 operations per in-band cell, but
32 K slot-steps per anti-diagonal whatever the band (see csrc/sw.cu and
PERF.md).

The wrapper checks dtype, shape and contiguity and raises on anything else.
On a CUDA tensor it launches the route's kernel (or raises: neither route
falls back on the other); on a CPU tensor it returns the plain version —
only because the tensor lies on the CPU, which is how the CPU tests run the
port.  The library is built at first use from ``csrc/sw.cu``
(ops/cuda_build.py) and loaded with ctypes; each launch goes on
``torch.cuda.current_stream()``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.ops.align import SWResult, banded_sw_batch, check_scores

# launches of each route's kernel by the wrapper (reset with reset_launches())
LAUNCHES: Dict[str, int] = {"banded_sw_batch_cuda": 0,
                            "banded_sw_batch_cuda_rows": 0}
ROUTE_COUNTER = {"diag": "banded_sw_batch_cuda",
                 "rows": "banded_sw_batch_cuda_rows"}

THREADS = 32               # K3 pairs a block (csrc/sw.cu kThreads)
DIAG_WARPS = (4, 2, 1)     # K3' pairs (warps) a block, in order of choice
DIAG_SLOTS = (1, 2, 4, 8)  # K3' query slots a lane
SMEM_MAX = 232448          # shared memory a block may opt in to (227 KB)

_LIB: Optional[ctypes.CDLL] = None


class Route(NamedTuple):
    kind: str       # "diag" (K3') or "rows" (K3)
    K: int          # K3' slots a lane (0 for rows)
    warps: int      # K3' warps a block (0 for rows)
    smem: int       # dynamic shared memory a block, bytes (0: device scratch)
    scratch: bool   # K3 with the device-memory scratch


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("sw"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_sw_diag_launch.argtypes = [vp] * 4 + [ci] * 9 + [vp] * 4
        lib.hga_sw_diag_launch.restype = ci
        lib.hga_sw_rows_launch.argtypes = [vp] * 4 + [ci] * 7 + [vp] * 5
        lib.hga_sw_rows_launch.restype = ci
        lib.hga_sw_attrs.argtypes = [ci, ci, ctypes.POINTER(ci),
                                     ctypes.POINTER(ci)]
        lib.hga_sw_attrs.restype = ci
        _LIB = lib
    return _LIB


def slots_per_lane(Lq: int) -> Optional[int]:
    """K3' slots a lane: the smallest K with 32 K >= Lq, None above 256."""
    return next((K for K in DIAG_SLOTS if 32 * K >= Lq), None)


def diag_smem_bytes(Lt: int, K: int, warps: int) -> int:
    """Shared memory of a K3' block: a reversed, padded target window of
    Lt + 64 K int32 per warp."""
    return warps * (Lt + 64 * K) * 4


def route(Lq: int, Lt: int, band: int) -> Route:
    """The kernel a shape takes: K3' where its slots hold the query and one
    warp's window fits shared memory, else K3 (with the device scratch
    when the clamped band's row buffer does not fit)."""
    K = slots_per_lane(Lq)
    if K is not None:
        for warps in DIAG_WARPS:
            smem = diag_smem_bytes(Lt, K, warps)
            if smem <= SMEM_MAX:
                return Route("diag", K, warps, smem, False)
    return rows_route(Lq, Lt, band)


def rows_route(Lq: int, Lt: int, band: int) -> Route:
    """K3: its row buffer in shared memory, or in the device scratch when
    the clamped band's 2 * band + 2 slots of 32 threads do not fit."""
    smem = (2 * min(band, max(Lq, Lt)) + 2) * THREADS * 4
    if smem <= SMEM_MAX:
        return Route("rows", 0, 0, smem, False)
    return Route("rows", 0, 0, 0, True)


def kernel_attrs(r: Route) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of the route's
    instantiation."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    kind = 0 if r.kind == "diag" else (2 if r.scratch else 1)
    err = _lib().hga_sw_attrs(kind, r.K, ctypes.byref(regs),
                              ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def check_operands(q, t, qlen, tlen) -> None:
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


def kernel_operands(q, t, qlen, tlen, band: int, rows: bool = False):
    """The kernel's device operands for one batch: the route (K3 when
    `rows`, which only timing comparisons ask for), the codes (as given for
    K3', transposed (L, N) for K3), lengths, the band clamped to
    max(Lq, Lt), K3's device scratch (else None) and fresh outputs."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, max(Lq, Lt))
    r = rows_route(Lq, Lt, band) if rows else route(Lq, Lt, band)
    outs = tuple(torch.empty(N, dtype=torch.int32, device=q.device)
                 for _ in range(3))
    if r.kind == "diag":
        return r, q, t, qlen, tlen, band, None, outs
    scratch = None
    if r.scratch:
        scratch = torch.empty((2 * band + 2, N), dtype=torch.int32,
                              device=q.device)
    return (r, q.t().contiguous(), t.t().contiguous(), qlen, tlen, band,
            scratch, outs)


def run_kernel(r: Route, q, t, qlen, tlen, band, scratch, outs, match=2,
               mismatch=-4, gap=-3) -> None:
    """Launch the route's kernel on the current stream (operands as
    kernel_operands returns them)."""
    if r.kind == "diag":
        (N, Lq), Lt = q.shape, t.shape[1]
    else:
        (Lq, N), Lt = q.shape, t.shape[0]
    score, qend, tend = outs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if r.kind == "diag":
            err = _lib().hga_sw_diag_launch(
                q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                N, Lq, Lt, band, match, mismatch, gap, r.K, r.warps,
                score.data_ptr(), qend.data_ptr(), tend.data_ptr(), stream)
        else:
            err = _lib().hga_sw_rows_launch(
                q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                N, Lq, Lt, band, match, mismatch, gap,
                None if scratch is None else scratch.data_ptr(),
                score.data_ptr(), qend.data_ptr(), tend.data_ptr(), stream)
    if err:
        raise RuntimeError(f"sw kernel ({r.kind} route) launch failed: CUDA "
                           f"error {err}")


def banded_sw_batch_cuda(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                         tlen: torch.Tensor, band: int = 64, match: int = 2,
                         mismatch: int = -4, gap: int = -3) -> SWResult:
    """K3' or K3 by shape: batched banded local SW, score + end cell;
    bit-exact with ops.align.banded_sw_batch.  q, t int32 (N, Lq), (N, Lt),
    lengths int32 (N,), on one CUDA device (CPU tensors: the plain
    version)."""
    check_operands(q, t, qlen, tlen)
    check_scores(band, gap)
    if not q.is_cuda:
        return banded_sw_batch(q, t, qlen, tlen, band=band, match=match,
                               mismatch=mismatch, gap=gap)
    r, *ops, outs = kernel_operands(q, t, qlen, tlen, band)
    if q.shape[0]:
        run_kernel(r, *ops, outs, match=match, mismatch=mismatch, gap=gap)
        LAUNCHES[ROUTE_COUNTER[r.kind]] += 1
    return SWResult(*outs)
