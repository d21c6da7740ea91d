"""L3 — the hand-written CUDA banded Smith-Waterman kernels (K3', K3'',
K3''', and K3 forced) and their wrapper.

``banded_sw_batch_cuda`` launches one of the kernels of ``csrc/sw.cu``,
each replacing the Pallas kernel ``_sw_kernel``
(hga_tpu/ops/align_pallas.py:66) — the scored refine of the short-read
overlap route (compute_overlaps and compute_overlaps_cross with
``overlap_refine="sw"``).  All are bit-exact with the plain version
``ops.align.banded_sw_batch``.  The route follows from the shape alone
(``route``), with the band clamped to max(Lq, Lt) first (the same cell
set):

* ``"diag"``, K3' ``sw_diag_kernel<K>``: a warp per pair along the
  anti-diagonals, lane l holding query slots l*K .. l*K + K - 1, for
  Lq <= 256 (K = 1, 2, 4, 8, the smallest with 32 K >= Lq) when the warps'
  reversed target windows (Lt + 64 K int32 each) fit 227 KB of shared
  memory: 4 warps a block, 2 or 1 when 4 windows do not fit.  Counted
  under ``banded_sw_batch_cuda``.
* ``"band"``, K3'' ``sw_band_kernel<K>``: a warp per pair along the
  anti-diagonals over a window of band + 1 slots that moves with the band
  (K = 1 .. 8, the smallest with 32 K >= band + 1), for the other shapes
  whose band + 1 <= 256 and whose staged query and reversed target
  (``band_geometry``) fit: 4 warps a block, 2 or 1 when 4 do not.  It
  serves the 300 bp refine's Lq 320 among others.  Counted under
  ``banded_sw_batch_cuda_band``.
* ``"wide"``, K3''' ``sw_wide_kernel<K>`` / ``sw_wide_mem_kernel``: every
  other shape (a clamped band above 255, or a query too long for the band
  route's windows), at any band and length.  The band + 1 slots of an
  anti-diagonal go across the lanes and the warps of a block (32 K a warp,
  ``wide_route``: nw = ceil((band + 1) / 256) warps a pair up to 8, 4
  pairs a block at one warp a pair); the windows are staged a chunk of
  ``WIDE_CHUNK`` anti-diagonals at a time, so shared memory does not grow
  with Lq.  Past 2048 slots the slots live in memory: two rows of
  band + 3 int32 in shared memory up to band 29,053, past it in a device
  scratch (N, 2, band + 3).  Counted under ``banded_sw_batch_cuda_wide``.

``"rows"``, K3 ``sw_kernel<SMEM>`` (a thread per pair sweeping rows, from
transposed (L, N) copies), takes no shape since K3''': only timing
comparisons force it (``kernel_operands(..., kind="rows")``), beside K3'''
on the same inputs; its counter ``banded_sw_batch_cuda_rows`` stays 0.

The kernels read the caller's row-major (N, L) codes.  What bounds them
on an H100: about 12 int32 operations per in-band cell, but K3' sweeps
32 K >= Lq slot-steps per anti-diagonal whatever the band, K3'' and K3'''
32 K nw >= band + 1 (see csrc/sw.cu and PERF.md).

The wrapper checks dtype, shape and contiguity and raises on anything else.
On a CUDA tensor it launches the route's kernel (or raises: no route falls
back on another); on a CPU tensor it returns the plain version — only
because the tensor lies on the CPU, which is how the CPU tests run the
port.  The library is built at first use from ``csrc/sw.cu``
(ops/cuda_build.py) and loaded with ctypes; each launch goes on
``torch.cuda.current_stream()``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.ops.align import SWResult, banded_sw_batch, check_scores
from hga_tpu_torch.utils import spans

# the name of each route's launches by the wrapper (spans.launch: a span and
# a counter of the registry, utils/spans)
ROUTE_COUNTER = {"diag": "banded_sw_batch_cuda",
                 "band": "banded_sw_batch_cuda_band",
                 "wide": "banded_sw_batch_cuda_wide",
                 "rows": "banded_sw_batch_cuda_rows"}

THREADS = 32               # K3 pairs a block (csrc/sw.cu kThreads)
DIAG_WARPS = (4, 2, 1)     # K3' and K3'' pairs (warps) a block, by choice
DIAG_SLOTS = (1, 2, 4, 8)  # K3' query slots a lane
BAND_SLOTS = tuple(range(1, 9))  # K3'' window slots a lane: bands <= 255
SMEM_MAX = 232448          # shared memory a block may opt in to (227 KB)
WIDE_CHUNK = 256           # K3''' anti-diagonals a staged window serves
WIDE_SLOTS = 8             # K3''' most register slots a lane
WIDE_WARPS = 8             # K3''' most warps a pair (and a block)
WIDE_PAIRS = 4             # K3''' pairs a block at one warp a pair
MEM_THREADS = 512          # K3''' threads a pair with the slots in memory

_LIB: Optional[ctypes.CDLL] = None


class Route(NamedTuple):
    kind: str       # "diag" (K3'), "band" (K3''), "wide" (K3''') or "rows"
    K: int          # slots a lane (0 for rows and K3''' slots in memory)
    warps: int      # warps a block (0 for rows)
    smem: int       # dynamic shared memory a block, bytes (0: device scratch)
    scratch: bool   # K3 or K3''' with the device-memory scratch
    nw: int = 1     # K3''' warps a pair (pairs a block = warps // nw)


class BandGeometry(NamedTuple):
    """The staged windows of one K3'' pair (csrc/sw.cu band_geom): qs[x] =
    q[qlo + x] for x < qwin, ts[y] = t[thi - y] for y < twin, -1 outside
    the codes."""
    qlo: int
    qwin: int
    thi: int
    twin: int


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("sw"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.hga_sw_diag_launch, lib.hga_sw_band_launch):
            fn.argtypes = [vp] * 4 + [ci] * 9 + [vp] * 4
            fn.restype = ci
        lib.hga_sw_rows_launch.argtypes = [vp] * 4 + [ci] * 7 + [vp] * 5
        lib.hga_sw_rows_launch.restype = ci
        lib.hga_sw_wide_launch.argtypes = [vp] * 4 + [ci] * 10 + [vp] * 5
        lib.hga_sw_wide_launch.restype = ci
        lib.hga_sw_attrs.argtypes = [ci, ci, ctypes.POINTER(ci),
                                     ctypes.POINTER(ci)]
        lib.hga_sw_attrs.restype = ci
        lib.hga_sw_occupancy.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
        lib.hga_sw_occupancy.restype = ci
        _LIB = lib
    return _LIB


def slots_per_lane(Lq: int) -> Optional[int]:
    """K3' slots a lane: the smallest K with 32 K >= Lq, None above 256."""
    return next((K for K in DIAG_SLOTS if 32 * K >= Lq), None)


def band_slots(band: int) -> Optional[int]:
    """K3'' slots a lane: the smallest K with 32 K >= band + 1, None above
    band 255."""
    return next((K for K in BAND_SLOTS if 32 * K >= band + 1), None)


def diag_smem_bytes(Lt: int, K: int, warps: int) -> int:
    """Shared memory of a K3' block: a reversed, padded target window of
    Lt + 64 K int32 per warp."""
    return warps * (Lt + 64 * K) * 4


def _ceil_half(x: int) -> int:
    return -((-x) // 2)


def band_geometry(Lq: int, Lt: int, band: int, K: int) -> BandGeometry:
    """The K3'' windows: every slot s < 32 K of every anti-diagonal d from 1
    to dmax + 1 (dmax = Lq + min(Lt, Lq + band), the last any pair can
    reach; the kernel steps in pairs) reads query code i0(d) + s - 1 and
    target code f(d) - s - 1, i0(d) = ceil((d - band) / 2), f(d) =
    d - i0(d), inside them."""
    S = 32 * K
    dmax = max(Lq + min(Lt, Lq + band), 2)
    i1, ie = _ceil_half(1 - band), _ceil_half(dmax + 1 - band)
    qlo = i1 - 1
    thi = (dmax + 1 - ie) - 1
    return BandGeometry(qlo, ie + S - 2 - qlo + 1, thi,
                        thi - ((1 - i1) - S) + 1)


def band_smem_bytes(Lq: int, Lt: int, band: int, K: int, warps: int) -> int:
    """Shared memory of a K3'' block: each warp's staged query and reversed
    target windows, int32."""
    g = band_geometry(Lq, Lt, band, K)
    return warps * (g.qwin + g.twin) * 4


def diag_route(Lq: int, Lt: int, band: int) -> Optional[Route]:
    """K3' where its slots hold the query and a warp's window fits."""
    K = slots_per_lane(Lq)
    if K is not None:
        for warps in DIAG_WARPS:
            smem = diag_smem_bytes(Lt, K, warps)
            if smem <= SMEM_MAX:
                return Route("diag", K, warps, smem, False)
    return None


def band_route(Lq: int, Lt: int, band: int) -> Optional[Route]:
    """K3'' where the clamped band's window has at most 256 slots and a
    warp's staged codes fit."""
    band = min(band, max(Lq, Lt))
    K = band_slots(band)
    if K is not None:
        for warps in DIAG_WARPS:
            smem = band_smem_bytes(Lq, Lt, band, K, warps)
            if smem <= SMEM_MAX:
                return Route("band", K, warps, smem, False)
    return None


def rows_route(Lq: int, Lt: int, band: int) -> Route:
    """K3 (forced only): its row buffer in shared memory, or in the device
    scratch when the clamped band's 2 * band + 2 slots of 32 threads do not
    fit."""
    smem = (2 * min(band, max(Lq, Lt)) + 2) * THREADS * 4
    if smem <= SMEM_MAX:
        return Route("rows", 0, 0, smem, False)
    return Route("rows", 0, 0, 0, True)


def wide_smem_bytes(K: int, nw: int, pairs: int) -> int:
    """Shared memory of a K3''' block with register slots: each pair's query
    and reversed target windows of WIDE_CHUNK / 2 + 32 K nw int32 and two
    exchange words a warp."""
    return pairs * (2 * (WIDE_CHUNK // 2 + 32 * K * nw) + 2 * nw) * 4


def wide_route(Lq: int, Lt: int, band: int, scratch: bool = False) -> Route:
    """K3''' at any shape: the clamped band's band + 1 slots in registers,
    on nw = ceil((band + 1) / 256) warps a pair of 32 K slots each (K the
    smallest that holds them; 4 pairs a block at nw = 1), up to WIDE_WARPS
    warps; past that in memory, two rows of band + 3 int32 in shared memory
    where they fit SMEM_MAX, else (or with `scratch`, which tests and timing
    comparisons force) in the device scratch."""
    band = min(band, max(Lq, Lt))
    S = band + 1
    if not scratch and S <= 32 * WIDE_SLOTS * WIDE_WARPS:
        nw = -(-S // (32 * WIDE_SLOTS))
        K = -(-S // (32 * nw))
        pairs = WIDE_PAIRS if nw == 1 else 1
        return Route("wide", K, nw * pairs, wide_smem_bytes(K, nw, pairs),
                     False, nw)
    rows = 2 * (band + 3) * 4
    warps = MEM_THREADS // 32
    if rows <= SMEM_MAX and not scratch:
        return Route("wide", 0, warps, rows, False, warps)
    return Route("wide", 0, warps, 0, True, warps)


_ROUTES = {"diag": diag_route, "band": band_route, "wide": wide_route,
           "rows": rows_route}


def route(Lq: int, Lt: int, band: int) -> Route:
    """The kernel a shape takes: K3', else K3'', else K3'''."""
    return (diag_route(Lq, Lt, band) or band_route(Lq, Lt, band)
            or wide_route(Lq, Lt, band))


def _instance(r: Route) -> int:
    """csrc/sw.cu's number of the route's kernel (with_kernel)."""
    if r.kind == "wide":
        return 5 if r.scratch else 4
    return {"diag": 0, "band": 3}.get(r.kind, 2 if r.scratch else 1)


def kernel_attrs(r: Route) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of the route's
    instantiation."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().hga_sw_attrs(_instance(r), r.K, ctypes.byref(regs),
                              ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def warps_per_sm(r: Route) -> int:
    """Warps of the route's kernel one SM holds at once (CUDA's occupancy
    calculator at the route's threads and shared memory a block)."""
    blocks = ctypes.c_int()
    threads = 32 * r.warps if r.warps else THREADS
    err = _lib().hga_sw_occupancy(_instance(r), r.K, threads, r.smem,
                                  ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"the occupancy query failed with error {err}")
    return blocks.value * threads // 32


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


def kernel_operands(q, t, qlen, tlen, band: int, kind: Optional[str] = None,
                    scratch: bool = False):
    """The kernel's device operands for one batch: the route (the shape's
    own, or the kernel `kind` names, which only timing comparisons and
    tests ask for; with "wide", `scratch` forces its slots into the device
    scratch), the codes (as given, transposed
    (L, N) for K3), lengths, the band clamped to max(Lq, Lt), the device
    scratch of K3 or K3''' (else None) and fresh outputs."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, max(Lq, Lt))
    if kind == "wide":
        r = wide_route(Lq, Lt, band, scratch)
    else:
        r = route(Lq, Lt, band) if kind is None else \
            _ROUTES[kind](Lq, Lt, band)
    if r is None:
        raise ValueError(f"the {kind} route does not take Lq {Lq}, Lt {Lt}, "
                         f"band {band}")
    outs = tuple(torch.empty(N, dtype=torch.int32, device=q.device)
                 for _ in range(3))
    rows = None
    if r.kind == "wide" and r.scratch:
        rows = torch.empty((N, 2, band + 3), dtype=torch.int32,
                           device=q.device)
    if r.kind != "rows":
        return r, q, t, qlen, tlen, band, rows, outs
    if r.scratch:
        rows = torch.empty((2 * band + 2, N), dtype=torch.int32,
                           device=q.device)
    return (r, q.t().contiguous(), t.t().contiguous(), qlen, tlen, band,
            rows, outs)


def run_kernel(r: Route, q, t, qlen, tlen, band, scratch, outs, match=2,
               mismatch=-4, gap=-3) -> None:
    """Launch the route's kernel on the current stream (operands as
    kernel_operands returns them)."""
    if r.kind != "rows":
        (N, Lq), Lt = q.shape, t.shape[1]
    else:
        (Lq, N), Lt = q.shape, t.shape[0]
    score, qend, tend = outs
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        head = (q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                N, Lq, Lt, band, match, mismatch, gap)
        tail = (score.data_ptr(), qend.data_ptr(), tend.data_ptr(), stream)
        if r.kind == "wide":
            err = _lib().hga_sw_wide_launch(*head, r.K, r.nw,
                                            r.warps // r.nw, ptr(scratch),
                                            *tail)
        elif r.kind != "rows":
            launch = (_lib().hga_sw_diag_launch if r.kind == "diag"
                      else _lib().hga_sw_band_launch)
            err = launch(*head, r.K, r.warps, *tail)
        else:
            err = _lib().hga_sw_rows_launch(*head, ptr(scratch), *tail)
    if err:
        raise RuntimeError(f"sw kernel ({r.kind} route) launch failed: CUDA "
                           f"error {err}")


def banded_sw_batch_cuda(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                         tlen: torch.Tensor, band: int = 64, match: int = 2,
                         mismatch: int = -4, gap: int = -3) -> SWResult:
    """K3', K3'' or K3''' by shape: batched banded local SW, score + end cell;
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
        with spans.launch(ROUTE_COUNTER[r.kind]):
            run_kernel(r, *ops, outs, match=match, mismatch=mismatch,
                       gap=gap)
    return SWResult(*outs)
