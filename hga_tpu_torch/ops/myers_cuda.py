"""L3 — the hand-written CUDA Myers kernels (K1', K2, K2') and wrappers.

Counterpart of ``hga_tpu.ops.myers_pallas``:

* ``myers_batch_cuda`` launches K1' (``csrc/myers_gate.cu``
  ``myers_gate_kernel<W, G, WIN>``), which replaces the Pallas kernel
  ``_myers_kernel`` (hga_tpu/ops/myers_pallas.py:47) — the overlap gate of
  the long-read and short-read routes.  One pair runs on a group of G lanes,
  lane w owning query words w * WL .. and taking target column s - w at
  step s (a pipeline across words), or on one thread (G = 1); the query
  bit-planes are built in the kernel from the caller's row-major (N, Lq)
  codes, and each warp stages its pairs' target rows in shared memory.  Two
  routes by W (``gate_route``): the register route up to
  ``REGISTER_MAX_WORDS`` (34: queries up to 1054 bases), W compiled in and
  G from ``GATE_GROUP``, a fixed table that the chip measurement filled in
  (chip_smoke.py phase 6, PERF.md); the wide route past it at any W (one
  pair a warp, the words in shared memory or a device scratch; counted
  apart, ``myers_batch_cuda_wide``).  A one-row target (1, Lt) for N > 1
  pairs is the shared-target mode (utils/evalx.segment_identity): every
  pair runs against that row, which each block stages once; it counts
  apart (``myers_batch_cuda_shared``).  Where few pairs meet many columns
  the launch splits the target's columns into S windows (``gate_window``),
  each restarting the DP a halo before its own columns, exact by the span
  bound of ops/myers.window_halo.
* ``myers_cols_cuda`` launches K1''s carried-state mode (the same kernel
  with ``carry`` = 1, windows too; counted as ``myers_batch_cuda_carry``):
  it starts from a given column state (pv, mv, score, best, bj) and returns
  the state it ends in, over a target chunk whose first column is global
  column j0 — each step of the ring engine (parallel/ring_myers.py).  Its
  plain version is ``ops/myers.myers_cols``.
* ``myers_votes_cuda`` launches K2' (``csrc/myers_votes.cu``
  ``myers_votes_kernel<G, WL, SMEM>``), which replaces
  ``_myers_planes_kernel`` (hga_tpu/ops/myers_pallas.py:106) on the
  correction and polish paths: one launch per batch runs K1''s split DP
  with the Pv/Mv planes kept on chip, the float32 identity gate, the plane
  traceback and the vote atomics into the flat vote buffer.  Its plain
  version is ``ops/pileup.myers_votes``.  ``votes_route`` picks the planes'
  home by shape: shared memory where a warp's planes fit a block, else a
  device scratch (counted apart, ``myers_votes_cuda_scratch``); past
  REGISTER_MAX_WORDS the wide route (``myers_votes_cuda_wide``), planes on
  the scratch.  A batch whose scratch passes ``VOTES_SCRATCH_BYTES`` runs
  in sub-batches, one launch each.
* ``myers_batch_planes_cuda`` launches K2s (``csrc/myers.cu``
  ``myers_planes_kernel<W, G>``), which replaces ``_myers_planes_kernel``
  (hga_tpu/ops/myers_pallas.py:106) as the port of the public planes
  function ``myers_batch_planes_pallas``: K1''s split DP (a pair on
  group_width(W) lanes, the skewed schedule, Eq words built in the kernel
  from the caller's (N, Lq) codes) with the Pv/Mv planes (Lt, N, W)
  written to device memory, each warp's columns regrouped in a shared
  ring so that a column's words of its pairs leave as one contiguous run.
  Two routes by W (``planes_route``): the register route up to
  REGISTER_MAX_WORDS, the wide route past it (counted apart,
  ``myers_batch_planes_cuda_wide``).  The planes take 2 x Lt x N x W x 4
  bytes; a batch whose planes device memory cannot hold raises with that
  count.  Only exp/bench_corr_tb runs it.  K2 (``myers_kernel<W>``, one
  thread a pair from query planes and transposed targets the wrapper
  prepares, W 1-24) runs only when a timing comparison forces it
  (``planes_operands(..., thread=True)``).

What bounds them on an H100: about 20 int32 ALU operations per word, column
and pair (integer throughput), plus about 40 a traceback step in K2'; K2
also writes 2 * 4 * W bytes per pair and column (~24 MB per correction
batch) to device memory.  See csrc/*.cu and PERF.md for what each design
does about it.

Each wrapper checks dtype, shape and contiguity and raises on anything
else.  On a CPU tensor it returns its plain version (ops/myers.py,
ops/pileup.py) — only because the tensor lies on the CPU, which is how the
CPU tests run the port.  On a CUDA tensor it launches its kernel or
raises; there is no fallback from a CUDA tensor to the plain version.
K1', K2' and K2s take any number of query words; the only raises left are
a K2' scratch or K2s planes that device memory cannot hold, with the byte
count.

The kernels are built at first use with nvcc (``-gencode
arch=compute_90a,code=sm_90a``) from ``csrc/myers_gate.cu``,
``csrc/myers_votes.cu`` and ``csrc/myers.cu`` into ``hga_tpu_torch/_build/``
(ops/cuda_build.py), keyed by a hash of the source and flags, and loaded
with ctypes.  Each launch goes on ``torch.cuda.current_stream()``; the
wrapper raises when the launch reports an error.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.ops.myers import (MyersResult, myers_batch,
                                     myers_batch_planes, myers_cols, n_words,
                                     pack_state, query_planes, state_result,
                                     unpack_state, window_halo)
from hga_tpu_torch.ops.pileup import myers_votes
from hga_tpu_torch.utils import spans

# each wrapper names its launches by the route it took (spans.launch: a span
# and a counter of the registry, utils/spans): K1' counts its wide route and
# its two modes apart, K2' its plane homes and its wide route
LAUNCH_COUNTERS = ("myers_batch_cuda", "myers_batch_cuda_wide",
                   "myers_batch_cuda_shared", "myers_batch_cuda_carry",
                   "myers_votes_cuda", "myers_votes_cuda_scratch",
                   "myers_votes_cuda_wide", "myers_batch_planes_cuda",
                   "myers_batch_planes_cuda_wide")

THREADS = 128              # threads a block, K1', K2s and K2
GATE_WARPS = THREADS // 32
THREAD_MAX_WORDS = 24      # W the forced K2 unrolls into one thread
SINGLE_MAX_WORDS = 24      # W K1' takes at one thread a pair (G 1)
# W K1' and K2' compile into registers (the register route: one word a
# lane up to 32, two at 33-34); past it both take the wide route, W at run
# time with each lane's words in memory
REGISTER_MAX_WORDS = 34
WORD_PLANES = 5            # uint32 words of a query word on the wide route
SMEM_MAX = 232448          # shared memory a block may opt in to (227 KB)
SMEM_SM = 233472           # shared memory of an SM (228 KB) ...
SMEM_RESERVED = 1024       # ... of which each resident block reserves 1 KB
# dynamic shared memory K1''s wide route may take a block for its words (the
# rest of SMEM_MAX holds the staged targets); past it they go to a scratch
GATE_WIDE_SMEM = SMEM_MAX - 4096
STAGE_COLUMNS = 128        # K2' target columns a warp stages at a time
# K2' keeps its planes in shared memory only where an SM holds at least
# this many such blocks: with 1-3 the device scratch ran 1.6-3.2x faster,
# with 4 (the correction shape) shared memory ran 1.4x faster (NVIDIA H100
# 80GB HBM3 at 700 W, chip_smoke.py phase 6's two-home rows, PERF.md)
VOTES_SMEM_MIN_BLOCKS = 4
# device scratch one K2' launch may take for its planes (and words); a
# batch that needs more runs in sub-batches of whole warps, one launch each
VOTES_SCRATCH_BYTES = 2 << 30
# K1''s target windows aim at this many warps launched on each SM.  At the
# shared-row modes' 1 Mb shapes (NVIDIA H100 80GB HBM3 at 700 W,
# chip_smoke.py phase 6's window rows, PERF.md) 32, 64 and 128 ran: the
# carried-state step 35.26, 32.63 and 31.80 ms (S 13, 26, 52), the
# shared-target mode 250.64, 251.33 and 241.02 ms (S 4, 7, 14); 128 was the
# fastest of the three in both modes.  With windows compiled out of S 1
# (WIN), 128 ran 30.48 / 234.68 ms and 256 30.96 / 230.28
WINDOW_WARPS_SM = 128
SMS = 132                  # SMs of an H100 SXM: the windows of CPU shapes


def group_width(W: int) -> int:
    """K1' and K2' lanes a pair in the split design: the smallest power of
    two >= W, at most a warp's 32 (two words a lane at W 33-34, more on the
    wide route)."""
    return min(1 << (W - 1).bit_length(), 32)


# K1' lanes a pair (G) by query words W on the register route: 1 (a thread
# per pair) or group_width(W).  chip_smoke.py phase 6 times both at W 4, 5
# and 14 (W 1 has one design): the split design ran 1.6-2.4x faster at each
# on an H100 (PERF.md), so every W takes it; each W between takes the
# choice of the nearest measured W.  W 25-34 exist in the split design
# only; the wide route runs 32 lanes a pair.
GATE_GROUP: Dict[int, int] = {W: group_width(W)
                              for W in range(1, REGISTER_MAX_WORDS + 1)}

_LIB: Optional[ctypes.CDLL] = None        # K2s and K2 (csrc/myers.cu)
_GATE_LIB: Optional[ctypes.CDLL] = None   # K1' (csrc/myers_gate.cu)
_VOTES_LIB: Optional[ctypes.CDLL] = None  # K2' (csrc/myers_votes.cu)
_SMS: Dict[int, int] = {}                 # SMs by CUDA device index


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("myers"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_myers_launch.argtypes = [vp] * 7 + [ci] * 3 + [vp] * 5
        lib.hga_myers_launch.restype = ci
        lib.hga_myers_attrs.argtypes = [ci] + [ctypes.POINTER(ci)] * 2
        lib.hga_myers_attrs.restype = ci
        lib.hga_myers_planes_launch.argtypes = ([vp] * 4 + [ci] * 6 + [vp]
                                                + [ci] + [vp] * 5)
        lib.hga_myers_planes_launch.restype = ci
        lib.hga_myers_planes_attrs.argtypes = [ci] * 2 + \
            [ctypes.POINTER(ci)] * 2
        lib.hga_myers_planes_attrs.restype = ci
        _LIB = lib
    return _LIB


def _gate_lib() -> ctypes.CDLL:
    global _GATE_LIB
    if _GATE_LIB is None:
        lib = ctypes.CDLL(cuda_build.build("myers_gate"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_myers_gate_launch.argtypes = ([vp] * 4 + [ci] * 8 + [vp] * 2
                                              + [ci] * 3 + [vp] * 2 + [ci]
                                              + [vp] * 3)
        lib.hga_myers_gate_launch.restype = ci
        lib.hga_myers_gate_attrs.argtypes = [ci] * 4 + \
            [ctypes.POINTER(ci)] * 2
        lib.hga_myers_gate_attrs.restype = ci
        _GATE_LIB = lib
    return _GATE_LIB


def _votes_lib() -> ctypes.CDLL:
    global _VOTES_LIB
    if _VOTES_LIB is None:
        lib = ctypes.CDLL(cuda_build.build("myers_votes"))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hga_myers_votes_launch.argtypes = (
            [vp] * 8 + [ci] * 10 + [cl] * 3 + [ctypes.c_float] + [vp] * 6)
        lib.hga_myers_votes_launch.restype = ci
        lib.hga_myers_votes_attrs.argtypes = [ci] * 3 + \
            [ctypes.POINTER(ci)] * 2
        lib.hga_myers_votes_attrs.restype = ci
        lib.hga_myers_votes_occupancy.argtypes = [ci] * 4 + \
            [ctypes.POINTER(ci)]
        lib.hga_myers_votes_occupancy.restype = ci
        _VOTES_LIB = lib
    return _VOTES_LIB


def _sms(dev: torch.device) -> int:
    """SMs of a CUDA device (SMS for the CPU)."""
    if dev.type != "cuda":
        return SMS
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def kernel_attrs(W: int, planes: bool = False, group: Optional[int] = None,
                 wide: bool = False, windows: bool = False,
                 thread: bool = False) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of one instantiation:
    K2s at W with `planes` (K2 with `thread`), or K1' at W with `group`
    lanes a pair (GATE_GROUP's choice by default); K1' and K2s on the wide
    route past REGISTER_MAX_WORDS or when `wide`, K1' with target windows
    (S > 1) when `windows`."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    wl = wide_words(W) if wide or W > REGISTER_MAX_WORDS else 0
    if planes and thread:
        err = _lib().hga_myers_attrs(W, ctypes.byref(regs),
                                     ctypes.byref(local))
    elif planes:
        err = _lib().hga_myers_planes_attrs(W, wl, ctypes.byref(regs),
                                            ctypes.byref(local))
    else:
        G = 32 if wl else group or GATE_GROUP[W]
        err = _gate_lib().hga_myers_gate_attrs(
            W, G, wl, int(windows), ctypes.byref(regs), ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def wide_words(W: int) -> int:
    """Words a lane on the wide route: W over a warp's 32 lanes."""
    return -(-W // 32)


def gate_designs(W: int) -> Tuple[int, ...]:
    """K1''s lanes a pair at W words: 1 and group_width(W) up to
    SINGLE_MAX_WORDS, group_width(W) alone past it (32 on the wide
    route)."""
    if W <= SINGLE_MAX_WORDS:
        return tuple(sorted({1, group_width(W)}))
    return (group_width(W),)


def gate_blocks(N: int, G: int) -> int:
    """K1' blocks for N pairs: THREADS / G pairs a block."""
    return -(-N // (THREADS // G))


def gate_window(N: int, W: int, G: int, Lt: int, sms: int = SMS) -> int:
    """Owned columns of each of K1''s target windows: enough windows for
    about WINDOW_WARPS_SM warps launched on each of `sms` SMs, none shorter
    than 4 halos (so the halo costs at most a quarter); one window (Lt
    columns) below 8 halos."""
    H = window_halo(W)
    if Lt < 8 * H:
        return max(Lt, 1)
    warps = -(-N // (32 // G))
    S = min(-(-sms * WINDOW_WARPS_SM // warps), Lt // (4 * H), 65535)
    return -(-Lt // max(S, 1))


class GateRoute(NamedTuple):
    W: int          # query words
    G: int          # lanes a pair
    wl: int         # words a lane on the wide route; 0 the register route
    S: int          # target windows (blockIdx.y)
    window: int     # owned columns a window
    halo: int       # columns a window past the first runs before its own
    smem: int       # dynamic shared memory a block: the wide route's words
    words: int      # uint32 scratch for the wide route's words (0: in smem)


def gate_route(N: int, Lq: int, Lt: int, group: Optional[int] = None,
               window: Optional[int] = None, wide: bool = False,
               words_scratch: bool = False, sms: int = SMS,
               shared_rows: bool = False) -> GateRoute:
    """K1''s geometry for one launch: the register route at W up to
    REGISTER_MAX_WORDS (G from GATE_GROUP, or `group`), the wide route past
    it or when `wide` (G 32, its words in shared memory where 4 warps' fit
    GATE_WIDE_SMEM, else, or with `words_scratch`, in a device scratch).
    Windows by gate_window in the shared-row modes (`shared_rows`: the
    shared-target and carried-state modes, few pairs against many columns)
    on the split design or the wide route, else one; or of `window` owned
    columns (at least the halo where they split the target; not at G 1
    below group_width(W)), which tests and timings force."""
    W = n_words(Lq)
    wide = wide or W > REGISTER_MAX_WORDS
    G = group if group is not None else 32 if wide else GATE_GROUP[W]
    if G not in ((32,) if wide else gate_designs(W)):
        designs = "32" if wide else " or ".join(map(str, gate_designs(W)))
        raise ValueError(f"group={G}: K1' runs {designs} lanes a pair at "
                         f"W={W}")
    H = window_halo(W)
    split = wide or G == group_width(W)
    if window is None:
        window = gate_window(N, W, G, Lt, sms) if shared_rows and split \
            else Lt
    elif window < Lt and not split:
        raise ValueError(f"windows run on {group_width(W)} lanes a pair at "
                         f"W={W}, not {G}")
    elif window < Lt and window < H:
        raise ValueError(f"a window of {window} columns is shorter than its "
                         f"halo ({H} at W={W})")
    window = max(min(window, Lt), 1)
    S = max(-(-Lt // window), 1)
    if S > 65535:
        raise ValueError(f"{S} windows: at most 65535")
    wl = wide_words(W) if wide else 0
    smem = words = 0
    if wl:
        need = GATE_WARPS * WORD_PLANES * wl * 32 * 4
        if need <= GATE_WIDE_SMEM and not words_scratch:
            smem = need
        else:
            words = gate_blocks(N, G) * S * need // 4
    return GateRoute(W, G, wl, S, window, H, smem, words)


def _check(q, t, qlen, tlen, shared_ok: bool = False
           ) -> Tuple[int, int, int]:
    """Operand checks; `shared_ok` admits a one-row target (1, Lt) for any
    N (K1''s shared-target mode)."""
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
    rows_ok = t.shape[0] == N or (shared_ok and t.shape[0] == 1)
    if not rows_ok or qlen.shape != (N,) or tlen.shape != (N,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, t "
                         f"{tuple(t.shape)}, qlen {tuple(qlen.shape)}, "
                         f"tlen {tuple(tlen.shape)}")
    return N, n_words(Lq), t.shape[1]


def is_shared(q, t) -> bool:
    """K1''s shared-target mode: one target row for N > 1 pairs."""
    return t.shape[0] == 1 and q.shape[0] > 1


def _gate_scratch(r: GateRoute, N: int, dev: torch.device):
    """K1''s scratch for one launch: the windows' (best, bj) slots (N,)
    uint64 where S > 1, and the wide route's words where they leave shared
    memory (else None each)."""
    slot = torch.empty(N, dtype=torch.int64, device=dev) if r.S > 1 else None
    words = (torch.empty(r.words, dtype=torch.int32, device=dev)
             if r.words else None)
    return slot, words


def kernel_operands(q, t, qlen, tlen, group: Optional[int] = None,
                    window: Optional[int] = None, wide: bool = False,
                    words_scratch: bool = False):
    """K1' device operands for one batch: the caller's codes and lengths
    as they are, the route (gate_route: GATE_GROUP's lanes a pair unless
    `group` names 1 or group_width(W), windows by shape unless `window`,
    the wide route past REGISTER_MAX_WORDS or when `wide`, which tests and
    timing comparisons force), the shared-target flag, the scratch and
    fresh outputs (dist, tend)."""
    N, W, Lt = _check(q, t, qlen, tlen, shared_ok=True)
    r = gate_route(N, q.shape[1], Lt, group, window, wide, words_scratch,
                   _sms(q.device), shared_rows=is_shared(q, t))
    outs = tuple(torch.empty(N, dtype=torch.int32, device=q.device)
                 for _ in range(2))
    return (q, t, qlen, tlen, r, is_shared(q, t),
            _gate_scratch(r, N, q.device), outs)


def _launch_gate(q, t, qlen, tlen, r: GateRoute, shared, j0, st_in, st_out,
                 scratch, dist, tend, what: str) -> None:
    (N, Lq), Lt = q.shape, t.shape[1]
    slot, words = scratch
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _gate_lib().hga_myers_gate_launch(
            q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N,
            Lq, Lt, r.W, r.G, r.wl, int(shared), j0, ptr(st_in),
            ptr(st_out), r.S, r.window, r.halo, ptr(slot), ptr(words),
            r.smem, dist.data_ptr(), tend.data_ptr(), stream)
    if err:
        raise RuntimeError(f"myers gate kernel{what} launch failed: CUDA "
                           f"error {err}")


def run_kernel(q, t, qlen, tlen, r, shared, scratch, outs) -> None:
    """Launch K1' on the current stream."""
    _launch_gate(q, t, qlen, tlen, r, shared, 0, None, None, scratch, *outs,
                 "")


def gate_counter(r: GateRoute, shared: bool) -> str:
    """The counter a K1' launch of the per-pair or shared-target mode
    moves."""
    if shared:
        return "myers_batch_cuda_shared"
    return "myers_batch_cuda_wide" if r.wl else "myers_batch_cuda"


class PlanesRoute(NamedTuple):
    W: int          # query words
    G: int          # lanes a pair (group_width(W); 1 for K2)
    wl: int         # words a lane on the wide route; 0 the register route
    smem: int       # dynamic shared memory a block: the wide route's words
                    # (unless `words`) and rings (if `ring`)
    words: bool     # the wide route's words in a device scratch
    ring: bool      # columns regrouped in a shared ring (always on the
                    # register route)
    thread: bool = False    # K2, one thread a pair (forced only)


def planes_route(Lq: int, words_scratch: bool = False,
                 thread: bool = False) -> PlanesRoute:
    """K2s's geometry at one shape: the register route up to
    REGISTER_MAX_WORDS (rings in static shared memory), the wide route past
    it: 4 warps' words (5 x wl x 32 uint32 a warp) and rings
    (2 x A x W uint32 a warp, A = ceil(W / wl)) in dynamic shared memory
    where both fit GATE_WIDE_SMEM; else the words in a device scratch
    (also with `words_scratch`) and the rings alone where they fit; else no
    ring (each lane stores its own words).  `thread` names K2, which timing
    comparisons force, at W <= THREAD_MAX_WORDS."""
    W = n_words(Lq)
    if thread:
        if W > THREAD_MAX_WORDS:
            raise ValueError(f"K2 (one thread a pair) takes at most "
                             f"{THREAD_MAX_WORDS} query words, got W={W}")
        return PlanesRoute(W, 1, 0, 0, False, False, True)
    if W <= REGISTER_MAX_WORDS:
        return PlanesRoute(W, group_width(W), 0, 0, False, True)
    wl = wide_words(W)
    words = GATE_WARPS * WORD_PLANES * wl * 32 * 4
    rings = GATE_WARPS * 2 * -(-W // wl) * W * 4
    if not words_scratch and words + rings <= GATE_WIDE_SMEM:
        return PlanesRoute(W, 32, wl, words + rings, False, True)
    if rings <= GATE_WIDE_SMEM:
        return PlanesRoute(W, 32, wl, rings, True, True)
    if not words_scratch and words <= GATE_WIDE_SMEM:
        return PlanesRoute(W, 32, wl, words, False, False)
    return PlanesRoute(W, 32, wl, 0, True, False)


def planes_counter(r: PlanesRoute) -> str:
    return "myers_batch_planes_cuda_wide" if r.wl else \
        "myers_batch_planes_cuda"


def planes_bytes(N: int, W: int, Lt: int) -> int:
    """Bytes of one batch's Pv and Mv planes, int32 (Lt, N, W) each."""
    return 2 * Lt * N * W * 4


def planes_alloc(N: int, W: int, Lt: int, dev: torch.device):
    """The Pv and Mv planes, int32 (Lt, N, W) each.  Where device memory
    cannot hold them it raises with their byte count (the caller's batch
    is not cut silently); it asks the device nothing before allocating, so
    a batch that fits pays no query."""
    try:
        return [torch.empty((Lt, N, W), dtype=torch.int32, device=dev)
                for _ in range(2)]
    except torch.OutOfMemoryError as e:
        raise ValueError(f"the Pv/Mv planes of this batch need "
                         f"{planes_bytes(N, W, Lt):,} bytes of device "
                         "memory, more than is free; run the batch in "
                         "parts") from e


def planes_operands(q, t, qlen, tlen, words_scratch: bool = False,
                    thread: bool = False):
    """The planes kernel's launch for one batch: the route (planes_route:
    K2s by W, the wide route's words in their scratch with
    `words_scratch`, or K2 with `thread`, which tests and timing
    comparisons force), the inputs (the caller's
    codes and lengths and the wide route's word scratch or None; for K2 the
    transposed query planes (W, N) and targets (Lt, N) it reads) and fresh
    outputs (dist, tend and the (Lt, N, W) Pv/Mv planes, planes_alloc)."""
    N, W, Lt = _check(q, t, qlen, tlen)
    r = planes_route(q.shape[1], words_scratch, thread)
    dev = q.device
    outs = [torch.empty(N, dtype=torch.int32, device=dev) for _ in range(2)]
    outs += planes_alloc(N, W, Lt, dev)
    if r.thread:
        qp = tuple(x.t().contiguous() for x in query_planes(q, qlen, W))
        return r, (qp, t.t().contiguous(), qlen, tlen), outs
    words = None
    if r.words:
        words = torch.empty(-(-N // GATE_WARPS) * GATE_WARPS * WORD_PLANES
                            * r.wl * 32, dtype=torch.int32, device=dev)
    return r, (q, t, qlen, tlen, words), outs


def run_planes_kernel(r: PlanesRoute, ins, outs) -> None:
    """Launch K2s (or the forced K2) on the current stream (operands as
    planes_operands returns them)."""
    dist, tend, pvp, mvp = outs
    N = dist.shape[0]
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream(dist.device).cuda_stream
        if r.thread:
            (q0, q1, vq, mend), tT, qlen, tlen = ins
            err = _lib().hga_myers_launch(
                q0.data_ptr(), q1.data_ptr(), vq.data_ptr(), mend.data_ptr(),
                tT.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N,
                tT.shape[0], r.W, dist.data_ptr(), tend.data_ptr(),
                pvp.data_ptr(), mvp.data_ptr(), stream)
        else:
            q, t, qlen, tlen, words = ins
            ring = int(r.ring and r.wl > 0)    # the wide route's flag
            err = _lib().hga_myers_planes_launch(
                q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                N, q.shape[1], t.shape[1], r.W, r.wl, ring,
                None if words is None else words.data_ptr(), r.smem,
                dist.data_ptr(), tend.data_ptr(), pvp.data_ptr(),
                mvp.data_ptr(), stream)
    if err:
        raise RuntimeError(f"myers planes kernel launch failed: CUDA error "
                           f"{err}")


def myers_batch_cuda(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                     tlen: torch.Tensor) -> MyersResult:
    """K1': batched semi-global edit distance; bit-exact with
    ops.myers.myers_batch.  q, t int32 (N, Lq), (N, Lt) on one CUDA device,
    or t (1, Lt): every pair against that one row (the shared-target mode,
    counted apart).  CPU tensors: the plain version."""
    _check(q, t, qlen, tlen, shared_ok=True)
    if not q.is_cuda:
        return myers_batch(q, t, qlen, tlen)
    *ops, outs = kernel_operands(q, t, qlen, tlen)
    if q.shape[0]:
        with spans.launch(gate_counter(ops[4], ops[5])):
            run_kernel(*ops, outs)
    return MyersResult(*outs)


def _check_carry(q, t, qlen, tlen, state, j0: int):
    """The carried-state mode's operand checks; returns (N, W, the packed
    input state int32 (N, 2 W + 3))."""
    N, W, _ = _check(q, t, qlen, tlen, shared_ok=True)
    st_in = pack_state(state)
    if st_in.shape != (N, 2 * W + 3) or st_in.device != q.device:
        raise ValueError(f"state must be ({N}, {W}) x 2 + ({N},) x 3 int32 "
                         f"on {q.device}")
    if j0 < 0:
        raise ValueError(f"j0={j0} must be >= 0")
    return N, W, st_in


def carry_operands(q, t, qlen, tlen, state, j0: int = 0,
                   window: Optional[int] = None, wide: bool = False,
                   words_scratch: bool = False):
    """K1''s carried-state launch for one chunk: the caller's codes and
    lengths as they are, the route (gate_route, as kernel_operands), the
    shared-target flag, j0, the packed input state (int32 (N, 2 W + 3)),
    the scratch and fresh outputs (the state, dist, tend)."""
    N, W, st_in = _check_carry(q, t, qlen, tlen, state, j0)
    r = gate_route(N, q.shape[1], t.shape[1], None, window, wide,
                   words_scratch, _sms(q.device), shared_rows=True)
    outs = (torch.empty_like(st_in),) + tuple(
        torch.empty(N, dtype=torch.int32, device=q.device) for _ in range(2))
    return (q, t, qlen, tlen, r, is_shared(q, t), j0, st_in,
            _gate_scratch(r, N, q.device), outs)


def run_carry_kernel(q, t, qlen, tlen, r, shared, j0, st_in, scratch,
                     outs) -> None:
    """Launch K1''s carried-state mode on the current stream."""
    st_out, dist, tend = outs
    _launch_gate(q, t, qlen, tlen, r, shared, j0, st_in, st_out, scratch,
                 dist, tend, " (carried state)")


def myers_cols_cuda(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                    tlen: torch.Tensor, state, j0: int = 0):
    """K1''s carried-state mode: advance the DP of the queries q (int32 codes
    (N, Lq)) over the target chunk t ((N, Lt), or one row (1, Lt) shared by
    every pair) whose first column is global column j0, from `state`
    (pv, mv, score, best, bj: int32 (N, W), (N, W), (N,) x 3, as
    ops/myers.myers_init_state makes it).  Returns (the state after t's
    last column, MyersResult of that state).  Bit-exact with
    ops.myers.myers_cols (CPU tensors: that plain version)."""
    N, W, _ = _check_carry(q, t, qlen, tlen, state, j0)
    if not q.is_cuda:
        st = myers_cols(*query_planes(q, qlen, W), t, tlen, state, j0)
        return st, state_result(qlen, st)
    *ops, outs = carry_operands(q, t, qlen, tlen, state, j0)
    if N:
        with spans.launch("myers_batch_cuda_carry"):
            run_carry_kernel(*ops, outs)
    return unpack_state(outs[0], W), MyersResult(*outs[1:])


def myers_batch_planes_cuda(q: torch.Tensor, t: torch.Tensor,
                            qlen: torch.Tensor, tlen: torch.Tensor):
    """K2s: myers_batch_cuda + per-column Pv/Mv planes int32 (Lt, N, W) at
    any W; bit-exact with ops.myers.myers_batch_planes (CPU tensors: the
    plain version)."""
    _check(q, t, qlen, tlen)
    if not q.is_cuda:
        return myers_batch_planes(q, t, qlen, tlen)
    r, ins, outs = planes_operands(q, t, qlen, tlen)
    if q.shape[0]:
        with spans.launch(planes_counter(r)):
            run_planes_kernel(r, ins, outs)
    return MyersResult(dist=outs[0], tend=outs[1]), outs[2], outs[3]


# ---------------------------------------------------------------- K2'

class VotesRoute(NamedTuple):
    W: int          # query words
    G: int          # lanes a pair (group_width(W))
    pairs: int      # pairs a warp (a block), 32 / G
    stride: int     # uint32 words of a pair's plane row (even, >= 2 W Lt)
    smem: int       # dynamic shared memory a block, bytes
    scratch: bool   # planes in a device scratch instead of shared memory
    wl: int = 0     # words a lane on the wide route; 0 the register route
    words: bool = False  # the wide route's words in a device scratch


def votes_route(Lq: int, Lt: int, scratch: bool = False) -> VotesRoute:
    """K2''s geometry for one shape: a pair's plane row holds (Pv, Mv) of
    each (column, word), rounded up to 32 words plus 2 G (the groups of a
    warp then store to distinct banks); a block is one warp, its planes and
    its staged targets (odd words a row) in shared memory, or the staged
    targets alone with the planes in a device scratch when shared memory
    would hold fewer than VOTES_SMEM_MIN_BLOCKS such blocks an SM (or when
    `scratch` asks for it, which timing comparisons do).  Past
    REGISTER_MAX_WORDS the wide route: planes in the scratch, each lane's
    words after the staged row in shared memory, or in a scratch of their
    own where that passes SMEM_MAX."""
    W = n_words(Lq)
    G = group_width(W)
    pairs = 32 // G
    wl = wide_words(W) if W > REGISTER_MAX_WORDS else 0
    lanes = -(-W // (wl or -(-W // G)))          # lanes that hold words
    stride = -(-2 * W * Lt // 32) * 32 + 2 * G
    row = ((STAGE_COLUMNS + lanes - 1 + 3) // 4 | 1) * 4
    if wl:
        words = WORD_PLANES * wl * 32 * 4
        if row + words <= SMEM_MAX:
            return VotesRoute(W, G, pairs, stride, row + words, True, wl)
        return VotesRoute(W, G, pairs, stride, row, True, wl, True)
    smem = pairs * stride * 4 + pairs * row
    blocks = SMEM_SM // (smem + SMEM_RESERVED)
    if scratch or blocks < VOTES_SMEM_MIN_BLOCKS:
        return VotesRoute(W, G, pairs, stride, pairs * row, True)
    return VotesRoute(W, G, pairs, stride, smem, False)


def votes_counter(r: VotesRoute) -> str:
    if r.wl:
        return "myers_votes_cuda_wide"
    return "myers_votes_cuda_scratch" if r.scratch else "myers_votes_cuda"


def votes_scratch_bytes(r: VotesRoute) -> int:
    """Device scratch bytes one warp of K2' takes: its pairs' planes on the
    scratch homes, and the wide route's words where they leave shared
    memory."""
    planes = r.pairs * r.stride * 4 if r.scratch else 0
    return planes + (WORD_PLANES * r.wl * 32 * 4 if r.words else 0)


def votes_launch_pairs(r: VotesRoute, N: int,
                       budget: int = VOTES_SCRATCH_BYTES) -> int:
    """Pairs one K2' launch takes: all N, or as many whole warps as keep
    the launch's scratch within `budget` (at least one warp)."""
    per = votes_scratch_bytes(r)
    if per == 0:
        return max(N, 1)
    return max(min(N, budget // per * r.pairs), r.pairs)


def votes_attrs(r: VotesRoute) -> Tuple[int, int, int]:
    """(registers per thread, local bytes per thread, blocks resident an
    SM) of the route's instantiation at its shared memory."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = _votes_lib()
    err = lib.hga_myers_votes_attrs(r.W, r.wl, int(r.scratch),
                                    ctypes.byref(regs), ctypes.byref(local))
    err = err or lib.hga_myers_votes_occupancy(
        r.W, r.wl, int(r.scratch), r.smem, ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"K2' attributes failed with CUDA error {err}")
    return regs.value, local.value, blocks.value


def _check_votes(merged, q, t, qlen, tlen, bb, off, lb, qw, size_v, lpad,
                 ins_slots) -> Tuple[int, int, int]:
    """K1's operand checks plus the batch's placement and the vote buffer;
    returns (size_all (the buffer's last slot is the sink), N, W)."""
    N, W, _ = _check(q, t, qlen, tlen)
    named = [("bb", bb), ("off", off), ("lb", lb), ("merged", merged)]
    if qw is not None:
        named.append(("qw", qw))
    for name, x in named:
        if x.device != q.device:
            raise ValueError(f"{name} lies on {x.device}, q on {q.device}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bb.shape != (N,) or off.shape != (N,) or lb.shape != (N,):
        raise ValueError(f"bb, off, lb must be ({N},)")
    if qw is not None and qw.shape != q.shape:
        raise ValueError(f"qw {tuple(qw.shape)} must match q "
                         f"{tuple(q.shape)}")
    if merged.dim() != 1 or merged.shape[0] < 1:
        raise ValueError("merged must be a 1-D vote buffer with a sink slot")
    size_all = merged.shape[0] - 1
    if not 0 <= size_v <= size_all or lpad < 0 or ins_slots < 1:
        raise ValueError(f"size_v {size_v}, lpad {lpad}, ins_slots "
                         f"{ins_slots} do not fit a buffer of {size_all}")
    return size_all, N, W


def votes_operands(merged, q, t, qlen, tlen, bb, off, lb, qw=None, *,
                   min_identity: float, size_v: int, lpad: int,
                   ins_slots: int = 3, max_steps: Optional[int] = None,
                   scratch: bool = False, budget: int = VOTES_SCRATCH_BYTES):
    """K2''s launches for one batch: the route (shape alone, or the scratch
    when `scratch`), the caller's tensors as they are, the walk's step
    bound min(Lq + Lt, max_steps), the scalars, the device scratch (planes
    or None, the wide route's words or None, the pairs a launch: N, or
    fewer where the scratch would pass `budget`) and fresh dist/tend.
    Where device memory cannot hold the scratch, its allocation raises
    (torch's out-of-memory error, which gives the bytes)."""
    size_all, N, _ = _check_votes(merged, q, t, qlen, tlen, bb, off, lb,
                                  qw, size_v, lpad, ins_slots)
    Lq, Lt = q.shape[1], t.shape[1]
    r = votes_route(Lq, Lt, scratch)
    steps = Lq + Lt if max_steps is None else min(Lq + Lt, max_steps)
    per = votes_launch_pairs(r, N, budget)
    warps = -(-per // r.pairs)
    planes = words = None
    if r.scratch:
        planes = torch.empty(warps * r.pairs * r.stride, dtype=torch.int32,
                             device=q.device)
    if r.words:
        words = torch.empty(warps * WORD_PLANES * r.wl * 32,
                            dtype=torch.int32, device=q.device)
    outs = tuple(torch.empty(N, dtype=torch.int32, device=q.device)
                 for _ in range(2))
    scalars = (max(steps, 0), ins_slots, lpad, size_v, size_all,
               1.0 - min_identity)
    return r, (q, t, qlen, tlen, bb, off, lb, qw), scalars, \
        (planes, words, per), merged, outs


def run_votes_kernel(r: VotesRoute, ins, scalars, scratch, merged,
                     outs) -> int:
    """Launch K2' on the current stream (operands as votes_operands
    returns them), one launch a sub-batch of `scratch`'s pairs a launch;
    returns the launches.  The float32 gate fraction is the C float nearest
    to 1 - min_identity, as torch.tensor(..., dtype=torch.float32) makes
    it."""
    q, t = ins[0], ins[1]
    (N, Lq), Lt = q.shape, t.shape[1]
    steps, ins_slots, lpad, size_v, size_all, frac = scalars
    planes, words, per = scratch
    ptr = lambda x: None if x is None else x.data_ptr()
    n = 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for a in range(0, N, per):
            sl = slice(a, min(N, a + per))
            part = [None if x is None else x[sl] for x in ins]
            dist, tend = (o[sl] for o in outs)
            err = _votes_lib().hga_myers_votes_launch(
                *(ptr(x) for x in part), dist.shape[0], Lq, Lt, r.W, r.G,
                r.wl, r.stride, steps, ins_slots, r.smem, lpad, size_v,
                size_all, frac, dist.data_ptr(), tend.data_ptr(),
                merged.data_ptr(), ptr(planes), ptr(words), stream)
            if err:
                raise RuntimeError(f"myers votes kernel launch failed: CUDA "
                                   f"error {err}")
            n += 1
    return n


def myers_votes_cuda(merged: torch.Tensor, q: torch.Tensor, t: torch.Tensor,
                     qlen: torch.Tensor, tlen: torch.Tensor, bb: torch.Tensor,
                     off: torch.Tensor, lb: torch.Tensor,
                     qw: Optional[torch.Tensor] = None, *,
                     min_identity: float, size_v: int, lpad: int,
                     ins_slots: int = 3, max_steps: Optional[int] = None
                     ) -> Tuple[MyersResult, torch.Tensor]:
    """K2': one correction batch — Myers DP, identity gate, plane traceback,
    votes — updating `merged` (int32 (size_all + 1,), the last slot the
    sink, which the kernel never writes) in place; returns (MyersResult,
    merged).  Bit-exact with ops/pileup.myers_votes (CPU tensors: that
    plain version)."""
    _check_votes(merged, q, t, qlen, tlen, bb, off, lb, qw, size_v, lpad,
                 ins_slots)
    if not q.is_cuda:
        return myers_votes(merged, q, t, qlen, tlen, bb, off, lb, qw,
                           min_identity=min_identity, size_v=size_v,
                           lpad=lpad, ins_slots=ins_slots,
                           max_steps=max_steps)
    r, *ops, outs = votes_operands(
        merged, q, t, qlen, tlen, bb, off, lb, qw, min_identity=min_identity,
        size_v=size_v, lpad=lpad, ins_slots=ins_slots, max_steps=max_steps)
    if q.shape[0]:
        with spans.launch(votes_counter(r)) as sp:
            sp.n = run_votes_kernel(r, *ops, outs)
    return MyersResult(*outs), merged
