"""L3 — the hand-written CUDA Myers kernels (K1', K2, K2') and wrappers.

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
  (chip_smoke.py phase 6, PERF.md).  A one-row target (1, Lt) for N > 1
  pairs is the shared-target mode (utils/evalx.segment_identity): every
  pair runs against that row, which each block stages once; it counts
  apart (``myers_batch_cuda_shared``).
* ``myers_cols_cuda`` launches K1''s carried-state mode (the same kernel
  with ``carry`` = 1; counted as ``myers_batch_cuda_carry``): it starts
  from a given column state (pv, mv, score, best, bj) and returns the state
  it ends in, over a target chunk whose first column is global column j0 —
  each step of the ring engine (parallel/ring_myers.py).  Its plain version
  is ``ops/myers.myers_cols``.
* ``myers_votes_cuda`` launches K2' (``csrc/myers_votes.cu``
  ``myers_votes_kernel<G, SMEM>``), which replaces ``_myers_planes_kernel``
  (hga_tpu/ops/myers_pallas.py:106) on the correction and polish paths:
  one launch per batch runs K1''s split DP with the Pv/Mv planes kept in
  shared memory, the float32 identity gate, the plane traceback and the
  vote atomics into the flat vote buffer.  Its plain version is
  ``ops/pileup.myers_votes``.  ``votes_route`` picks the planes' home by
  shape: shared memory where a warp's planes fit a block, else a device
  scratch (counted apart, ``myers_votes_cuda_scratch``).
* ``myers_batch_planes_cuda`` launches K2 (``csrc/myers.cu``
  ``myers_kernel<W>``), the port of the public planes function
  ``myers_batch_planes_pallas``: one thread per pair from query planes
  (W, N) and transposed (Lt, N) targets that its wrapper prepares, planes
  (Lt, N, W) written to device memory.  No main path runs it since K2'.

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
K1' and K2' take W 1-34 query words (``MAX_WORDS``: queries up to 1054
bases, which covers the short-read route's pads up to LONG_READ_PAD 1024);
K2 takes 1-24 (``PLANES_MAX_WORDS``).  Past its cap each operand function
raises.

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
from hga_tpu_torch.ops.myers import (MAX_WORDS, MyersResult, myers_batch,
                                     myers_batch_planes, myers_cols, n_words,
                                     pack_state, query_planes, state_result,
                                     unpack_state)
from hga_tpu_torch.ops.pileup import myers_votes

# launches of each kernel by its wrapper (reset with reset_launches()); K2'
# counts its two plane homes apart
LAUNCHES: Dict[str, int] = {"myers_batch_cuda": 0,
                            "myers_batch_cuda_shared": 0,
                            "myers_batch_cuda_carry": 0,
                            "myers_votes_cuda": 0,
                            "myers_votes_cuda_scratch": 0,
                            "myers_batch_planes_cuda": 0}

THREADS = 128              # threads a block, K1' and K2
PLANES_MAX_WORDS = 24      # W K2 unrolls into one thread's registers
SINGLE_MAX_WORDS = 24      # W K1' takes at one thread a pair (G 1)
SMEM_MAX = 232448          # shared memory a block may opt in to (227 KB)
SMEM_SM = 233472           # shared memory of an SM (228 KB) ...
SMEM_RESERVED = 1024       # ... of which each resident block reserves 1 KB
STAGE_COLUMNS = 128        # K2' target columns a warp stages at a time
# K2' keeps its planes in shared memory only where an SM holds at least
# this many such blocks: with 1-3 the device scratch ran 1.6-3.2x faster,
# with 4 (the correction shape) shared memory ran 1.4x faster (NVIDIA H100
# 80GB HBM3 at 700 W, chip_smoke.py phase 6's two-home rows, PERF.md)
VOTES_SMEM_MIN_BLOCKS = 4


def group_width(W: int) -> int:
    """K1' and K2' lanes a pair in the split design: the smallest power of
    two >= W, at most a warp's 32 (two words a lane past 32 words)."""
    return min(1 << (W - 1).bit_length(), 32)


# K1' lanes a pair (G) by query words W: 1 (a thread per pair) or
# group_width(W).  chip_smoke.py phase 6 times both at W 4, 5 and 14 (W 1
# has one design): the split design ran 1.6-2.4x faster at each on an H100
# (PERF.md), so every W takes it; each W between takes the choice of the
# nearest measured W.  W 25-34 exist in the split design only.
GATE_GROUP: Dict[int, int] = {W: group_width(W)
                              for W in range(1, MAX_WORDS + 1)}

_LIB: Optional[ctypes.CDLL] = None        # K2 (csrc/myers.cu)
_GATE_LIB: Optional[ctypes.CDLL] = None   # K1' (csrc/myers_gate.cu)
_VOTES_LIB: Optional[ctypes.CDLL] = None  # K2' (csrc/myers_votes.cu)


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
        lib.hga_myers_gate_launch.argtypes = [vp] * 4 + [ci] * 6 + [vp] * 3
        lib.hga_myers_gate_launch.restype = ci
        lib.hga_myers_gate_carry_launch.argtypes = ([vp] * 4 + [ci] * 7
                                                    + [vp] * 5)
        lib.hga_myers_gate_carry_launch.restype = ci
        lib.hga_myers_gate_attrs.argtypes = [ci, ci] + \
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
            [vp] * 8 + [ci] * 9 + [cl] * 3 + [ctypes.c_float] + [vp] * 5)
        lib.hga_myers_votes_launch.restype = ci
        lib.hga_myers_votes_attrs.argtypes = [ci, ci] + \
            [ctypes.POINTER(ci)] * 2
        lib.hga_myers_votes_attrs.restype = ci
        lib.hga_myers_votes_occupancy.argtypes = [ci, ci, ci,
                                                  ctypes.POINTER(ci)]
        lib.hga_myers_votes_occupancy.restype = ci
        _VOTES_LIB = lib
    return _VOTES_LIB


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


def gate_designs(W: int) -> Tuple[int, ...]:
    """K1''s instantiations at W words, in lanes a pair: 1 and
    group_width(W), or group_width(W) alone past SINGLE_MAX_WORDS."""
    if W <= SINGLE_MAX_WORDS:
        return tuple(sorted({1, group_width(W)}))
    return (group_width(W),)


def gate_blocks(N: int, G: int) -> int:
    """K1' blocks for N pairs: THREADS / G pairs a block."""
    return -(-N // (THREADS // G))


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


def kernel_operands(q, t, qlen, tlen, group: Optional[int] = None):
    """K1' device operands for one batch: the caller's codes and lengths
    as they are, W, the lanes a pair (GATE_GROUP's choice unless `group`
    names 1 or group_width(W), which timing comparisons do), the
    shared-target flag and fresh outputs."""
    N, W, _ = _check(q, t, qlen, tlen, shared_ok=True)
    if W > MAX_WORDS:
        raise ValueError(f"K1' takes at most {MAX_WORDS} query words, got "
                         f"W={W}")
    G = GATE_GROUP[W] if group is None else group
    if G not in gate_designs(W):
        raise ValueError(f"group={G}: K1' runs "
                         f"{' or '.join(map(str, gate_designs(W)))} lanes a "
                         f"pair at W={W}")
    outs = tuple(torch.empty(N, dtype=torch.int32, device=q.device)
                 for _ in range(2))
    return q, t, qlen, tlen, W, G, is_shared(q, t), outs


def run_kernel(q, t, qlen, tlen, W, G, shared, outs) -> None:
    """Launch K1' on the current stream."""
    (N, Lq), Lt = q.shape, t.shape[1]
    dist, tend = outs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _gate_lib().hga_myers_gate_launch(
            q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N,
            Lq, Lt, W, G, int(shared), dist.data_ptr(), tend.data_ptr(),
            stream)
    if err:
        raise RuntimeError(f"myers gate kernel launch failed: CUDA error "
                           f"{err}")


def planes_operands(q, t, qlen, tlen):
    """K2's device operands for one batch: transposed query planes (W, N),
    transposed targets (Lt, N), lengths, and fresh outputs (dist, tend and
    the (Lt, N, W) Pv/Mv planes)."""
    N, W, Lt = _check(q, t, qlen, tlen)
    if W > PLANES_MAX_WORDS:
        raise ValueError(f"K2 takes at most {PLANES_MAX_WORDS} query words, "
                         f"got W={W}")
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
    ops.myers.myers_batch.  q, t int32 (N, Lq), (N, Lt) on one CUDA device,
    or t (1, Lt): every pair against that one row (the shared-target mode,
    counted apart).  CPU tensors: the plain version."""
    _check(q, t, qlen, tlen, shared_ok=True)
    if not q.is_cuda:
        return myers_batch(q, t, qlen, tlen)
    *ops, outs = kernel_operands(q, t, qlen, tlen)
    if q.shape[0]:
        run_kernel(*ops, outs)
        LAUNCHES["myers_batch_cuda_shared" if ops[-1]
                 else "myers_batch_cuda"] += 1
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


def carry_operands(q, t, qlen, tlen, state, j0: int = 0):
    """K1''s carried-state launch for one chunk: the caller's codes and
    lengths as they are, W, GATE_GROUP's lanes a pair, the shared-target
    flag, j0, the packed input state (int32 (N, 2 W + 3)) and fresh outputs
    (the state, dist, tend)."""
    N, W, st_in = _check_carry(q, t, qlen, tlen, state, j0)
    if W > MAX_WORDS:
        raise ValueError(f"K1' takes at most {MAX_WORDS} query words, got "
                         f"W={W}")
    outs = (torch.empty_like(st_in),) + tuple(
        torch.empty(N, dtype=torch.int32, device=q.device) for _ in range(2))
    return (q, t, qlen, tlen, W, GATE_GROUP[W], is_shared(q, t), j0, st_in,
            outs)


def run_carry_kernel(q, t, qlen, tlen, W, G, shared, j0, st_in,
                     outs) -> None:
    """Launch K1''s carried-state mode on the current stream."""
    (N, Lq), Lt = q.shape, t.shape[1]
    st_out, dist, tend = outs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _gate_lib().hga_myers_gate_carry_launch(
            q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N,
            Lq, Lt, W, G, int(shared), j0, st_in.data_ptr(),
            st_out.data_ptr(), dist.data_ptr(), tend.data_ptr(), stream)
    if err:
        raise RuntimeError(f"myers gate kernel (carried state) launch "
                           f"failed: CUDA error {err}")


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
        run_carry_kernel(*ops, outs)
        LAUNCHES["myers_batch_cuda_carry"] += 1
    return unpack_state(outs[0], W), MyersResult(*outs[1:])


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


# ---------------------------------------------------------------- K2'

class VotesRoute(NamedTuple):
    W: int          # query words
    G: int          # lanes a pair (group_width(W); two words a lane past 32)
    pairs: int      # pairs a warp (a block), 32 / G
    stride: int     # uint32 words of a pair's plane row (even, >= 2 W Lt)
    smem: int       # dynamic shared memory a block, bytes
    scratch: bool   # planes in a device scratch instead of shared memory


def votes_route(Lq: int, Lt: int, scratch: bool = False) -> VotesRoute:
    """K2''s geometry for one shape: a pair's plane row holds (Pv, Mv) of
    each (column, word), rounded up to 32 words plus 2 G (the groups of a
    warp then store to distinct banks); a block is one warp, its planes and
    its staged targets (odd words a row) in shared memory, or the staged
    targets alone with the planes in a device scratch when shared memory
    would hold fewer than VOTES_SMEM_MIN_BLOCKS such blocks an SM (or when
    `scratch` asks for it, which timing comparisons do)."""
    W = n_words(Lq)
    G = group_width(W)
    pairs = 32 // G
    stride = -(-2 * W * Lt // 32) * 32 + 2 * G
    row = ((STAGE_COLUMNS + W - 1 + 3) // 4 | 1) * 4
    smem = pairs * stride * 4 + pairs * row
    blocks = SMEM_SM // (smem + SMEM_RESERVED)
    if scratch or blocks < VOTES_SMEM_MIN_BLOCKS:
        return VotesRoute(W, G, pairs, stride, pairs * row, True)
    return VotesRoute(W, G, pairs, stride, smem, False)


def votes_counter(r: VotesRoute) -> str:
    return "myers_votes_cuda_scratch" if r.scratch else "myers_votes_cuda"


def votes_attrs(r: VotesRoute) -> Tuple[int, int, int]:
    """(registers per thread, local bytes per thread, blocks resident an
    SM) of the route's instantiation at its shared memory."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = _votes_lib()
    err = lib.hga_myers_votes_attrs(r.W, int(r.scratch), ctypes.byref(regs),
                                    ctypes.byref(local))
    err = err or lib.hga_myers_votes_occupancy(r.W, int(r.scratch), r.smem,
                                               ctypes.byref(blocks))
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
                   scratch: bool = False):
    """K2''s launch for one batch: the route (shape alone, or the scratch
    when `scratch`), the caller's tensors as they are, the walk's step
    bound min(Lq + Lt, max_steps), the scalars, the device scratch (else
    None) and fresh dist/tend."""
    size_all, N, W = _check_votes(merged, q, t, qlen, tlen, bb, off, lb,
                                  qw, size_v, lpad, ins_slots)
    if W > MAX_WORDS:
        raise ValueError(f"K2' takes at most {MAX_WORDS} query words, got "
                         f"W={W}")
    Lq, Lt = q.shape[1], t.shape[1]
    r = votes_route(Lq, Lt, scratch)
    steps = Lq + Lt if max_steps is None else min(Lq + Lt, max_steps)
    planes = None
    if r.scratch:
        planes = torch.empty(-(-N // r.pairs) * r.pairs * r.stride,
                             dtype=torch.int32, device=q.device)
    outs = tuple(torch.empty(N, dtype=torch.int32, device=q.device)
                 for _ in range(2))
    scalars = (max(steps, 0), ins_slots, lpad, size_v, size_all,
               1.0 - min_identity)
    return r, (q, t, qlen, tlen, bb, off, lb, qw), scalars, planes, merged, \
        outs


def run_votes_kernel(r: VotesRoute, ins, scalars, planes, merged,
                     outs) -> None:
    """Launch K2' on the current stream (operands as votes_operands
    returns them).  The float32 gate fraction is the C float nearest to
    1 - min_identity, as torch.tensor(..., dtype=torch.float32) makes it."""
    q, t = ins[0], ins[1]
    (N, Lq), Lt = q.shape, t.shape[1]
    steps, ins_slots, lpad, size_v, size_all, frac = scalars
    ptr = lambda x: None if x is None else x.data_ptr()
    dist, tend = outs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _votes_lib().hga_myers_votes_launch(
            *(ptr(x) for x in ins), N, Lq, Lt, r.W, r.G, r.stride, steps,
            ins_slots, r.smem, lpad, size_v, size_all, frac,
            dist.data_ptr(), tend.data_ptr(), merged.data_ptr(),
            ptr(planes), stream)
    if err:
        raise RuntimeError(f"myers votes kernel launch failed: CUDA error "
                           f"{err}")


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
        run_votes_kernel(r, *ops, outs)
        LAUNCHES[votes_counter(r)] += 1
    return MyersResult(*outs), merged
