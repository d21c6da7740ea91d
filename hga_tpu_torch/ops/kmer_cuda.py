"""L1 — the hand-written CUDA k-mer key kernel and its wrapper.

``kmer_keys_cuda`` launches ``csrc/kmer.cu`` ``kmer_keys_kernel``: the flat
int64 canonical k-mer keys of a read batch, sentinel-masked, in one pass —
slot for slot the tensor of the plain composition ``extract_kmers`` →
``pack_key`` → ``where`` (``ops/kmer._keys_plain``).  It replaces no TPU
kernel (the JAX package's extraction is plain jnp that XLA fuses); it was
added because the eager plain composition, k steps over (R, m) int64
planes, took about 56% of the count's device time.  Callers go through
``ops/kmer.kmer_keys``, which checks the operands and takes the plain
version for CPU tensors; on a CUDA tensor this wrapper launches or raises.

What bounds it on an H100: the 8 bytes it writes a slot.  A block takes a
tile of whole reads of about ``SLOTS`` slots (or ``SLOTS`` positions of one
longer read), stages the tile's words once in shared memory and writes the
tile's contiguous slots with full warp stores (see csrc/kmer.cu).
``geometry`` picks the tile by shape alone.  The library is built at first
use from ``csrc/kmer.cu`` (ops/cuda_build.py) and loaded with ctypes; the
launch goes on ``torch.cuda.current_stream()`` and is counted as
``spans.launch("kmer_keys")``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.utils import spans

COUNTER = "kmer_keys"      # the launch counter (spans.launches())
THREADS = 256              # threads a block (kThreads in csrc/kmer.cu)
SLOTS = 4096               # slots a tile aims at: 16 a thread
SMEM_MAX = 48 * 1024       # shared bytes a block takes without opting in

_LIB: Optional[ctypes.CDLL] = None


class Geometry(NamedTuple):
    rows: int        # reads a tile
    span: int        # positions a tile (m where rows > 1)
    tiles_row: int   # tiles a read
    tiles: int       # blocks of the launch
    smem: int        # dynamic shared bytes a block
    vec: int         # neighbouring slots a thread takes at a time (1, 2)


def geometry(R: int, W: int, k: int) -> Geometry:
    """The tiles of a batch of R reads of W words at k, by shape alone.

    Reads of m = 16 W - k + 1 <= SLOTS positions go whole, SLOTS // m of
    them a tile (fewer where their staged words would pass SMEM_MAX);
    longer reads go SLOTS positions a tile.  A tile stages, a read, the
    words its windows cover twice (in order and reversed; two zero words
    after each), the bad-flag words (one zero word after) and the length.
    A thread takes 2 neighbouring slots at a time where m is even (and so
    every tile's span), else 1.
    """
    m = 16 * W - k + 1
    span = min(m, SLOTS)
    # words a tile's windows cover: SLOTS is a multiple of 32, so a span's
    # tiles start on a word of either kind
    last = span + k - 2
    nw, nb = (last >> 4) + 1, (last >> 5) + 1
    row_bytes = 4 * (2 * (nw + 2) + (nb + 1) + 1)
    rows = max(1, min(SLOTS // m, SMEM_MAX // row_bytes)) if m <= SLOTS \
        else 1
    tiles_row = -(-m // span)
    vec = 2 if m % 2 == 0 else 1
    return Geometry(rows, span, tiles_row, -(-R // rows) * tiles_row,
                    rows * row_bytes, vec)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("kmer"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_kmer_keys_launch.argtypes = [vp] * 3 + [ci] * 9 + [vp] * 2
        lib.hga_kmer_keys_launch.restype = ci
        lib.hga_kmer_keys_attrs.argtypes = [ci] + [ctypes.POINTER(ci)] * 2
        lib.hga_kmer_keys_attrs.restype = ci
        _LIB = lib
    return _LIB


def kernel_attrs(vec: int) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of the kernel at
    `vec` slots a thread."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().hga_kmer_keys_attrs(vec, ctypes.byref(regs),
                                     ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def kmer_keys_cuda(packed: torch.Tensor, bad: torch.Tensor,
                   length: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the kernel on the current stream: int32 packed (R, W), bad
    (R, BW) and length (R,), contiguous, on one CUDA device (ops/kmer.
    kmer_keys checks their shapes, k and the device); returns int64
    (R * m,)."""
    for x in (packed, bad, length):
        if (x.device.type != "cuda" or x.dtype != torch.int32
                or not x.is_contiguous()):
            raise ValueError("kmer_keys_cuda takes contiguous int32 CUDA "
                             "tensors")
    (R, W), BW = packed.shape, bad.shape[1]
    m = 16 * W - k + 1
    out = torch.empty(R * m, dtype=torch.int64, device=packed.device)
    if R == 0:
        return out
    g = geometry(R, W, k)
    with torch.cuda.device(packed.device), spans.launch(COUNTER):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = _lib().hga_kmer_keys_launch(
            packed.data_ptr(), bad.data_ptr(), length.data_ptr(), R, W, BW,
            k, g.rows, g.span, g.tiles_row, g.vec, g.smem, out.data_ptr(),
            stream)
        if err:
            raise RuntimeError(f"kmer_keys kernel launch failed: CUDA error "
                               f"{err}")
    return out
