"""Overlap records and the overlap gate's edit-distance dispatch (PyTorch).

The parts of ``hga_tpu.models.overlap`` that the long-read path uses:
``OverlapRecords`` (PAF-shaped, same ``overlaps.npz`` artifact), the
sentinel base code, and ``default_edit`` — the single-device Myers gate.
The short-read candidate/overlap route of the reference is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hga_tpu_torch.ops.myers import MyersResult
from hga_tpu_torch.ops.myers_cuda import myers_batch_cuda

SENT_BASE = 4  # padding base code: never matches a real base 0..3


def default_edit():
    """Edit-distance dispatch for the overlap gate: K1's wrapper, which
    launches the kernel for CUDA tensors and runs its plain version for CPU
    tensors."""

    def edit(q, t, ql, tl) -> MyersResult:
        i32 = lambda x: x.to(torch.int32).contiguous()
        return myers_batch_cuda(i32(q), i32(t), i32(ql), i32(tl))

    return edit


@dataclasses.dataclass
class OverlapRecords:
    """PAF-shaped overlaps.

    Coordinates are 0-based half-open in each read's FORWARD frame; rel=1
    means b maps reverse-complemented.  score is the DP score (all-integer);
    dist is the gate's unit-cost edit distance over the expected overlap
    segment (identity ~= 1 - dist / block_len).
    """

    a: np.ndarray
    b: np.ndarray
    rel: np.ndarray
    score: np.ndarray
    a_start: np.ndarray
    a_end: np.ndarray
    b_start: np.ndarray
    b_end: np.ndarray
    a_len: np.ndarray
    b_len: np.ndarray
    dist: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.dist is None:
            self.dist = np.zeros(self.a.shape[0], np.int32)

    @property
    def n(self) -> int:
        return int(self.a.shape[0])

    def identity(self) -> np.ndarray:
        """Per-record alignment identity estimate from the gate distance."""
        blk = np.maximum(np.maximum(self.a_end - self.a_start,
                                    self.b_end - self.b_start), 1)
        return np.clip(1.0 - self.dist / blk, 0.0, 1.0)

    def save(self, path: str) -> None:
        np.savez_compressed(path, **dataclasses.asdict(self))

    @staticmethod
    def load(path: str) -> "OverlapRecords":
        from hga_tpu_torch.convert import load_overlaps

        return load_overlaps(path)

    def to_paf(self, names_a, names_b) -> str:
        lines = []
        for i in range(self.n):
            blk = max(int(self.a_end[i] - self.a_start[i]),
                      int(self.b_end[i] - self.b_start[i]))
            matches = max(blk - int(self.dist[i]), 0)
            lines.append("\t".join(map(str, [
                names_a[self.a[i]], self.a_len[i], self.a_start[i], self.a_end[i],
                "+-"[int(self.rel[i])],
                names_b[self.b[i]], self.b_len[i], self.b_start[i], self.b_end[i],
                matches, blk, 255,
                f"NM:i:{int(self.dist[i])}",
                f"AS:i:{int(self.score[i])}",
                f"de:f:{int(self.dist[i]) / max(blk, 1):.4f}",
            ])))
        return "\n".join(lines) + ("\n" if lines else "")
