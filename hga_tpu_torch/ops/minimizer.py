"""L2 device ops — (w,k)-minimizer selection as a vectorized window-min.

Counterpart of ``hga_tpu.ops.minimizer`` in PyTorch, same semantics:
* hash = fmix32(lo ^ hi*golden); invalid k-mers never win a window.
* window j over k-mer positions [j, j+w); winner = leftmost minimal hash.
* consecutive windows choosing the same position emit one minimizer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hga_tpu_torch.ops.kmer import KmerBatch, kmer_hash32


class MinimizerBatch(NamedTuple):
    """Per-read minimizers; tensors shaped (R, n_windows) with `take`."""

    pos: torch.Tensor     # int64 — k-mer position of the selected minimizer
    hi: torch.Tensor      # int64 (uint32 values)
    lo: torch.Tensor
    strand: torch.Tensor  # uint8
    take: torch.Tensor    # bool


def select_minimizers(kb: KmerBatch, w: int, length: torch.Tensor,
                      k: int) -> MinimizerBatch:
    """length: (R,) true read lengths — windows extending past the read end
    are suppressed entirely."""
    R, m = kb.hi.shape
    n_win = m - w + 1
    if n_win <= 0:
        raise ValueError(f"read capacity yields {m} k-mers < window {w}")
    dev = kb.hi.device
    h = kmer_hash32(kb.hi, kb.lo)
    inv = ~kb.valid  # invalid k-mers must lose every comparison

    # window-min over w shifted views; strict < keeps the leftmost winner
    best_h = h[:, :n_win]
    best_inv = inv[:, :n_win]
    best_pos = torch.zeros((R, n_win), dtype=torch.int64, device=dev)
    for t in range(1, w):
        ch = h[:, t:t + n_win]
        cinv = inv[:, t:t + n_win]
        wins = (~cinv & best_inv) | ((cinv == best_inv) & (ch < best_h))
        best_h = torch.where(wins, ch, best_h)
        best_inv = torch.where(wins, cinv, best_inv)
        best_pos = torch.where(wins, t, best_pos)
    pos = best_pos + torch.arange(n_win, dtype=torch.int64, device=dev)[None, :]

    # dedupe consecutive windows that chose the same position
    new_sel = torch.ones((R, n_win), dtype=torch.bool, device=dev)
    new_sel[:, 1:] = pos[:, 1:] != pos[:, :-1]
    win = torch.arange(n_win, dtype=torch.int64, device=dev)[None, :]
    window_real = win <= (length.to(torch.int64)[:, None] - (k + w - 1))
    take = new_sel & ~best_inv & window_real
    return MinimizerBatch(
        pos=pos, hi=torch.gather(kb.hi, 1, pos), lo=torch.gather(kb.lo, 1, pos),
        strand=torch.gather(kb.strand, 1, pos), take=take)
