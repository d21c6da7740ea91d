"""Frozen peaks and operation counts of the benchmark's rooflines.

A copy of the arithmetic of ``hga_tpu_torch/utils/benchmarks.py``
(``bound_ms``), kept here so that the yardstick stays as it is while the
program changes.  The count is the algorithm's work at the call's shapes,
whatever implements it.
"""

from __future__ import annotations

import math
from typing import Optional

# name of the card (a part of torch.cuda.get_device_name()) -> peaks
PEAKS = {
    # 132 SMs x 64 int32 lanes x 1.98 GHz; HBM3 at 3.35 TB/s (data sheet)
    "H100": dict(int32_ops_per_s=132 * 64 * 1.98e9, bytes_per_s=3.35e12),
}

# int32 operations a 32-bit word of the query does a target column in the
# bit-parallel Myers recurrence (the repo's count, after the compiler's
# 3-input logic fusion)
MYERS_OPS_PER_WORD_COLUMN = 20
WORD_BITS = 32


def peaks(device_kind: str) -> Optional[dict]:
    for part, p in PEAKS.items():
        if part in device_kind:
            return p
    return None


def myers_ops(pairs: int, target_cols: int, query_len: int) -> float:
    """Operations of a Myers sweep: every pair against every target
    column, ceil(query_len / 32) words a column."""
    return (float(pairs) * target_cols * math.ceil(query_len / WORD_BITS)
            * MYERS_OPS_PER_WORD_COLUMN)


def myers_bound_s(pairs: int, target_cols: int, query_len: int,
                  device_kind: str) -> Optional[float]:
    """The least seconds the card could take for the sweep: its operations
    over the int32 peak (its bytes, the codes read once, are far below the
    byte bound).  None for a card the table does not hold."""
    p = peaks(device_kind)
    if p is None:
        return None
    ops_s = myers_ops(pairs, target_cols, query_len) / p["int32_ops_per_s"]
    bytes_s = (pairs * query_len + target_cols) / p["bytes_per_s"]
    return max(ops_s, bytes_s)
