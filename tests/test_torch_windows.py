"""K1''s target windows (csrc/myers_gate.cu: a launch's columns split over
blockIdx.y, each window restarting the DP a halo of 2 x 31 x W columns
before its own) on the CPU: the plain ``ops/myers.myers_cols_windowed``,
which splits, restarts and reduces as the kernel does, held bit for bit
against the JAX package's one-sweep ``myers_batch`` / ``myers_cols`` in the
cases that push the halo; the wrapper's choice of windows; and, marked
``cuda``, the windowed kernel against its one-sweep plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.ops import myers as JM
from hga_tpu_torch.ops import myers as TM
from hga_tpu_torch.ops import myers_cuda as TMC


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _halo_cases(W: int = 2, N: int = 12, n_win: int = 5):
    """A shared row (1, Lt) of n_win windows of one halo H each (the
    smallest legal window) and N queries of Lq = 31 W: row 0 the full query
    against an interleaved copy (query base, other base, ...) of
    2 qlen - 1 columns that ends 3 columns past the second window edge, so
    its alignments span up to 2 qlen - 1 columns back across that edge;
    row 1 two exact copies, one ending 5 columns before the third edge and
    one starting 5 columns after it (equal minima on both sides); rows 2-5
    tlen ending inside a halo, on an edge, inside an owned range and at 0;
    row 6 qlen 0, row 7 qlen 1; the rest random queries, some copied from
    the row with edits."""
    rng = np.random.default_rng(17)
    Lq = 31 * W
    H = TM.window_halo(W)
    Lt = n_win * H
    row = rng.integers(0, 4, Lt).astype(np.int32)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    ql = np.full(N, Lq, np.int32)
    tl = np.full(N, Lt, np.int32)
    end = 2 * H + 3                          # the interleave's last column
    other = (q[0] + 1 + rng.integers(0, 3, Lq)) % 4
    inter = np.stack([q[0], other], 1).reshape(-1)[:2 * Lq - 1]
    row[end - inter.size:end] = inter
    for e in (3 * H - 5, 3 * H + Lq + 5):
        row[e - Lq:e] = q[1]
    tl[2:6] = [H // 2 + H, 2 * H, 2 * H + H // 3, 0]
    ql[6], ql[7] = 0, 1
    for n in range(8, N, 2):
        off = int(rng.integers(0, Lt - Lq))
        q[n] = row[off:off + Lq]
        q[n, rng.integers(0, Lq, 3)] = rng.integers(0, 4, 3)
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    return q, row[None, :], ql, tl, H


def test_windowed_cols_match_jax_one_sweep():
    """myers_cols_windowed at the smallest legal window (one halo), at
    other windows and over carried chunks equals the JAX package's one
    sweep bit for bit: dist and tend against myers_batch, the whole state
    (pv, mv, score, best, bj) against myers_cols."""
    q, t, ql, tl, H = _halo_cases()
    W = TM.n_words(q.shape[1])
    ref = JM.myers_batch(*_j(q, t, ql, tl))
    jst = JM.myers_cols(*JM.query_planes(*_j(q, ql), W), jnp.asarray(t),
                        jnp.asarray(tl), JM.myers_init_state(jnp.asarray(ql),
                                                             W))
    qt, tt, qlt, tlt = _t(q, t, ql, tl)
    qp = TM.query_planes(qt, qlt, W)
    # the earlier of two equal minima around edge 3
    dist, tend = np.asarray(ref.dist), np.asarray(ref.tend)
    assert (dist[1], tend[1]) == (0, 3 * H - 5)
    for window in (H, H + 1, 2 * H, 3 * H - 1):
        st = TM.myers_cols_windowed(*qp, tt, qlt, tlt,
                                    TM.myers_init_state(qlt, W), 0, window)
        for a, b in zip(st, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        res = TM.state_result(qlt, st)
        np.testing.assert_array_equal(res.dist.numpy(), dist)
        np.testing.assert_array_equal(res.tend.numpy(), tend)
    with pytest.raises(ValueError, match="halo"):
        TM.myers_cols_windowed(*qp, tt, qlt, tlt, TM.myers_init_state(qlt, W),
                               0, H - 1)
    # a carried state in and out over 2, 3 and 8 chunks, each chunk
    # windowed at one halo where it is long enough
    rng = np.random.default_rng(5)
    Lt = t.shape[1]
    for n in (2, 3, 8):
        cuts = np.sort(rng.choice(np.arange(1, Lt), n - 1, replace=False))
        st, j0 = TM.myers_init_state(qlt, W), 0
        for c in list(cuts) + [Lt]:
            st = TM.myers_cols_windowed(*qp, tt[:, j0:c], qlt, tlt, st, j0, H)
            j0 = int(c)
        for a, b in zip(st, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_windows_by_shape():
    """gate_window: one window below 8 halos (the per-pair gates and config
    3), else enough windows for WINDOW_WARPS_SM warps an SM, none shorter
    than 4 halos: segment_identity at 1 Mb (N 2,614, W 13, 2 pairs a warp)
    takes 13 windows, the ring's step on 2 ranks (N 654, 1,000,001 columns)
    52.  gate_route takes windows by shape only in the shared-row modes
    (`shared_rows`) and on the split design; it forces windows no shorter
    than the halo, and none at G 1 below group_width(W)."""
    H13 = TM.window_halo(13)
    assert H13 == 806 and TMC.WINDOW_WARPS_SM == 128
    assert TMC.gate_window(4096, 14, 16, 478) == 478          # long overlaps
    assert TMC.gate_window(4096, 4, 4, 184) == 184            # config 3
    assert TMC.gate_window(2614, 13, 16, 8 * H13 - 1) == 8 * H13 - 1
    r = TMC.gate_route(2614, 384, 2_000_001, shared_rows=True)
    assert (r.S, r.window, r.halo) == (13, 153_847, H13)
    r = TMC.gate_route(654, 384, 1_000_001, shared_rows=True)
    assert r.S == 52 and r.window >= 4 * H13
    assert -(-1_000_001 // r.window) == r.S
    # per-pair rows, or G 1 beside the split design: one window by shape
    assert TMC.gate_route(2614, 384, 2_000_001).S == 1
    assert TMC.gate_route(2614, 384, 2_000_001, group=1,
                          shared_rows=True).S == 1
    with pytest.raises(ValueError, match="lanes a pair"):
        TMC.gate_route(20, 384, 8001, group=1, window=H13)
    # a few pairs: windows down to 4 halos; many pairs: one window
    r = TMC.gate_route(20, 384, 8001, shared_rows=True)
    assert r.S == 2 and r.window == 4001
    assert TMC.gate_route(100_000, 384, 100_000, shared_rows=True).S == 1
    assert TMC.gate_route(20, 384, 8001, window=H13).S == 10
    with pytest.raises(ValueError, match="halo"):
        TMC.gate_route(20, 384, 8001, window=H13 - 1)
    assert TMC.gate_route(20, 384, 500, window=600).S == 1    # >= Lt: one
    # the wrapper's scratch: a (best, bj) slot a pair where S > 1
    q = torch.zeros((20, 384), dtype=torch.int32)
    row = torch.zeros((1, 8001), dtype=torch.int32)
    one = torch.ones(20, dtype=torch.int32)
    ops = TMC.kernel_operands(q, row, one, one)
    r, shared, (slot, words) = ops[4], ops[5], ops[6]
    assert r.S == 2 and shared and slot.shape == (20,) and words is None
    assert TMC.kernel_operands(q, row, one, one, window=8001)[6] == \
        (None, None)
    # per-pair rows take one window; the carried-state mode takes windows
    rows = torch.zeros((20, 8001), dtype=torch.int32)
    assert TMC.kernel_operands(q, rows, one, one)[4].S == 1
    st = TM.myers_init_state(one, 13)
    assert TMC.carry_operands(q, rows, one, one, st)[4].S == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_windows_match_one_sweep(cuda):
    q, t, ql, tl, H = _halo_cases(N=40)
    args = [x.to(cuda) for x in _t(q, t, ql, tl)]
    W = TM.n_words(q.shape[1])
    ref = TM.myers_batch(*args)
    st_ref = TM.myers_cols(*TM.query_planes(args[0], args[2], W), args[1],
                           args[3], TM.myers_init_state(args[2], W))
    for window in (H, 2 * H, t.shape[1]):
        *ops, outs = TMC.kernel_operands(*args, window=window)
        TMC.run_kernel(*ops, outs)
        assert torch.equal(outs[0], ref.dist) and torch.equal(outs[1],
                                                              ref.tend)
        *ops, outs = TMC.carry_operands(
            *args, TM.myers_init_state(args[2], W), window=window)
        TMC.run_carry_kernel(*ops, outs)
        assert torch.equal(outs[0], TM.pack_state(st_ref))
