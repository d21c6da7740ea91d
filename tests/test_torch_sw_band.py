"""K3'' (csrc/sw.cu ``sw_band_kernel<K>``), the SW kernel for queries
longer than 256, on the CPU: its schedule emulated step by step in plain
PyTorch and held exactly against the plain ``banded_sw_batch``; the plain
version against the JAX package (XLA and the Pallas kernel in interpret
mode) at Lq > 256; the three routes of ``align_cuda.route`` and the band
window's geometry; and, marked ``cuda``, the kernel against its plain
version on the card.

The emulation follows the kernel's order of work, which the plain version
does not: a window of 32 K >= band + 1 slots per anti-diagonal d, slot s
on row i0(d) + s with i0(d) = ceil((d - band) / 2); the neighbour on d - 1
besides slot s is slot s - 1 (parity 0, a shuffle up across lanes) or
s + 1 (parity 1, a shuffle down); the codes read from the staged, -1-padded
windows at the kernel's own offsets; the steps run in pairs from the first
parity-0 anti-diagonal; per-slot bests (H, d) with a strict >; a lane's
slots, then the warp's xor butterfly on (H, d, slot)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.ops import align as JA
from hga_tpu.ops.align_pallas import banded_sw_batch_pallas
from hga_tpu_torch.ops import align as TA
from hga_tpu_torch.ops import align_cuda as TAC
from hga_tpu_torch.utils import spans

SW_FIELDS = ("score", "qend", "tend")
BIG = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _staged(x, lo, width, reverse):
    """A warp's staged window of one operand: x[lo + y] (or x[lo - y] when
    `reverse`) for y < width, -1 outside the codes; and the padding mask."""
    N, L = x.shape
    u = lo - torch.arange(width) if reverse else lo + torch.arange(width)
    pad = (u < 0) | (u >= L)
    if L == 0:
        return torch.full((N, width), -1, dtype=torch.int32), pad
    return torch.where(pad, -1, x[:, u.clamp(0, L - 1)]), pad


def _take(b, o):
    """The kernel's tie rule: max H, then min d, then min slot."""
    v, d, p = b
    ov, od, op = o
    better = (ov > v) | ((ov == v) & ((od < d) | ((od == d) & (op < p))))
    return tuple(torch.where(better, y, x) for x, y in zip(b, o))


def sw_band_schedule(q, t, qlen, tlen, band, match=2, mismatch=-4, gap=-3):
    """K3'' as the kernel runs it, vectorised over pairs and a warp's 32
    lanes of K slots.  Asserts that every read lies inside the staged
    windows, that no cell in the band and the lengths reads the padding,
    and that each step's parity is (d - band) & 1."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, max(Lq, Lt))
    K = -(-(band + 1) // 32)        # the kernel instantiates K = 1 .. 8
    S = 32 * K
    g = TAC.band_geometry(Lq, Lt, band, K)
    qs, qpad = _staged(q, g.qlo, g.qwin, False)
    ts, tpad = _staged(t, g.thi, g.twin, True)
    s = torch.arange(S)
    ql = qlen.long().clamp(0, Lq)[:, None]
    tl = torch.clamp(tlen.long(), max=Lt)[:, None]
    dlo = torch.maximum(band - 2 * s + 1, 2 * s + 2 - band)
    dhi = torch.where(s <= band, torch.minimum(2 * (ql - s) + band,
                                               2 * (tl + s) + 1 - band), -1)
    dend = torch.where(ql[:, 0] >= 1, ql[:, 0] + torch.minimum(
        tl[:, 0], ql[:, 0] + band), 1)
    d0 = 2 - (band & 1)
    i0 = (d0 - band) // 2
    qoff, toff = i0 - 1 - g.qlo, g.thi - (d0 - i0 - 1) + 1
    z = torch.zeros((N, S), dtype=torch.int64)
    H = [z, z.clone()]              # the kernel's A and B
    bv, bd = z.clone(), z.clone()
    zlane = torch.zeros((N, 1), dtype=torch.int64)
    for d in range(d0, int(dend.max()) + 1, 2):
        active = (d <= dend)[:, None]
        for delta in (0, 1):
            dd = d + delta
            assert (dd - band) & 1 == delta
            if delta == 0:
                toff -= 1
            else:
                qoff += 1
            assert 0 <= qoff and qoff + S <= g.qwin
            assert 0 <= toff and toff + S <= g.twin
            X, Y = H[delta], H[1 - delta]
            lanes = Y.view(N, 32, K)
            if delta == 0:              # slot s - 1: lane l - 1's last slot
                edge = torch.cat([zlane, lanes[:, :-1, K - 1]], dim=1)
                nb = torch.cat([edge[:, :, None], lanes[:, :, :-1]], dim=2)
            else:                       # slot s + 1: lane l + 1's first slot
                edge = torch.cat([lanes[:, 1:, 0], zlane], dim=1)
                nb = torch.cat([lanes[:, :, 1:], edge[:, :, None]], dim=2)
            nb = nb.reshape(N, S)
            inb = (dd >= dlo) & (dd <= dhi)
            if delta == 1:
                inb &= s != band
            assert not bool((inb & (qpad[qoff:qoff + S]
                                    | tpad[toff:toff + S])).any())
            sub = torch.where(qs[:, qoff:qoff + S] == ts[:, toff:toff + S],
                              match, mismatch)
            v = torch.clamp(torch.maximum(X + sub,
                                          torch.maximum(Y, nb) + gap), min=0)
            v = torch.where(inb, v, 0)
            better = active & (v > bv)
            bv = torch.where(better, v, bv)
            bd = torch.where(better, dd, bd)
            H[delta] = torch.where(active, v, X)
    # a lane's K slots in order, then the xor butterfly across lanes
    lv, ld, lp = (x.view(N, 32, K) for x in (bv, bd, s.expand(N, S)))
    b = (torch.full((N, 32), -1), torch.full((N, 32), BIG),
         torch.full((N, 32), BIG))
    for k in range(K):
        b = _take(b, (lv[:, :, k], ld[:, :, k], lp[:, :, k]))
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        b = _take(b, tuple(x[:, lane ^ o] for x in b))
    v, d, p = (x[:, 0] for x in b)
    has = v > 0
    qend = torch.where(has, -((band - d) // 2) + p, 0)
    return (v.to(torch.int32), qend.to(torch.int32),
            torch.where(has, d - qend, 0).to(torch.int32))


def _sw_inputs(seed, N, Lq, Lt, band):
    """Planted pairs with ragged lengths (0 and full included), -1 codes in
    queries and targets (the windows' padding value: a counted cell must
    never meet it), code 4 rows, rows of -1 only, homopolymers and ACAC...
    repeats (ties on many cells and slots)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(N):
        lead = int(rng.integers(0, max(1, min(band, Lt) // 2 + 1)))
        seg = q[n, : Lt - lead].copy()
        flip = rng.random(seg.size) < 0.08
        seg[flip] = (seg[flip] + 1) % 4
        t[n, lead:lead + seg.size] = seg
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    tl = rng.integers(0, Lt + 1, N).astype(np.int32)
    ql[:4], tl[:4] = [0, Lq, Lq, 1], [Lt, 0, Lt, Lt]
    q[4, ::3], t[4, : Lt // 2] = -1, -1
    q[5], t[5] = -1, -1
    q[6], t[6] = 4, 4
    q[7], t[7] = 0, 0
    q[8, ::2], q[8, 1::2] = 0, 1
    t[8, ::2], t[8, 1::2] = 1, 0
    ql[4:9], tl[4:9] = Lq, Lt
    return q, t, ql, tl


def _assert_schedule_matches_plain(Lq, Lt, band, N, seed):
    q, t, ql, tl = _t(*_sw_inputs(seed, N, Lq, Lt, band))
    got = sw_band_schedule(q, t, ql, tl, band)
    ref = TA.banded_sw_batch(q, t, ql, tl, band=band)
    assert int(ref.score.max()) > 0
    for f, g in zip(SW_FIELDS, got):
        assert torch.equal(g, getattr(ref, f)), (Lq, band, f)


@pytest.mark.parametrize("band", [0, 1, 64, 127, 128, "ge"])
@pytest.mark.parametrize("Lq", [257, 320, 1024])
def test_sw_band_schedule_matches_plain(Lq, band):
    """Bands 0 .. 128 take the kernel at Lq 257 and 320; band >= Lq (a
    window of the clamped band + 1 slots, past the kernel's 256) holds the
    schedule's geometry alone."""
    band = Lq + 7 if band == "ge" else band
    _assert_schedule_matches_plain(Lq, Lq + 72, band, 24 if Lq < 1024 else 12,
                                   Lq + band)


@pytest.mark.parametrize("band", [31, 32, 63, 64, 255])
def test_sw_band_schedule_at_slot_count_edges(band):
    """band + 1 = 32, 33, 64, 65, 256: K's edges, slot band on the last
    lane's last slot or alone on a lane."""
    assert TAC.band_slots(band) == -(-(band + 1) // 32)
    _assert_schedule_matches_plain(320, 392, band, 24, band)


@pytest.mark.parametrize("Lq,Lt,band", [(300, 120, 64), (290, 900, 64),
                                        (260, 30, 100), (400, 400, 7)])
def test_sw_band_schedule_other_aspects(Lq, Lt, band):
    """Targets shorter than the query, far longer than Lq + band, a band
    above the target, an odd band."""
    _assert_schedule_matches_plain(Lq, Lt, band, 16, Lq * Lt + band)


def test_sw_band_schedule_refine_reverse_pass():
    """The refine's reverse pass at Lq 320: reversed prefixes of the
    forward best cell, code 4 past them, twice the band."""
    Lq, band = 320, 64
    Lt = Lq + band + 8
    q, t, ql, tl = _sw_inputs(3, 24, Lq, Lt, band)
    fwd = TA.banded_sw_batch(*_t(q, t, ql, tl), band=band)
    qe, te = fwd.qend.numpy(), fwd.tend.numpy()

    def rev(x, n):
        idx = (n[:, None] - 1) - np.arange(x.shape[1])[None, :]
        return np.where(idx >= 0, np.take_along_axis(
            x, np.clip(idx, 0, x.shape[1] - 1), 1), 4).astype(np.int32)

    args = _t(rev(q, qe), rev(t, te), qe.astype(np.int32),
              te.astype(np.int32))
    got = sw_band_schedule(*args, 2 * band)
    ref = TA.banded_sw_batch(*args, band=2 * band)
    for f, g in zip(SW_FIELDS, got):
        assert torch.equal(g, getattr(ref, f)), f
    assert torch.equal(ref.score, fwd.score)


@pytest.mark.parametrize("band", [0, 64, 128, "ge"])
@pytest.mark.parametrize("Lq", [257, 320])
def test_sw_plain_matches_jax_above_256(Lq, band):
    band = Lq + 5 if band == "ge" else band
    Lt = Lq + 72
    q, t, ql, tl = _sw_inputs(11 * Lq + band, 16, Lq, Lt, band)
    ref = JA.banded_sw_batch(*_j(q, t, ql, tl), band=band)
    got = TA.banded_sw_batch(*_t(q, t, ql, tl), band=band)
    assert int(np.asarray(ref.score).max()) > 0
    for f in SW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("Lq,band", [(257, 64), (320, 128)])
def test_sw_plain_matches_pallas_interpret_above_256(Lq, band):
    Lt = Lq + 40
    q, t, ql, tl = _sw_inputs(Lq, 16, Lq, Lt, band)
    ref = banded_sw_batch_pallas(*_j(q, t, ql, tl), band=band, pair_tile=8,
                                 interpret=True, blk=8)
    got = TA.banded_sw_batch(*_t(q, t, ql, tl), band=band)
    for f in SW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_sw_routes_three_kinds():
    # K3' keeps every shape it served: Lq <= 256 with its windows fitting
    assert TAC.route(112, 184, 64)[:3] == ("diag", 4, 4)
    assert TAC.route(256, 400, 128).kind == "diag"
    # K3'' above Lq 256, K the smallest with 32 K >= band + 1
    for band, K in ((0, 1), (31, 1), (32, 2), (63, 2), (64, 3), (127, 4),
                    (128, 5), (255, 8)):
        assert TAC.band_slots(band) == K
        r = TAC.route(320, 392, band)
        assert r == TAC.Route("band", K, 4, TAC.band_smem_bytes(
            320, 392, band, K, 4), False), band
    assert TAC.band_slots(256) is None
    # the 300 bp refine: forward band 64 (K 3), reverse band 128 (K 5)
    assert TAC.route(320, 392, 64) == TAC.Route("band", 3, 4, 14336, False)
    assert TAC.route(320, 392, 128) == TAC.Route("band", 5, 4, 16512, False)
    # Lq <= 256 with a target past the diag route's windows: the band
    # route's windows do not grow with the target
    assert TAC.route(100, 58000, 64)[:3] == ("band", 3, 4)
    # K3''' takes a clamped band above 255 (above Lq 256 the clamp is
    # >= 257) and queries past the band route's windows; K3's row route
    # takes no shape (it is forced only)
    assert TAC.route(257, 200, 5000)[:2] == ("wide", 5)
    assert TAC.route(257, 300, 256) == TAC.wide_route(257, 300, 256)
    assert TAC.route(1000, 1000, 960)[:2] == ("wide", 8)
    assert TAC.route(28000, 28100, 64)[:3] == ("band", 3, 1)
    assert TAC.route(30000, 30100, 64)[:3] == ("wide", 3, 4)
    assert TAC.rows_route(1000, 1000, 960).scratch is True
    assert TAC.ROUTE_COUNTER["band"] == "banded_sw_batch_cuda_band"
    assert len(set(TAC.ROUTE_COUNTER.values())) == len(TAC.ROUTE_COUNTER)


def test_sw_band_geometry():
    """The windows at the refine's shapes; past Lt = Lq + band they no
    longer grow with the target (the band bounds the columns); they reach
    past the query's last code and below the target's first."""
    assert TAC.band_geometry(320, 392, 64, 3) == (-32, 448, 383, 448)
    assert TAC.band_smem_bytes(320, 392, 64, 3, 4) == 4 * 896 * 4
    far = [TAC.band_geometry(300, lt, 64, 3) for lt in (364, 1000, 60000)]
    assert far[0] == far[1] == far[2]
    for Lq, Lt, band in ((257, 329, 0), (320, 392, 128), (1024, 1100, 255)):
        K = TAC.band_slots(band)
        g = TAC.band_geometry(Lq, Lt, band, K)
        assert g.qlo <= 0 and g.qlo + g.qwin >= Lq + 1
        assert g.thi >= min(Lt, Lq + band) - 1 and g.thi - g.twin < 0
    q = torch.zeros((4, 320), dtype=torch.int32)
    t = torch.zeros((4, 392), dtype=torch.int32)
    n = torch.ones(4, dtype=torch.int32)
    r, qa, ta, *_, band, scratch, outs = TAC.kernel_operands(q, t, n, n, 64)
    assert r.kind == "band" and qa is q and ta is t and scratch is None
    r, qa, ta, *_ = TAC.kernel_operands(q, t, n, n, 64, kind="rows")
    assert r.kind == "rows" and qa.shape == (320, 4)
    q112 = torch.zeros((4, 112), dtype=torch.int32)
    t184 = torch.zeros((4, 184), dtype=torch.int32)
    assert TAC.kernel_operands(q112, t184, n, n, 64, kind="band")[0][:2] == \
        ("band", 3)
    with pytest.raises(ValueError, match="diag route"):
        TAC.kernel_operands(q, t, n, n, 64, kind="diag")


def test_wrapper_on_cpu_takes_the_plain_version_at_lq_320():
    q, t, ql, tl = _t(*_sw_inputs(5, 12, 320, 392, 64))
    before = spans.launches()
    got = TAC.banded_sw_batch_cuda(q, t, ql, tl, band=64)
    ref = TA.banded_sw_batch(q, t, ql, tl, band=64)
    for f in SW_FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert spans.launches() == before


@pytest.mark.cuda
def test_cuda_band_kernel_matches_plain(cuda):
    for Lq, Lt, band in ((257, 329, 0), (257, 329, 1), (320, 392, 64),
                         (320, 392, 128), (320, 392, 255), (1024, 1100, 64),
                         (100, 58000, 64)):
        args = [x.to(cuda) for x in _t(*_sw_inputs(Lq, 300, Lq, Lt, band))]
        assert TAC.route(Lq, Lt, band).kind == "band"
        n = spans.launches()["banded_sw_batch_cuda_band"]
        got = TAC.banded_sw_batch_cuda(*args, band=band)
        assert spans.launches()["banded_sw_batch_cuda_band"] == n + 1
        ref = TA.banded_sw_batch(*args, band=band)
        for f in SW_FIELDS:
            assert torch.equal(getattr(got, f), getattr(ref, f)), \
                (Lq, band, f)
