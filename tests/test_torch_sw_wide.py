"""K3''' (csrc/sw.cu ``sw_wide_kernel<K>`` and ``sw_wide_mem_kernel``), the
SW kernel for every shape the diag and band routes do not take, on the CPU:
its schedule emulated step by step in plain PyTorch and held exactly
against the JAX package's ``banded_sw_batch`` (XLA); the routes of
``align_cuda.route`` (no shape takes the row route) and K3''''s geometry;
and, marked ``cuda``, the kernel against its plain version on the card.

The emulation follows the kernel's order of work: band + 1 slots an
anti-diagonal d, slot s on row i0(d) + s with i0(d) = ceil((d - band) / 2),
laid out over nw warps of 32 lanes of K slots (slot s on thread s // K of
the pair); inside a warp the neighbour on d - 1 is the K3'' shuffle, and
across warps the word each warp published after the step before (its
first slot after a parity-0 step, its last after a parity-1 step); the
codes read from windows staged a chunk of anti-diagonals at a time (the
kernel's 256, and a forced small chunk that refills often), -1 outside the
codes, at the kernel's own offsets; steps in pairs; per-slot bests with a
strict >, then (H, d, slot) reduced over a lane, the warp and the pair's
warps.  With the slots in memory (a band past 2047, or forced): two rows
with zero sentinels, 512 threads on slots x, x + 512, ..., a running best
a thread over its slots in order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.ops import align as JA
from hga_tpu_torch.ops import align as TA
from hga_tpu_torch.ops import align_cuda as TAC

SW_FIELDS = ("score", "qend", "tend")
SPAN = 1 << 20    # past any anti-diagonal and slot of these shapes


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


def _lex_best(v, d, p):
    """The kernel's tie rule over the last axis: max H, then min d, then
    min slot."""
    key = (v.long() * SPAN - d.long()) * SPAN - p.long()
    i = key.argmax(dim=-1, keepdim=True)
    return tuple(x.gather(-1, i)[..., 0] for x in (v, d, p))


def _staged(x, lo, width, reverse):
    """One chunk's window of an operand: x[lo + y] (x[lo - y] reversed)
    for y < width, -1 outside the codes; and the padding mask."""
    N, L = x.shape
    u = lo - torch.arange(width) if reverse else lo + torch.arange(width)
    pad = (u < 0) | (u >= L)
    if L == 0:
        return torch.full((N, width), -1, dtype=torch.int64), pad
    return torch.where(pad, -1, x[:, u.clamp(0, L - 1)].long()), pad


def _bounds(band, S, ql, tl):
    s = torch.arange(S)
    dlo = torch.maximum(band - 2 * s + 1, 2 * s + 2 - band)
    dhi = torch.where(s <= band, torch.minimum(2 * (ql - s) + band,
                                               2 * (tl + s) + 1 - band), -1)
    return s, dlo, dhi


def _result(v, d, p, band):
    has = v > 0
    qend = torch.where(has, -((band - d) // 2) + p, 0)
    return (v.to(torch.int32), qend.to(torch.int32),
            torch.where(has, d - qend, 0).to(torch.int32))


def sw_wide_registers(q, t, qlen, tlen, band, chunk=TAC.WIDE_CHUNK,
                      match=2, mismatch=-4, gap=-3):
    """K3''' with register slots as the kernel runs it (wide_route's K and
    nw), vectorised over pairs.  Asserts that every read lies inside the
    chunk's windows, that no cell in the band and the lengths reads the
    padding, and that each step's parity is (d - band) & 1."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, max(Lq, Lt))
    r = TAC.wide_route(Lq, Lt, band)
    K, nw = r.K, r.nw
    assert K >= 1 and 32 * K * nw >= band + 1
    S = 32 * K * nw
    win = chunk // 2 + S
    ql = qlen.long().clamp(0, Lq)[:, None]
    tl = torch.clamp(tlen.long(), max=Lt)[:, None]
    s, dlo, dhi = _bounds(band, S, ql, tl)
    dend = torch.where(ql[:, 0] >= 1, ql[:, 0] + torch.minimum(
        tl[:, 0], ql[:, 0] + band), 1)
    z = torch.zeros((N, S), dtype=torch.int64)
    H = [z, z.clone()]                  # the kernel's A and B
    bv, bd = z.clone(), z.clone()
    xf = torch.zeros((N, nw), dtype=torch.int64)   # published words
    xl = torch.zeros((N, nw), dtype=torch.int64)
    zcol = torch.zeros((N, 1), dtype=torch.int64)
    d0 = 2 - (band & 1)
    for dc in range(d0, int(dend.max()) + 1, chunk):
        i0c = (dc - band) // 2
        assert (dc - band) % 2 == 0
        qs, qpad = _staged(q, i0c - 1, win, False)
        ts, tpad = _staged(t, dc - i0c + chunk // 2 - 1, win, True)
        qoff, toff = 0, chunk // 2 + 1
        for d in range(dc, min(dc + chunk - 2, int(dend.max())) + 1, 2):
            active = (d <= dend)[:, None]
            for delta in (0, 1):
                dd = d + delta
                assert (dd - band) & 1 == delta
                if delta == 0:
                    toff -= 1
                else:
                    qoff += 1
                assert 0 <= qoff and qoff + S <= win
                assert 0 <= toff and toff + S <= win
                X, Y = H[delta], H[1 - delta]
                lanes = Y.view(N, nw, 32, K)
                if delta == 0:     # slot s - 1; lane 0 takes the warp below's
                    edge = torch.cat([xl[:, :-1], zcol], dim=1)
                    edge = torch.roll(edge, 1, dims=1)   # warp w takes w - 1
                    prev = torch.cat([edge[:, :, None],
                                      lanes[:, :, :-1, K - 1]], dim=2)
                    nb = torch.cat([prev[..., None], lanes[..., :-1]], dim=3)
                else:              # slot s + 1; lane 31 takes the warp above's
                    edge = torch.cat([xf[:, 1:], zcol], dim=1)
                    nxt = torch.cat([lanes[:, :, 1:, 0],
                                     edge[:, :, None]], dim=2)
                    nb = torch.cat([lanes[..., 1:], nxt[..., None]], dim=3)
                nb = nb.reshape(N, S)
                inb = (dd >= dlo) & (dd <= dhi)
                if delta == 1:
                    inb &= s != band
                assert not bool((inb & (qpad[qoff:qoff + S]
                                        | tpad[toff:toff + S])).any())
                sub = torch.where(qs[:, qoff:qoff + S]
                                  == ts[:, toff:toff + S], match, mismatch)
                v = torch.clamp(torch.maximum(
                    X + sub, torch.maximum(Y, nb) + gap), min=0)
                v = torch.where(inb, v, 0)
                better = active & (v > bv)
                bv = torch.where(better, v, bv)
                bd = torch.where(better, dd, bd)
                H[delta] = torch.where(active, v, X)
                w = H[delta].view(N, nw, 32, K)
                if delta == 0:     # each warp publishes its first slot ...
                    xf = torch.where(active, w[:, :, 0, 0], xf)
                else:              # ... or its last
                    xl = torch.where(active, w[:, :, 31, K - 1], xl)
    return _result(*_lex_best(bv, bd, s.expand(N, S)), band)


def sw_wide_memory(q, t, qlen, tlen, band, match=2, mismatch=-4, gap=-3):
    """K3''' with the slots in memory: two rows of band + 3 (slots -1 ..
    band + 1, the outer two 0), every step from d = 2, the neighbours read
    from the rows, MEM_THREADS threads each keeping a running best over its
    slots x, x + MEM_THREADS, ... in order; codes read only for cells in the
    band and the lengths."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, max(Lq, Lt))
    T = TAC.MEM_THREADS
    S = band + 1
    ql = qlen.long().clamp(0, Lq)[:, None]
    tl = torch.clamp(tlen.long(), max=Lt)[:, None]
    s, dlo, dhi = _bounds(band, S, ql, tl)
    dend = torch.where(ql[:, 0] >= 1, ql[:, 0] + torch.minimum(
        tl[:, 0], ql[:, 0] + band), 1)
    rows = [torch.zeros((N, S + 2), dtype=torch.int64) for _ in range(2)]
    per = -(-S // T)
    bv = torch.zeros((N, T), dtype=torch.int64)
    bd, bp = bv.clone(), bv.clone()
    qq, tt = q.long(), t.long()
    for d in range(2, int(dend.max()) + 1):
        active = (d <= dend)[:, None]
        X, Y = rows[d & 1], rows[1 - (d & 1)]
        delta = (d - band) & 1
        i0 = -((band - d) // 2)
        inb = (d >= dlo) & (d <= dhi)
        if delta == 1:
            inb &= s != band
        i = (i0 + s - 1).clamp(0, max(Lq - 1, 0))
        j = (d - i0 - s - 1).clamp(0, max(Lt - 1, 0))
        if Lq and Lt:
            sub = torch.where(qq[:, i] == tt[:, j], match, mismatch)
        else:
            sub = torch.zeros((N, S), dtype=torch.int64)
        nb = Y[:, 2 * delta:2 * delta + S]       # slot s - 1 or s + 1
        v = torch.clamp(torch.maximum(X[:, 1:S + 1] + sub, torch.maximum(
            Y[:, 1:S + 1], nb) + gap), min=0)
        v = torch.where(inb, v, 0)
        X[:, 1:S + 1] = torch.where(active, v, X[:, 1:S + 1])
        # each thread's slots in order: the first slot of its step maximum
        vt = torch.nn.functional.pad(v, (0, per * T - S)).view(N, per, T)
        m, k = vt.max(dim=1)                     # first max on ties
        take = active & (m > bv)
        bv = torch.where(take, m, bv)
        bd = torch.where(take, d, bd)
        bp = torch.where(take, k * T + torch.arange(T), bp)
    return _result(*_lex_best(bv, bd, bp), band)


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


def _check(got, ref, what):
    for f, g in zip(SW_FIELDS, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f"{what} {f}")


@pytest.mark.parametrize("band", [255, 256, 300, 511, 960, "ge"])
@pytest.mark.parametrize("Lq", [257, 320, 1100])
def test_sw_wide_schedule_matches_jax(Lq, band):
    """The register schedule at the kernel's chunk and at a forced chunk of
    8 anti-diagonals (a refill every four step pairs), and the memory
    schedule (slots forced out of the registers), against the JAX package's
    XLA banded_sw_batch, exactly."""
    band = Lq + 7 if band == "ge" else band
    Lt = Lq + 72
    N = 12 if Lq < 1100 else 10
    q, t, ql, tl = _sw_inputs(Lq * 7 + band, N, Lq, Lt, band)
    ref = JA.banded_sw_batch(*_j(q, t, ql, tl), band=band)
    assert int(np.asarray(ref.score).max()) > 0
    args = _t(q, t, ql, tl)
    _check(sw_wide_registers(*args, band), ref, "registers")
    _check(sw_wide_registers(*args, band, chunk=8), ref, "chunk 8")
    _check(sw_wide_memory(*args, band), ref, "memory")


@pytest.mark.parametrize("Lq,Lt,band", [(2100, 2172, 2100), (2200, 2300, 2047),
                                        (600, 3000, 64), (1500, 600, 40)])
def test_sw_wide_edges_match_jax(Lq, Lt, band):
    """Past the register slots (band + 1 > 2048: the memory schedule, which
    the route then takes), 2048 slots exactly (8 warps of K 8), a target far
    past Lq + band and one shorter than the query at small bands."""
    q, t, ql, tl = _sw_inputs(Lq + Lt + band, 10, Lq, Lt, band)
    ref = JA.banded_sw_batch(*_j(q, t, ql, tl), band=band)
    args = _t(q, t, ql, tl)
    clamped = min(band, max(Lq, Lt))
    r = TAC.wide_route(Lq, Lt, band)
    if clamped + 1 > 32 * TAC.WIDE_SLOTS * TAC.WIDE_WARPS:
        assert r.K == 0 and not r.scratch
    else:
        _check(sw_wide_registers(*args, band), ref, "registers")
    _check(sw_wide_memory(*args, band), ref, "memory")
    _check(TA.banded_sw_batch(*args, band=band), ref, "plain")


def test_sw_wide_schedule_refine_reverse_pass():
    """The 300 bp refine's reverse pass at band 128 x 2 = 256 (the shape
    phase 8 runs at --band 128): reversed prefixes of the forward best
    cell, code 4 past them."""
    Lq, band = 320, 128
    Lt = Lq + band + 8
    q, t, ql, tl = _sw_inputs(3, 24, Lq, Lt, band)
    fwd = TA.banded_sw_batch(*_t(q, t, ql, tl), band=band)
    qe, te = fwd.qend.numpy(), fwd.tend.numpy()

    def rev(x, n):
        idx = (n[:, None] - 1) - np.arange(x.shape[1])[None, :]
        return np.where(idx >= 0, np.take_along_axis(
            x, np.clip(idx, 0, x.shape[1] - 1), 1), 4).astype(np.int32)

    rq, rt = rev(q, qe), rev(t, te)
    qe, te = qe.astype(np.int32), te.astype(np.int32)
    assert TAC.route(Lq, Lt, 2 * band) == TAC.Route("wide", 5, 2, 3600,
                                                    False, 2)
    ref = JA.banded_sw_batch(*_j(rq, rt, qe, te), band=2 * band)
    _check(sw_wide_registers(*_t(rq, rt, qe, te), 2 * band), ref, "reverse")
    np.testing.assert_array_equal(np.asarray(ref.score), fwd.score.numpy())


def test_sw_routes_take_no_rows():
    """Unforced, no shape takes the row route: K3' and K3'' keep theirs, the
    rest is K3''' (its register slots up to band 2047, then the slots in
    shared memory up to band 29,053, then in the device scratch)."""
    shapes = [(lq, lq + 72, b) for lq in (1, 31, 112, 256, 257, 320, 1024,
                                          1100, 28000, 31000)
              for b in (0, 1, 64, 127, 128, 255, 256, 511, 907, 908, 960,
                        2047, 2048, 29053, 29054, 40000)]
    shapes += [(100, 58000, 64), (257, 200, 5000), (320, 456, 256)]
    kinds = {}
    for Lq, Lt, band in shapes:
        r = TAC.route(Lq, Lt, band)
        assert r.kind != "rows", (Lq, Lt, band)
        kinds.setdefault(r.kind, []).append((Lq, Lt, band))
        clamped = min(band, max(Lq, Lt))
        if Lq <= 256:
            assert r.kind in ("diag", "band"), (Lq, band)
        elif clamped <= 255 and Lq <= 28000:
            assert r.kind == "band", (Lq, band)
        else:
            assert r == TAC.wide_route(Lq, Lt, band), (Lq, band)
    assert set(kinds) == {"diag", "band", "wide"}
    # the refine's shapes keep their routes
    assert TAC.route(112, 184, 64) == TAC.Route("diag", 4, 4, 7040, False)
    assert TAC.route(320, 392, 64) == TAC.Route("band", 3, 4, 14336, False)
    assert TAC.route(320, 392, 128) == TAC.Route("band", 5, 4, 16512, False)
    # K3''' geometry: nw = ceil((band + 1) / 256) warps of 32 K slots
    for band, K, nw in ((255, 8, 1), (256, 5, 2), (300, 5, 2), (511, 8, 2),
                        (512, 6, 3), (960, 8, 4), (2047, 8, 8)):
        r = TAC.wide_route(30000, 30072, band)
        assert (r.K, r.nw) == (K, nw), band
        pairs = 4 if nw == 1 else 1
        assert r.warps == nw * pairs
        assert r.smem == TAC.wide_smem_bytes(K, nw, pairs) == \
            pairs * (2 * (128 + 32 * K * nw) + 2 * nw) * 4
    # the windows do not grow with Lq
    assert TAC.wide_route(31000, 31072, 64) == TAC.wide_route(
        300000, 300072, 64) == TAC.Route("wide", 3, 4, 7200, False, 1)
    assert TAC.wide_route(31000, 31072, 128).smem == 9248
    # past 2048 slots: two rows of band + 3 in shared memory, then scratch
    assert TAC.wide_route(31000, 31072, 2048) == TAC.Route(
        "wide", 0, 16, 2 * 2051 * 4, False, 16)
    assert TAC.wide_route(31000, 31072, 29053).smem == 232448
    assert TAC.wide_route(31000, 31072, 29054) == TAC.Route(
        "wide", 0, 16, 0, True, 16)
    # forced: the slots in the device scratch
    assert TAC.wide_route(320, 456, 256, scratch=True) == TAC.Route(
        "wide", 0, 16, 0, True, 16)
    assert TAC.ROUTE_COUNTER["wide"] == "banded_sw_batch_cuda_wide"
    assert set(TAC.LAUNCHES) == set(TAC.ROUTE_COUNTER.values())


def test_sw_wide_operands_and_cpu_wrapper():
    """kernel_operands: the caller's codes as they are for K3''', its
    scratch rows (N, 2, band + 3) only when forced or past 227 KB; K3 only
    forced, from transposed copies; the wrapper on CPU tensors takes the
    plain version and counts nothing."""
    n = torch.ones(4, dtype=torch.int32)
    q = torch.zeros((4, 320), dtype=torch.int32)
    t = torch.zeros((4, 456), dtype=torch.int32)
    r, qa, ta, *_, band, rows, outs = TAC.kernel_operands(q, t, n, n, 256)
    assert r.kind == "wide" and qa is q and ta is t and rows is None
    r, *_, rows, _ = TAC.kernel_operands(q, t, n, n, 256, kind="wide",
                                         scratch=True)
    assert r.scratch and rows.shape == (4, 2, 259)
    r, qa, ta, *_ = TAC.kernel_operands(q, t, n, n, 256, kind="rows")
    assert r.kind == "rows" and qa.shape == (320, 4) and ta.shape == (456, 4)
    args = _t(*_sw_inputs(5, 12, 320, 456, 256))
    before = dict(TAC.LAUNCHES)
    got = TAC.banded_sw_batch_cuda(*args, band=256)
    ref = TA.banded_sw_batch(*args, band=256)
    for f in SW_FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert TAC.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_wide_kernel_matches_plain(cuda):
    for Lq, Lt, band, force in ((320, 456, 256, {}), (1000, 1000, 960, {}),
                                (2600, 2672, 2500, {}),
                                (320, 456, 256, {"scratch": True}),
                                (4000, 4072, 64, {})):
        args = [x.to(cuda) for x in _t(*_sw_inputs(Lq, 24, Lq, Lt, band))]
        ref = TA.banded_sw_batch(*args, band=band)
        if force:
            r, *ops, outs = TAC.kernel_operands(*args, band=band,
                                                kind="wide", **force)
            TAC.run_kernel(r, *ops, outs)
            got = outs
        else:
            assert TAC.route(Lq, Lt, band).kind == "wide"
            n = TAC.LAUNCHES["banded_sw_batch_cuda_wide"]
            got = tuple(TAC.banded_sw_batch_cuda(*args, band=band))
            assert TAC.LAUNCHES["banded_sw_batch_cuda_wide"] == n + 1
        for f, g in zip(SW_FIELDS, got):
            assert torch.equal(g, getattr(ref, f)), (Lq, band, force, f)
