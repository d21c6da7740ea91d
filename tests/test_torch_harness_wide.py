"""The harness kernels X1 and X2 past their old caps, against the JAX
package, and their redesigned schedules emulated step by step.

X1 (hga_tpu_torch.exp.myers_micro.run_b) at W 25 and 40 equals
hga_tpu.ops.myers.myers_batch, the XLA engine exp/myers_micro.main() holds
`run_b` against; X2 (hga_tpu_torch.exp.sw_variants.sw_pallas_exp) for v1,
v2, v3 and v3g8 above Lq 128 and 256 and past 256 slots equals
hga_tpu.ops.align.banded_sw_batch, the oracle of the reference's check().
The reference's Pallas kernels are not run here past W 24 (interpret mode
compiles for minutes there).

Then csrc/myers_micro.cu's and csrc/sw_variants.cu's orders of work, written
out in plain Python lane by lane (X1: words split across lanes on the skewed
schedule, slabs with the skew's halo, the carries and the mend ORs handed
on by shuffles, the match masks read from a table; X2: the band window or the query as slots, staged windows
of 256 anti-diagonals at the kernel's offsets, G pairs a warp, the packed
route's int16 sign tricks, the slots in memory), against the JAX package;
then the routes, geometry and swept counts the wrappers compute.
"""

import numpy as np
import torch

import jax.numpy as jnp

from hga_tpu.ops.align import banded_sw_batch as jax_banded_sw_batch
from hga_tpu.ops.myers import myers_batch as jax_myers_batch
from hga_tpu_torch.exp import myers_micro as MM
from hga_tpu_torch.exp import sw_variants as SV
from hga_tpu_torch.ops import myers as TM

SW_FIELDS = ("score", "qend", "tend")
INT_MAX = 2**31 - 1
M31 = 0x7fffffff
CHUNK = SV.CHUNK


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _myers_inputs(seed, N, Lq, Lt):
    """Ragged query lengths (0 and word boundaries included) with code 4
    past them, ragged target lengths, codes -1/4/9 in the targets."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(0, N, 2):
        L = min(Lq, Lt - 4)
        t[n, 2:2 + L] = q[n, :L]
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    ql[:5] = [0, 1, 31, Lq - 31, Lq]
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    tl = rng.integers(1, Lt + 1, N).astype(np.int32)
    tl[:2] = Lt
    m = min(N, 16)
    t[:m, :6] = rng.choice([-1, 4, 9], size=(m, 6))
    return q, t, ql, tl


def _sw_inputs(seed, N, Lq, Lt):
    """check()'s kind of pairs: an overlap planted in every other pair,
    ragged lengths; qlen/tlen 0, full lengths, a homopolymer pair (ties),
    codes 4 and -1."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(0, N, 2):
        L = int(rng.integers(Lq // 2, Lq))
        off = int(rng.integers(0, max(1, Lt - L)))
        seg = q[n, :L][:Lt - off]
        t[n, off:off + len(seg)] = seg
    ql = rng.integers(Lq // 2, Lq + 1, N).astype(np.int32)
    tl = rng.integers(Lt // 2, Lt + 1, N).astype(np.int32)
    ql[1], tl[3] = 0, 0
    ql[5], tl[5] = Lq, Lt
    q[7], t[7] = 0, 0
    q[8, ::3], t[8, :Lt // 2] = 4, -1
    return q, t, ql, tl


def _jax_sw(q, t, ql, tl, band):
    r = jax_banded_sw_batch(jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
                            jnp.asarray(tl), band=band)
    return np.stack([np.asarray(getattr(r, f)) for f in SW_FIELDS])


def _jax_myers(q, t, ql, tl):
    r = jax_myers_batch(jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
                        jnp.asarray(tl))
    return np.asarray(r.dist), np.asarray(r.tend)


# ------------------------------------------------------- past the old caps

def test_run_b_past_the_old_word_cap_matches_jax():
    for seed, N, Lq, Lt, W in ((25, 96, 775, 40, 25), (40, 64, 1240, 30, 40)):
        q, t, ql, tl = _myers_inputs(seed, N, Lq, Lt)
        assert TM.n_words(Lq) == W
        qd, td, qld, tld = _t(q, t, ql, tl)
        planes = TM.query_planes(qd, qld, W)
        got = MM.run_b(qld, tld, *planes, td, S=2, BLK=8)
        dist, tend = _jax_myers(q, t, ql, tl)
        np.testing.assert_array_equal(got.dist.numpy(), dist)
        np.testing.assert_array_equal(got.tend.numpy(), tend)
        assert (dist > 0).any() and (dist < ql).any()


def test_sw_variants_past_the_old_caps_match_jax():
    # Lq 160 (past v3's 128 slots), 300 at band 64 (past v1's 256), 300 at
    # band 280 (281 slots), 200 at band 250 (the query layout)
    for seed, N, Lq, Lt, band in ((1, 32, 160, 200, 64), (2, 32, 300, 340, 64),
                                  (3, 24, 300, 320, 280),
                                  (4, 24, 200, 230, 250)):
        q, t, ql, tl = _sw_inputs(seed, N, Lq, Lt)
        ref = _jax_sw(q, t, ql, tl, band)
        assert ref[0].max() > 0
        for v in ("v1", "v2", "v3", "v3g8"):
            got = SV.sw_pallas_exp(*_t(q, t, ql, tl), band=band, variant=v)
            np.testing.assert_array_equal(
                np.stack([getattr(got, f).numpy() for f in SW_FIELDS]), ref,
                err_msg=f"{v} Lq {Lq} band {band}")


# ------------------------------------------------- the schedules, emulated

def _ceil_half(x):
    return (x + 1) // 2 if x >= 0 else -((-x) // 2)


def _take(b, v, d, p):
    if v > b[0] or (v == b[0] and (d < b[1] or (d == b[1] and p < b[2]))):
        return (v, d, p)
    return b


def _store(query, band, b):
    has = b[0] > 0
    qe = 0 if not has else (b[2] + 1 if query else
                            _ceil_half(b[1] - band) + b[2])
    return b[0], qe, (b[1] - qe if has else 0)


def _bounds(query, band, S, live, s, ql, tl):
    """csrc/sw_variants.cu slot_bounds: the cell of slot s on d counts iff
    dlo <= d <= dhi."""
    if query:
        i = s + 1
        dhi = i + min(tl, i + band) if live and s < S and i <= ql else -1
        return i + max(1, i - band), dhi
    dhi = (min(2 * (ql - s) + band, 2 * (tl + s) + 1 - band)
           if live and s <= band else -1)
    return max(band - 2 * s + 1, 2 * s + 2 - band), dhi


def _stage(q, t, band, query, dc, swept, n):
    """The windows of chunk dc at the kernel's offsets, both copies (copy 1
    one code on): (q0, q1, t0, t1), -1 outside the codes."""
    Lq, Lt = q.shape[1], t.shape[1]

    def code(row, u, L):
        return int(row[u]) if 0 <= u < L else -1

    if query:
        tb, ln = dc + CHUNK - 1, CHUNK + swept + 4
        return (None, None, [code(t[n], tb - x, Lt) for x in range(ln)],
                [code(t[n], tb - 1 - x, Lt) for x in range(ln)])
    wb = (CHUNK // 2 + swept + 5) & ~1
    i0c = (dc - band) // 2
    qb, tb = i0c - 1, dc - i0c + CHUNK // 2 - 1
    return ([code(q[n], qb + x, Lq) for x in range(wb)],
            [code(q[n], qb + 1 + x, Lq) for x in range(wb)],
            [code(t[n], tb - x, Lt) for x in range(wb)],
            [code(t[n], tb - 1 - x, Lt) for x in range(wb)])


def _emulate_registers(q, t, qlen, tlen, band, G, K, m=2, mm=-4, gp=-3):
    """swv_kernel<K>: G pairs a warp on 32 // G lanes of K slots each."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, Lq + Lt)
    query, S = SV.window(Lq, Lt, band)
    L = 32 // G
    sw = L * K
    out = np.zeros((3, N), np.int64)
    slots = [(lane, k) for lane in range(32) for k in range(K)]
    for pair0 in range(0, N, G):
        grp = [lane // L for lane in range(32)]
        lip = [lane % L for lane in range(32)]
        live = [grp[x] < G and pair0 + grp[x] < N for x in range(32)]
        lo, hi, qv, dend = {}, {}, {}, 1
        for x in range(32):
            n = pair0 + grp[x]
            ql = min(max(int(qlen[n]), 0), Lq) if live[x] else 0
            tl = min(int(tlen[n]), Lt) if live[x] else 0
            if live[x] and ql >= 1:
                dend = max(dend, ql + min(tl, ql + band))
            for k in range(K):
                s = lip[x] * K + k
                lo[x, k], hi[x, k] = _bounds(query, band, S, live[x], s, ql,
                                             tl)
                qv[x, k] = int(q[n, s]) if live[x] and query and s < Lq \
                    else 0
        X = dict.fromkeys(slots, 0)
        Y, bv, bd = dict(X), dict(X), dict(X)

        def step(d, mode, codes, Xa, Ya):
            nb = {}
            for x, k in slots:
                if mode != 1:
                    nb[x, k] = Ya[x, k - 1] if k else (
                        0 if lip[x] == 0 else Ya[x - 1, K - 1])
                else:
                    nb[x, k] = Ya[x, k + 1] if k < K - 1 else (
                        0 if lip[x] == L - 1 or x == 31 else Ya[x + 1, 0])
            for x, k in slots:
                qc, tc = codes(x, k)
                v = max(Xa[x, k] + (m if qc == tc else mm),
                        max(Ya[x, k], nb[x, k]) + gp, 0)
                inside = lo[x, k] <= d <= hi[x, k]
                if mode == 1:
                    inside = inside and k != band - lip[x] * K
                v = v if inside else 0
                if v > bv[x, k]:
                    bv[x, k], bd[x, k] = v, d
                if mode == 2:
                    Xa[x, k], Ya[x, k] = nb[x, k], v
                else:
                    Xa[x, k] = v

        dc = 2 if query else 2 - (band & 1)
        while dc <= dend:
            wins = {g: _stage(q, t, band, query, dc, sw, pair0 + g)
                    for g in range(G) if pair0 + g < N}
            win = [wins.get(grp[x] if grp[x] < G else 0) for x in range(32)]
            dstop = min(dc + CHUNK - 2, dend)
            if query:
                for d in range(dc, dstop + 1, 2):
                    for dd in (d, d + 1):
                        off = CHUNK + 1 - (dd - dc)
                        step(dd, 2, lambda x, k: (qv[x, k], win[x][2][
                            off + lip[x] * K + k] if win[x] else 9), X, Y)
            else:
                for d in range(dc, dstop + 1, 2):
                    qo, to = (d - dc) // 2, CHUNK // 2 - (d - dc) // 2
                    step(d, 0, lambda x, k: (
                        win[x][0][qo + lip[x] * K + k],
                        win[x][2][to + lip[x] * K + k]) if win[x] else (0, 9),
                        X, Y)
                    step(d + 1, 1, lambda x, k: (
                        win[x][0][qo + 1 + lip[x] * K + k],
                        win[x][2][to + lip[x] * K + k]) if win[x] else (0, 9),
                        Y, X)
            dc += CHUNK
        for g in range(min(G, N - pair0)):
            b = (-1, INT_MAX, INT_MAX)
            for x, k in slots:
                if grp[x] == g:
                    b = _take(b, bv[x, k], bd[x, k], lip[x] * K + k)
            out[:, pair0 + g] = _store(query, band, b)
    return out


def _p16(lo, hi):
    return (lo & 0xffff) | ((hi & 0xffff) << 16)


def _s16(x):
    x &= 0xffff
    return x - 0x10000 if x >= 0x8000 else x


def _spread(x):           # PRMT 0xBB99: each half's bit 15 over the half
    return (0xffff if x & 0x8000 else 0) | (
        0xffff0000 if x & 0x80000000 else 0)


def _addmax(a, b, c, relu):   # __viaddmax_s16x2(_relu)
    r = [max(_s16(_s16(a >> h) + _s16(b >> h)), _s16(c >> h),
             *((0,) if relu else ())) for h in (0, 16)]
    return _p16(*r)


def _max_relu(a, b):          # __vimax_s16x2_relu
    return _p16(*[max(_s16(a >> h), _s16(b >> h), 0) for h in (0, 16)])


def _emulate_packed(q, t, qlen, tlen, band, H, m=2, mm=-4, gp=-3):
    """swv_packed_kernel<H>: two slots a 32-bit word, the codes read as
    aligned words from the two copies, the 32-bit sign tricks."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, Lq + Lt)
    query, S = SV.window(Lq, Lt, band)
    U = 0xffffffff
    m2, mm2, gp2 = _p16(m, m), _p16(mm, mm), _p16(gp, gp)
    words = [(x, w) for x in range(32) for w in range(H)]
    out = np.zeros((3, N), np.int64)

    def word(arr, i):
        return _p16(arr[2 * i], arr[2 * i + 1])

    for n in range(N):
        ql, tl = min(max(int(qlen[n]), 0), Lq), min(int(tlen[n]), Lt)
        q2, nlo, nhi, ebm = {}, {}, {}, {}
        for x, w in words:
            s0 = x * 2 * H + 2 * w
            b = [_bounds(query, band, S, True, s0 + h, ql, tl) for h in (0, 1)]
            q2[x, w] = _p16(*[int(q[n, s0 + h]) if query and s0 + h < Lq
                              else 0 for h in (0, 1)])
            nlo[x, w] = _p16(0x8000 - b[0][0], 0x8000 - b[1][0])
            nhi[x, w] = _p16(b[0][1] + 0x8000, b[1][1] + 0x8000)
            sb = band - s0
            ebm[x, w] = U if query or not 0 <= sb <= 1 else (
                0xffff0000 if sb == 0 else 0x0000ffff)
        X = dict.fromkeys(words, 0)
        Y, bv, bd = dict(X), dict(X), dict(X)

        def step(d, mode, Q, T, Xa, Ya):
            d2 = d * 0x10001
            nb = {}
            for x, w in words:
                if mode != 1:
                    prev = Ya[x, w - 1] if w else (0 if x == 0 else
                                                   Ya[x - 1, H - 1])
                    nb[x, w] = (prev >> 16) | ((Ya[x, w] & 0xffff) << 16)
                else:
                    nxt = Ya[x, w + 1] if w < H - 1 else (
                        0 if x == 31 else Ya[x + 1, 0])
                    nb[x, w] = (Ya[x, w] >> 16) | ((nxt & 0xffff) << 16)
            for x, w in words:
                c = (q2[x, w] if mode == 2 else Q(x, w)) ^ T(x, w)
                ne = _spread(c | (((c | 0x80008000) - 0x10001) & U))
                sub = (ne & mm2) | (~ne & m2 & U)
                xs = _addmax(Xa[x, w], sub, 0x80008000, False)
                v = _addmax(_max_relu(Ya[x, w], nb[x, w]), gp2, xs, True)
                a, b = d2 + nlo[x, w], nhi[x, w] - d2
                assert 0 <= a <= U and b >= 0       # no half carries out
                inside = _spread(a & b & 0x80008000)
                v &= inside & ebm[x, w] if mode == 1 else inside
                keep = _spread((bv[x, w] + 0x80008000 - v) & U)
                bd[x, w] = (keep & bd[x, w]) | (~keep & d2 & U)
                bv[x, w] = _max_relu(bv[x, w], v)
                if mode == 2:
                    Xa[x, w], Ya[x, w] = nb[x, w], v
                else:
                    Xa[x, w] = v

        dend = ql + min(tl, ql + band) if ql >= 1 else 1
        dc = 2 if query else 2 - (band & 1)
        while dc <= dend:
            q0, q1, t0, t1 = _stage(q, t, band, query, dc, 64 * H, n)
            if query:
                for d in range(dc, min(dc + CHUNK - 2, dend) + 1, 2):
                    xo = CHUNK + 1 - (d - dc)
                    for dd, arr in ((d, t1), (d + 1, t0)):
                        step(dd, 2, None, lambda x, w: word(
                            arr, (xo - 1) // 2 + x * H + w), X, Y)
            else:
                for d in range(dc, min(dc + CHUNK - 4, dend) + 1, 4):
                    qo, to = (d - dc) // 2, CHUNK // 2 - (d - dc) // 2
                    for dd, mode, qa, qi, ta, ti, A, B in (
                            (d, 0, q0, 0, t0, 0, X, Y),
                            (d + 1, 1, q1, 0, t0, 0, Y, X),
                            (d + 2, 0, q1, 0, t1, -1, X, Y),
                            (d + 3, 1, q0, 1, t1, -1, Y, X)):
                        step(dd, mode,
                             lambda x, w: word(qa, qo // 2 + qi + x * H + w),
                             lambda x, w: word(ta, to // 2 + ti + x * H + w),
                             A, B)
            dc += CHUNK
        b = (-1, INT_MAX, INT_MAX)
        for x, w in words:
            for h in (0, 1):
                b = _take(b, _s16(bv[x, w] >> 16 * h),
                          _s16(bd[x, w] >> 16 * h), x * 2 * H + 2 * w + h)
        out[:, n] = _store(query, band, b)
    return out


def _emulate_memory(q, t, qlen, tlen, band, G, m=2, mm=-4, gp=-3):
    """swv_mem_kernel: G pairs a warp, three rows of S + 2 a pair."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, Lq + Lt)
    query, S = SV.window(Lq, Lt, band)
    out = np.zeros((3, N), np.int64)
    for pair0 in range(0, N, G):
        pairs = range(pair0, min(pair0 + G, N))
        rows = {n: [[0] * (S + 2) for _ in range(3)] for n in pairs}
        best = {n: ([0] * S, [0] * S) for n in pairs}
        lens = {n: (min(max(int(qlen[n]), 0), Lq), min(int(tlen[n]), Lt))
                for n in pairs}
        dend = max([1] + [ql + min(tl, ql + band) for ql, tl in lens.values()
                          if ql >= 1])
        rot = 0
        for d in range(2, dend + 1):
            m1 = 0 if query else (d - band) & 1
            m2 = 0 if query else 1 - m1
            i0 = 1 if query else _ceil_half(d - band)
            rx, ry = rot, (rot + 1) % 3
            rz = (ry + 1) % 3
            for n in pairs:
                ql, tl = lens[n]
                Xr, Yr = rows[n][rx], rows[n][ry]
                for s in range(S):
                    i, v = i0 + s, 0
                    j = d - i
                    if 1 <= i <= ql and 1 <= j <= tl and abs(j - i) <= band:
                        v = max(Xr[s + m1 + m2] + (m if q[n, i - 1] ==
                                                   t[n, j - 1] else mm),
                                max(Yr[s + m1], Yr[s + 1 + m1]) + gp, 0)
                    rows[n][rz][s + 1] = v
                    if v > best[n][0][s]:
                        best[n][0][s], best[n][1][s] = v, d
            rot = ry
        for n in pairs:
            b = (-1, INT_MAX, INT_MAX)
            for s in range(S):
                b = _take(b, best[n][0][s], best[n][1][s], s)
            out[:, n] = _store(query, band, b)
    return out


def _emulate_slabs(q0, q1, vq, mend, t, qlen, tlen, S, BLK):
    """myers_slab_kernel: A lanes a pair, P pairs a warp, warps running
    their groups in turn, slab b = columns b BLK - (A - 1) .. (b + 1) BLK -
    1; lane w on column s - w, taking from lane w - 1 (one shuffle each)
    its carry out of bit 31, its last word's Ph << 1 and Mh << 1 (funnel-
    shifted in: bit 31 is the carry out of bit 30) and the ORs of Ph & mend
    and Mh & mend below it; lane 0 of a group keeps none of them; the match
    mask of a code is read from a per-lane table (codes past 3: none);
    every lane runs the score, a step's state commits only on its own
    column."""
    U = 0xffffffff
    N, W = q0.shape
    Lt = t.shape[1]
    g = MM.slab_geometry(N, W, S, BLK)
    wl, A, P = g.wl, g.lanes, g.pairs
    pairs = MM.pairs_per_block(S)
    steps = Lt + A - 1
    dist, tend = np.full(N, -7), np.full(N, -7)
    groups = -(-pairs // P)

    def fsl(lo, hi):          # __funnelshift_l(lo, hi, 1)
        return ((hi << 1) | (lo >> 31)) & U

    for blk in range(g.blocks):
        for gi in range(groups):          # warp gi % warps, in turn
            pb = blk * pairs + gi * P
            npairs = min(P, pairs - gi * P, N - pb)
            lanes = [(x // A, x % A) for x in range(P * A) if x // A < npairs]
            peq, mendw, pv, mv = {}, {}, {}, {}
            for pp, w in lanes:
                n = pb + pp
                word = [[int(pl[n, w * wl + k]) & U if w * wl + k < W else 0
                         for k in range(wl)] for pl in (q0, q1, vq, mend)]
                peq[pp, w] = [[word[2][k] & ~((word[0][k] ^ -(c & 1)) | (
                    word[1][k] ^ -((c >> 1) & 1))) & U for k in range(wl)]
                    for c in range(4)] + [[0] * wl]
                mendw[pp, w] = word[3]
                pv[pp, w], mv[pp, w] = [M31] * wl, [0] * wl
            score = {x: int(qlen[pb + x[0]]) for x in lanes}
            best, bj = dict(score), dict.fromkeys(lanes, 0)
            sent = {x: (0, 0, 0, 0, 0) for x in lanes}
            for s in range(steps):
                b, r = divmod(s, BLK)
                if r == 0:        # the slab the kernel has waited on
                    c0 = b * BLK - (A - 1)
                    slab = {pp: [int(t[pb + pp, c0 + x]) if 0 <= c0 + x < Lt
                                 else None for x in range(BLK + A - 1)]
                            for pp in range(npairs)}
                got = {(pp, w): sent[pp, w - 1] if w else (1, U, U, U, U)
                       for pp, w in lanes}    # lane 0: a neighbour's junk
                for pp, w in lanes:
                    jj = s - w
                    act = 0 <= jj < Lt
                    keep = U if w else 0
                    ci, psh, msh, pbo, mbo = got[pp, w]
                    cin, pbo, mbo = ci & keep, pbo & keep, mbo & keep
                    tc = slab[pp][r + A - 1 - w] if act else None
                    cidx = 4 if tc is None or not 0 <= tc < 4 else tc
                    npv, nmv = list(pv[pp, w]), list(mv[pp, w])
                    for k in range(wl):
                        eq = peq[pp, w][cidx][k]
                        p, m = pv[pp, w][k], mv[pp, w][k]
                        xv = eq | m
                        sw = ((eq & p) + p + cin) & U
                        cin = sw >> 31
                        xh = ((sw & M31) ^ p) | eq
                        ph = (m | ~(xh | p)) & U
                        mh = p & xh
                        pbo |= ph & mendw[pp, w][k]
                        mbo |= mh & mendw[pp, w][k]
                        msk = (M31 & ~1 if w == 0 else M31) if k == 0 else M31
                        phs, mhs = fsl(psh, ph) & msk, fsl(msh, mh) & msk
                        psh, msh = (ph << 1) & U, (mh << 1) & U
                        npv[k] = (mhs | ~(xv | phs)) & M31
                        nmv[k] = phs & xv
                    sent[pp, w] = (cin, psh, msh, pbo, mbo)
                    ns = score[pp, w] + int(pbo != 0) - int(mbo != 0)
                    if act:
                        pv[pp, w], mv[pp, w], score[pp, w] = npv, nmv, ns
                        if ns < best[pp, w] and jj < int(tlen[pb + pp]):
                            best[pp, w], bj[pp, w] = ns, jj + 1
            for pp, w in lanes:
                if w == A - 1:
                    n = pb + pp
                    zero = int(qlen[n]) == 0
                    dist[n], tend[n] = (0, 0) if zero else (best[pp, w],
                                                            bj[pp, w])
    return dist, tend


def test_kernel_schedules_match_jax():
    # X2: the band window (chunk refills at Lt 600 and Lq 300), the query
    # layout (band >= Lq - 1), band 0; G 1, 3 and 4 on the register route
    for seed, N, Lq, Lt, band in ((5, 10, 40, 60, 8), (6, 10, 40, 60, 200),
                                  (7, 9, 70, 40, 20), (8, 9, 30, 600, 5),
                                  (9, 9, 300, 330, 31), (10, 9, 20, 20, 0)):
        q, t, ql, tl = _sw_inputs(seed, N, Lq, Lt)
        ref = _jax_sw(q, t, ql, tl, band)
        _, S = SV.window(Lq, Lt, band)
        for G in (1, 3, 4):
            K = next(k for k in SV.REG_KS if (32 // G) * k >= S)
            np.testing.assert_array_equal(
                _emulate_registers(q, t, ql, tl, band, G, K), ref,
                err_msg=f"registers G {G} K {K} Lq {Lq} band {band}")
        H = next(h for h in SV.PACKED_HS if 64 * h >= S)
        np.testing.assert_array_equal(_emulate_packed(q, t, ql, tl, band, H),
                                      ref, err_msg=f"packed Lq {Lq}")
        np.testing.assert_array_equal(_emulate_memory(q, t, ql, tl, band, 3),
                                      ref, err_msg=f"memory Lq {Lq}")
    # X1: W 1 (a lane a pair), W 5 (6 pairs a warp), W 40 (two words a
    # lane; 64 groups a block on 32 warps, two each), W 140 (five words a
    # lane)
    for seed, N, Lq, Lt, S, BLK in ((1, 40, 31, 20, 1, 8),
                                    (2, 50, 150, 23, 1, 8),
                                    (3, 70, 1240, 15, 4, 5),
                                    (4, 9, 4340, 10, 1, 4)):
        q, t, ql, tl = _myers_inputs(seed, N, Lq, Lt)
        planes = [p.numpy() for p in TM.query_planes(*_t(q, ql),
                                                    TM.n_words(Lq))]
        dist, tend = _emulate_slabs(*planes, t, ql, tl, S, BLK)
        ref = _jax_myers(q, t, ql, tl)
        np.testing.assert_array_equal(dist, ref[0], err_msg=f"Lq {Lq}")
        np.testing.assert_array_equal(tend, ref[1], err_msg=f"Lq {Lq}")


# ------------------------------------------------ routes, geometry, counts

def test_routes_geometry_and_swept_counts():
    P = SV.plan
    # the timing shape: v1 K 3 (96 slots), v3 8 lanes of K 9, v3g2 16 of K
    # 5, v2 two words a lane (128 slots), ablations at K 3
    assert P("v1", 4096, 128, 256, 64)[:6] == ("registers", 3, 1, 32, 65, 96)
    assert P("v3", 4096, 128, 256, 64)[:6] == ("registers", 9, 4, 8, 65, 72)
    assert P("v3g2", 4096, 128, 256, 64)[:6] == ("registers", 5, 2, 16, 65,
                                                   80)
    assert P("v2", 4096, 128, 256, 64)[:6] == ("packed", 2, 1, 32, 65, 128)
    assert P("v1nomasknobest", 4096, 128, 256, 64).K == SV.ABLATION_K
    # the timing shapes past the old caps: Lq 1,000 at band 64, Lq 320 at
    # band 300 (301 slots), the query layout at band >= Lq - 1
    assert P("v1", 4096, 1000, 1064, 64)[:5] == ("registers", 3, 1, 32, 65)
    assert P("v1", 4096, 320, 392, 300)[:6] == ("registers", 10, 1, 32, 301,
                                                  320)
    assert P("v2", 4096, 320, 392, 300)[:2] == ("packed", 6)
    assert P("v1", 64, 40, 60, 200).query and P("v1", 64, 40, 60, 200).S == 40
    assert not P("v1", 64, 40, 60, 38).query
    # past the register slots: the slots in memory, in shared memory, then
    # in a device scratch past 227 KB a block
    m = P("v3", 4096, 320, 392, 300)
    assert m.route == "memory" and m.scratch == 0 and \
        m.smem == 4 * 4 * SV.mem_words(301) * 4
    assert P("v3g64", 4096, 128, 256, 64).route == "memory"
    big = P("v1", 100, 20000, 20000, 5000)
    assert big.route == "memory" and big.smem == 0 and \
        big.scratch == 25 * 4 * SV.mem_words(5001)
    with np.testing.assert_raises_regex(ValueError, "built at"):
        P("v1nots", 64, 1000, 1000, 200)
    # swept slot-steps: v1 at the timing shape sweeps 96 slots over the 320
    # anti-diagonals 2 .. 321 (two steps a body) of every pair
    ql = torch.full((64,), 128, dtype=torch.int32)
    tl = torch.full((64,), 256, dtype=torch.int32)
    assert SV.swept_slot_steps("v1", ql, tl, 128, 256, 64) == 64 * 96 * 320
    assert SV.swept_slot_steps("v3", ql, tl, 128, 256, 64) == 16 * 288 * 320
    # X1: groups of A = ceil(W / ceil(W / 32)) lanes, P = 32 // A pairs a
    # warp, min(ceil(16 S / P), 32) warps a block, the row pitch A mod 32
    G = MM.slab_geometry
    assert G(4096, 5, 8, 32)[:5] == (1, 5, 6, 22, 37)
    assert G(4096, 1, 8, 32)[:5] == (1, 1, 32, 4, 33)
    assert G(4096, 34, 8, 32)[:5] == (2, 17, 1, 32, 49)
    assert G(4096, 100, 8, 32)[:4] == (4, 25, 1, 32) and \
        G(4096, 100, 8, 32).words == 0
    g = G(4096, 300, 2, 8)
    assert (g.wl, g.lanes, g.words) == (10, 30, 128 * 32 * 6 * 10 * 32)
    for W in (1, 5, 13, 25, 34, 100, 300):
        g = G(1000, W, 2, 32)
        assert g.row >= 32 + g.lanes - 1 and g.row % 32 == g.lanes % 32
        assert g.lanes * g.pairs <= 32 and g.lanes * g.wl >= W
