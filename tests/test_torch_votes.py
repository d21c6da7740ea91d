"""K2' (csrc/myers_votes.cu), one correction batch in one launch, on the
CPU: its plain version (ops/pileup.myers_votes, reached through the wrapper
myers_votes_cuda and through models/correction._votes_into) held exactly
against the JAX package's ``votes_into`` (hga_tpu.models.correction.
_consensus_step_fn), weighted and unweighted, at min_identity 0.9 where
only float32 gate arithmetic agrees, on edge rows and with a step bound
that cuts the walk; the kernel's own order of work emulated in plain
PyTorch and held against JAX too; the route geometry; and, marked ``cuda``,
the kernel against its plain version on the card.

The emulation follows the kernel, which the plain version does not: the DP
runs word w of a pair on column s - w at step s (K1''s split layout) and
stores each column's (Pv, Mv) words into the pair's plane row; the walk is
one scalar walk per pair whose prefix popcounts are taken per word (one
lane each) and summed by a butterfly over the pair's G lanes; votes the
reference sends to the sink are skipped, and a walk stops at column 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.models import correction as JCR
from hga_tpu.ops import myers as JM
from hga_tpu.ops import pileup as JPU
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.models import correction as TCR
from hga_tpu_torch.ops import myers as TM
from hga_tpu_torch.ops import myers_cuda as TMC
from hga_tpu_torch.ops import pileup as TPU

PAYLOAD = 31
M31 = (1 << 31) - 1
SLOTS = 3


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
    return tuple(None if x is None else torch.from_numpy(
        np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(None if x is None else jnp.asarray(x) for x in xs)


def steps_for(Lq, min_identity):
    """The walk's step bound the correction stage passes (both packages)."""
    return Lq + int((1.0 - min_identity) * Lq) + 2


# ------------------------------------------------------------------ inputs

def batch(seed, P=96, Lq=62, band=24, nb=4, lpad=256):
    """A correction batch: short reads planted with a few edits (subs,
    deletions, insertions) in windows of Lq + band + 8 columns, every 8th
    row random (the gate drops it); qlen 0, 1, 31 and 62 (those that fit);
    target codes -1 and 9 inside planted windows; code 4 past qlen; rows
    with tlen 0 or ragged; windows that start before the backbone (off < 0)
    or run past its end (lb); weights 1..3, 0 past qlen (as _prep makes
    them).  Returns (q, t, qlen, tlen, bb, off, lb, qw, nb, lpad)."""
    rng = np.random.default_rng(seed)
    Lt = Lq + band + 8
    q = rng.integers(0, 4, (P, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (P, Lt)).astype(np.int32)
    ql = rng.integers(Lq // 2, Lq + 1, P).astype(np.int32)
    edge = [x for x in (0, 1, 31, 62) if x <= Lq]
    ql[:len(edge)] = edge
    for n in range(P):
        if n % 8 == 7:
            continue
        seg = list(q[n, :ql[n]])
        for _ in range(int(rng.integers(0, max(1, ql[n] // 12) + 1))):
            if not seg:
                break
            p = int(rng.integers(0, len(seg)))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                seg[p] = (seg[p] + 1 + int(rng.integers(0, 3))) % 4
            elif kind == 1:
                del seg[p]
            else:
                seg.insert(p, int(rng.integers(0, 4)))
        lead = int(rng.integers(0, band // 2 + 8))
        seg = np.array(seg[:Lt - lead], np.int32)
        t[n, lead:lead + seg.size] = seg
    t[4:8, 20:24] = -1
    t[8:12, 10:30:3] = 9
    pos = np.arange(Lq)[None, :]
    q[pos >= ql[:, None]] = 4
    tl = np.full(P, Lt, np.int32)
    tl[12:16] = rng.integers(Lt // 2, Lt, 4)
    tl[-2:], ql[-2:] = 0, 0                       # padding rows
    bb = rng.integers(0, nb, P).astype(np.int32)
    off = rng.integers(-12, lpad - Lt + 12, P).astype(np.int32)
    lb = rng.integers(lpad - 40, lpad + 1, P).astype(np.int32)
    qw = rng.integers(1, 4, (P, Lq)).astype(np.int32)
    qw[pos >= ql[:, None]] = 0
    return q, t, ql, tl, bb, off, lb, qw, nb, lpad


def tenth_batch(seed, P=64, Lq=62, band=24):
    """Rows whose qlen is a multiple of 10 with exactly qlen / 10 spaced
    substitutions: at min_identity 0.9 the float32 budget is qlen / 10 and
    keeps them, float64's qlen / 10 - 1 drops them."""
    q, t, ql, tl, bb, off, lb, qw, nb, lpad = batch(seed, P, Lq, band)
    rng = np.random.default_rng(seed + 1)
    Lt = t.shape[1]
    for n in range(P):
        L = 10 * int(rng.integers(1, Lq // 10 + 1))
        ql[n] = L
        q[n, L:] = 4
        seg = q[n, :L].copy()
        seg[5::10] = (seg[5::10] + 1) % 4
        lead = int(rng.integers(0, Lt - L + 1))
        t[n] = rng.integers(0, 4, Lt)
        t[n, lead:lead + L] = seg
    tl[:] = Lt
    qw[np.arange(Lq)[None, :] >= ql[:, None]] = 0
    return q, t, ql, tl, bb, off, lb, qw, nb, lpad


def sizes(nb, lpad):
    size_v = nb * lpad * TPU.N_SYM
    return size_v, size_v + nb * lpad * SLOTS * 4


def jax_votes(b, min_identity, weighted):
    """The reference: votes_into of _consensus_step_fn, one batch."""
    q, t, ql, tl, bb, off, lb, qw, nb, lpad = b
    _, size_all = sizes(nb, lpad)
    step = JCR._consensus_step_fn(JCfg(min_identity=min_identity), 0,
                                  t.shape[1], nb, lpad, SLOTS, mesh=None)
    out = step(jnp.zeros((size_all,), jnp.int32),
               *_j(q, t, ql, tl, bb, off, lb, qw if weighted else None))
    return np.asarray(out)


def jax_votes_cut(b, min_identity, weighted, max_steps):
    """The reference's pieces with another step bound: the planes DP, the
    float32 gate, accumulate_backbone_votes_myers."""
    q, t, ql, tl, bb, off, lb, qw, nb, lpad = b
    size_v, size_all = sizes(nb, lpad)
    res, pv, mv = JM.myers_batch_planes(*_j(q, t, ql, tl))
    max_ed = (np.float32(1.0 - min_identity) * ql.astype(np.float32)).astype(
        np.int32)
    dist, tend = np.asarray(res.dist), np.asarray(res.tend)
    qend = np.where((dist <= max_ed) & (ql > 0) & (tend > 0), ql, 0)
    out = JPU.accumulate_backbone_votes_myers(
        jnp.zeros((size_all,), jnp.int32), pv, mv, res.dist,
        jnp.asarray(qend.astype(np.int32)), res.tend,
        *_j(q, t, bb, off, lb, qw if weighted else None), size_v=size_v,
        lpad=lpad, ins_slots=SLOTS, max_steps=max_steps)
    return np.asarray(out), dist, tend


def port_votes(b, min_identity, weighted, max_steps):
    """The port's plain version through K2''s wrapper (CPU tensors)."""
    q, t, ql, tl, bb, off, lb, qw, nb, lpad = b
    size_v, size_all = sizes(nb, lpad)
    merged = torch.zeros(size_all + 1, dtype=torch.int32)
    n = dict(TMC.LAUNCHES)
    res, out = TMC.myers_votes_cuda(
        merged, *_t(q, t, ql, tl, bb, off, lb, qw if weighted else None),
        min_identity=min_identity, size_v=size_v, lpad=lpad,
        ins_slots=SLOTS, max_steps=max_steps)
    assert out is merged and TMC.LAUNCHES == n     # no kernel on the CPU
    return merged[:size_all].numpy(), res.dist.numpy(), res.tend.numpy()


# ------------------------------------------------------------------ the port

@pytest.mark.parametrize("weighted", [False, True])
def test_votes_match_jax(weighted):
    b = batch(21 + weighted)
    mi = 0.75
    ref = jax_votes(b, mi, weighted)
    got, dist, tend = port_votes(b, mi, weighted, steps_for(b[0].shape[1], mi))
    assert int(ref.sum()) > 2000
    np.testing.assert_array_equal(got, ref)
    jres = JM.myers_batch(*_j(*b[:4]))
    np.testing.assert_array_equal(dist, np.asarray(jres.dist))
    np.testing.assert_array_equal(tend, np.asarray(jres.tend))
    # and through the correction stage's batch step
    q, t, ql, tl, bb, off, lb, qw, nb, lpad = b
    size_v, size_all = sizes(nb, lpad)
    merged = torch.zeros(size_all + 1, dtype=torch.int32)
    out = TCR._votes_into(merged, TCfg(min_identity=mi), size_v, lpad,
                          *_t(q, t, ql, tl, bb, off, lb,
                              qw if weighted else None))
    np.testing.assert_array_equal(out[:size_all].numpy(), ref)


@pytest.mark.parametrize("weighted", [False, True])
def test_float32_gate_at_identity_09(weighted, monkeypatch):
    b = tenth_batch(31 + weighted)
    q, t, ql = b[:3]
    mi = 0.9
    ref = jax_votes(b, mi, weighted)
    steps = steps_for(q.shape[1], mi)
    got, dist, _ = port_votes(b, mi, weighted, steps)
    np.testing.assert_array_equal(got, ref)
    # rows at the budget's edge, which only float32 arithmetic keeps
    edge = dist == ql // 10
    assert int(edge.sum()) >= 16
    monkeypatch.setattr(TPU, "gate_max_ed", lambda qlen, m: (
        (1.0 - m) * qlen.to(torch.float64)).to(torch.int32))
    f64, _, _ = port_votes(b, mi, weighted, steps)
    assert not np.array_equal(f64, ref)


def test_edge_rows_and_a_cut_walk():
    b = batch(41, P=128)
    q, ql, tl = b[0], b[2], b[3]
    mi = 0.75
    for weighted, cut in ((False, q.shape[1] // 2), (True, 9)):
        ref, dist, tend = jax_votes_cut(b, mi, weighted, cut)
        got, gdist, gtend = port_votes(b, mi, weighted, cut)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(gdist, dist)
        np.testing.assert_array_equal(gtend, tend)
        full, _, _ = jax_votes_cut(b, mi, weighted, steps_for(q.shape[1], mi))
        assert int(full.sum()) > int(ref.sum()) > 0     # the bound cut walks
    # qlen 0 and tlen 0 rows: no alignment; qlen 1 aligns one base
    assert list(dist[:2]) == [0, 0] and tend[0] == 0 and tend[1] >= 1
    assert (tend[-2:] == 0).all() and (tl[-2:] == 0).all()
    assert list(ql[:4]) == [0, 1, 31, 62]


def test_wrapper_rejects_bad_operands():
    q, t, ql, tl, bb, off, lb, qw, nb, lpad = batch(5, P=16)
    size_v, size_all = sizes(nb, lpad)
    args = list(_t(q, t, ql, tl, bb, off, lb, qw))
    merged = torch.zeros(size_all + 1, dtype=torch.int32)
    kw = dict(min_identity=0.75, size_v=size_v, lpad=lpad, ins_slots=SLOTS)
    bad = [(0, args[0].long()), (4, args[4][:8]), (7, args[7][:, :10]),
           (5, args[5].repeat(2)[::2])]
    for k, x in bad:
        a = list(args)
        a[k] = x
        with pytest.raises(ValueError):
            TMC.myers_votes_cuda(merged, *a, **kw)
    with pytest.raises(ValueError):
        TMC.myers_votes_cuda(merged.long(), *args, **kw)
    with pytest.raises(ValueError):
        TMC.myers_votes_cuda(merged[:size_v - 1], *args, **kw)


@pytest.mark.parametrize("Lq", [800, 1024])     # W 26 and W 34
def test_votes_match_jax_past_24_words(Lq):
    """Correction batches of short reads padded to 800 and 1024 (W 26 and
    W 34: K2' on the card, one and two words a lane): the wrapper's plain
    version == the reference's votes_into."""
    b = batch(50 + Lq % 7, P=16, Lq=Lq, band=64, lpad=1280)
    mi = 0.75
    ref = jax_votes(b, mi, True)
    got, dist, _ = port_votes(b, mi, True, steps_for(Lq, mi))
    assert int(ref.sum()) > 5000
    np.testing.assert_array_equal(got, ref)
    assert (dist[:10] > 0).any()


def test_correct_long_reads_at_short_pad_800():
    """One correct_long_reads batch with 780-base short reads padded to 800
    (W 26): the corrected long reads equal the JAX package's."""
    from hga_tpu.io.encode import pack_reads as jpack
    from hga_tpu_torch.io.encode import pack_reads as tpack
    from hga_tpu_torch.utils import sim

    kw = dict(k=15, w=5, band=24, max_seed_freq=64, min_shared_minimizers=2,
              batch_reads=128, min_overlap_score=30, min_pileup_depth=2,
              corr_batch_pairs=512, min_identity=0.75)
    g = sim.random_genome(4000, seed=91)
    ss, sn = sim.simulate_short_reads(g, coverage=10, read_len=780,
                                      error_rate=0.005, seed=92)
    ls, ln = sim.simulate_long_reads(g, coverage=3, mean_len=2000,
                                     error_rate=0.06, seed=93)
    pad_l = ((max(len(s) for s in ls) + 31) // 32) * 32
    reads = {tag: (pack(ss, names=sn, pad_len=800),
                   pack(ls, names=ln, category=[1] * len(ls), pad_len=pad_l))
             for tag, pack in (("j", jpack), ("t", tpack))}
    ref = JCR.correct_long_reads(*reads["j"], JCfg(**kw))
    got = TCR.correct_long_reads(*reads["t"], TCfg(**kw), device="cpu")
    assert TCR.LAST_TIMINGS["n_batches"] == 1
    assert TCR.LAST_TIMINGS["n_pairs"] > 100
    assert got.names == ref.names and got.pad_len == ref.pad_len
    for f in ("packed", "bad", "length", "category"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert (got.packed != reads["t"][1].packed).any()   # reads corrected


# ------------------------------------------------------------------ K2''s work

def word_planes(q, qlen, w):
    """The kernel's plane rule for query word w of every pair (K1''s rule,
    ops/myers.query_planes bit for bit).  int64 (N,) each."""
    N, Lq = q.shape
    ql = qlen.long()
    b0 = torch.zeros(N, dtype=torch.int64)
    b1, bv = b0.clone(), b0.clone()
    for b in range(PAYLOAD):
        pos = w * PAYLOAD + b
        code = q[:, pos].long() if pos < Lq else torch.full((N,), 4)
        ok = (pos < ql) & (code < 4)
        b0 |= torch.where(ok, (code & 1) << b, 0)
        b1 |= torch.where(ok, ((code >> 1) & 1) << b, 0)
        bv |= torch.where(ok, 1 << b, 0)
    e = torch.clamp(ql - 1, min=0)
    me = torch.where((ql > 0) & (e // PAYLOAD == w), 1 << (e % PAYLOAD), 0)
    return b0, b1, bv, me


def dp_schedule(q, t, qlen, tlen):
    """The DP as K2' runs it: lane w of a pair holds word w and runs column
    j = s - w at step s with the three carries lane w - 1 left at step
    s - 1, from the staged target codes (outside 0..3 as 4), storing
    (Pv, Mv) of each (column, word) into the pair's plane row.  Returns
    dist, tend and the rows (N, Lt, W, 2)."""
    N, Lq = q.shape
    Lt = t.shape[1]
    W = TM.n_words(Lq)
    planes = [word_planes(q, qlen, w) for w in range(W)]
    pv = [torch.full((N,), M31, dtype=torch.int64) for _ in range(W)]
    mv = [torch.zeros(N, dtype=torch.int64) for _ in range(W)]
    ql, tl = qlen.long(), tlen.long()
    tt = t.long()
    staged = torch.where((tt >= 0) & (tt < 4), tt, 4)
    out = [torch.zeros(N, dtype=torch.int64) for _ in range(W)]
    score = [ql.clone() for _ in range(W)]
    best = [ql.clone() for _ in range(W)]
    bj = [torch.zeros(N, dtype=torch.int64) for _ in range(W)]
    rows = torch.zeros((N, Lt, W, 2), dtype=torch.int64)
    for s in range(Lt + W - 1):
        last = list(out)                     # what the shuffle reads
        for w in range(W):
            j = s - w
            if not 0 <= j < Lt:
                continue
            tc = staged[:, j]
            t0, t1, tvm = -(tc & 1), -((tc >> 1) & 1), -(tc < 4).long()
            zero = torch.zeros(N, dtype=torch.int64)
            cin, cp, cm = (zero, zero, zero) if w == 0 else (
                last[w - 1] & 1, (last[w - 1] >> 1) & 1,
                (last[w - 1] >> 2) & 1)
            q0, q1, vq, mend = planes[w]
            eq = (vq & ~((q0 ^ t0) | (q1 ^ t1))) & tvm
            xv = eq | mv[w]
            sw = (eq & pv[w]) + pv[w] + cin
            xh = ((sw & M31) ^ pv[w]) | eq
            ph = mv[w] | ~(xh | pv[w])
            mh = pv[w] & xh
            pb, mb = ((ph & mend) != 0).long(), ((mh & mend) != 0).long()
            ncp, ncm = (ph >> 30) & 1, (mh >> 30) & 1
            ph = ((ph << 1) & M31) | cp
            mh = ((mh << 1) & M31) | cm
            pv[w] = (mh | ~(xv | ph)) & M31
            mv[w] = ph & xv
            rows[:, j, w, 0], rows[:, j, w, 1] = pv[w], mv[w]
            out[w] = (sw >> 31) | (ncp << 1) | (ncm << 2)
            score[w] = score[w] + pb - mb
            take = (score[w] < best[w]) & (j < tl)
            bj[w] = torch.where(take, j + 1, bj[w])
            best[w] = torch.where(take, score[w], best[w])
    e = torch.clamp(ql - 1, min=0) // PAYLOAD
    writer = torch.where((ql > 0) & (e < W), e, 0)
    r = torch.arange(N)
    b, j = torch.stack(best)[writer, r], torch.stack(bj)[writer, r]
    zero = ql == 0
    return torch.where(zero, 0, b), torch.where(zero, 0, j), rows


def walk_schedule(rows, q, t, ql, dist, tend, bb, off, lb, qw, *,
                  min_identity, size_v, size_all, lpad, steps):
    """The gate and the walk as K2' runs them, one pair at a time: the
    float32 budget; lane w's share of D(i, j - 1) from word w, summed by a
    butterfly over the pair's G lanes; the vertical-delta bits; lane 0's
    votes, skipped outside [0, size_all); a stop at column 0."""
    N, Lt, W, _ = rows.shape
    Lq = q.shape[1]
    G = TMC.group_width(W)
    merged = np.zeros(size_all, np.int64)
    frac = np.float32(1.0 - min_identity)
    rows = rows.tolist()
    pop = lambda x: bin(x).count("1")
    for n in range(N):
        qln, D, j = int(ql[n]), int(dist[n]), int(tend[n])
        max_ed = int(np.float32(frac * np.float32(qln)))
        active = D <= max_ed and qln > 0 and j > 0
        i, run = qln, 0
        base_v = int(bb[n]) * lpad * TPU.N_SYM
        base_i = int(bb[n]) * lpad * SLOTS * 4 + size_v
        for _ in range(steps):
            if not active:
                break
            jm1 = min(max(j - 1, 0), Lt - 1)
            jm2 = min(max(j - 2, 0), Lt - 1)
            part = [0] * G
            for w in range(W):
                mask = (1 << min(max(i - PAYLOAD * w, 0), PAYLOAD)) - 1
                pv, mv = rows[n][jm2][w]
                part[w] = pop(pv & mask) - pop(mv & mask)
            o = G // 2
            while o:
                part = [part[x] + part[x ^ o] for x in range(G)]
                o //= 2
            assert len(set(part)) == 1      # every lane holds the sum
            wi, bi = (i - 1) // PAYLOAD, (i - 1) % PAYLOAD
            dv_j = dv_jm1 = 0
            if i >= 1 and wi < W:
                a, c = rows[n][jm1][wi], rows[n][jm2][wi]
                dv_j = ((a[0] >> bi) & 1) - ((a[1] >> bi) & 1)
                dv_jm1 = ((c[0] >> bi) & 1) - ((c[1] >> bi) & 1)
            dl = part[0] if j >= 2 else i
            dd = dl - (dv_jm1 if j >= 2 else 1)
            qi = min(max(i - 1, 0), Lq - 1)
            qs, ts = int(q[n, qi]), int(t[n, jm1])
            sub = int(qs != ts or qs >= 4 or ts >= 4)
            diag = dd + sub == D
            up = not diag and dv_j == 1
            left = not diag and not up and dl + 1 == D
            colf = j - 1 + int(off[n])
            in_rng = 0 <= colf < int(lb[n])
            wt = 1 if qw is None else int(qw[n, qi])
            idx = []
            if (diag or left) and in_rng:
                idx.append(base_v + colf * TPU.N_SYM + (qs if diag else 4))
            if up and in_rng and run < SLOTS:
                idx.append(base_i + (colf * SLOTS + min(run, SLOTS - 1)) * 4
                           + min(max(qs, 0), 3))
            for x in idx:
                if 0 <= x < size_all:
                    merged[x] += wt
            run = run + 1 if up else 0
            D -= sub if diag else int(up or left)
            i -= int(diag or up)
            j -= int(diag or left)
            active = (diag or up or left) and i >= 1 and j >= 1
    return merged


def kernel_votes(b, min_identity, weighted, steps):
    q, t, ql, tl, bb, off, lb, qw, nb, lpad = b
    size_v, size_all = sizes(nb, lpad)
    dist, tend, rows = dp_schedule(*_t(q, t, ql, tl))
    votes = walk_schedule(rows, q, t, ql, dist.numpy(), tend.numpy(), bb,
                          off, lb, qw if weighted else None,
                          min_identity=min_identity, size_v=size_v,
                          size_all=size_all, lpad=lpad, steps=steps)
    return votes, dist.numpy(), tend.numpy()


@pytest.mark.parametrize("case", ["unweighted", "weighted", "identity 0.9",
                                  "cut walk", "W 4"])
def test_kernel_schedule_matches_jax(case):
    mi, weighted = 0.75, case == "weighted"
    if case == "identity 0.9":
        b, mi, weighted = tenth_batch(51), 0.9, True
    elif case == "W 4":
        b = batch(52, P=40, Lq=112, band=16, lpad=320)
    else:
        b = batch(53 + weighted)
    Lq = b[0].shape[1]
    steps = 11 if case == "cut walk" else steps_for(Lq, mi)
    if case == "cut walk":
        ref, rdist, rtend = jax_votes_cut(b, mi, weighted, steps)
    else:
        ref = jax_votes(b, mi, weighted)
        jres = JM.myers_batch(*_j(*b[:4]))
        rdist, rtend = np.asarray(jres.dist), np.asarray(jres.tend)
    got, dist, tend = kernel_votes(b, mi, weighted, steps)
    assert int(ref.sum()) > 0
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(dist, rdist)
    np.testing.assert_array_equal(tend, rtend)


# ------------------------------------------------------------------ geometry

def test_votes_routes_and_banks():
    # the correction shape: W 4, 4 lanes a pair, 8 pairs a warp, 47 KB
    r = TMC.votes_route(112, 184)
    assert r == TMC.VotesRoute(4, 4, 8, 1480, 8 * 1480 * 4 + 8 * 132, False)
    assert TMC.votes_counter(r) == "myers_votes_cuda"
    assert TMC.votes_route(112, 184, scratch=True) == r._replace(
        smem=8 * 132, scratch=True)
    # 300 bp reads (pad 320): W 11 on 16 lanes, 2 pairs a warp
    assert TMC.votes_route(320, 392)[:3] == (11, 16, 2)
    # copy arbitration's chunks (pad 400 at k 15): W 13 on 16 lanes, 2
    # pairs a warp; in shared memory 98,840 B a block, 2 blocks an SM, fewer
    # than VOTES_SMEM_MIN_BLOCKS (4), so the planes go to the device scratch
    # (1.9x faster there on the card); the correction shape holds 4 blocks
    assert TMC.VOTES_SMEM_MIN_BLOCKS == 4
    assert TMC.votes_route(400, 472) == TMC.VotesRoute(
        13, 16, 2, 12320, 2 * 140, True)
    assert TMC.SMEM_SM // (2 * 12320 * 4 + 2 * 140 + TMC.SMEM_RESERVED) == 2
    assert TMC.SMEM_SM // (8 * 1480 * 4 + 8 * 132 + TMC.SMEM_RESERVED) == 4
    # W 11 (3 blocks an SM), W 20 (2), W 24 (one block of 157 KB), W 26
    # (pad 800), band 960 (329 KB, no fit): the scratch; W 1 and 2 at band
    # 64 stay in shared memory
    for lq in (320, 620, 744, 800):
        assert TMC.votes_route(lq, lq + 72).scratch is True, lq
    for lq in (31, 62):
        assert TMC.votes_route(lq, lq + 72).scratch is False, lq
    # W 33 and 34 (pads 1023 and 1024): two words a lane of the warp's one
    # pair, on the scratch
    for lq, W in ((1023, 33), (1024, 34)):
        r = TMC.votes_route(lq, lq + 72)
        assert (r.W, r.G, r.pairs, r.scratch) == (W, 32, 1, True)
    big = TMC.votes_route(744, 744 + 960 + 8)
    assert big.scratch and big.smem == 156 and big.pairs == 1
    assert TMC.votes_counter(big) == "myers_votes_cuda_scratch"
    for Lq in (1, 31, 62, 112, 320, 744):
        for Lt in (8, Lq + 72, 3 * Lq + 200):
            r = TMC.votes_route(Lq, Lt)
            assert r.stride % 2 == 0 and r.stride >= 2 * r.W * Lt
            assert r.smem <= TMC.SMEM_MAX and r.pairs * r.G == 32
    # past 34 words the wide route: one pair a warp, ceil(W / 32) words a
    # lane (their 5 x 32 x 4 B after the staged row), planes on the scratch,
    # its own counter; a batch whose planes pass VOTES_SCRATCH_BYTES runs in
    # sub-batches of whole warps (pad 3,100: W 100, ~2.5 MB a pair)
    for lq, W, wl in ((1085, 35, 2), (1488, 48, 2), (1984, 64, 2),
                      (1985, 65, 3), (3100, 100, 4)):
        r = TMC.votes_route(lq, lq + 72)
        assert (r.W, r.G, r.pairs, r.scratch, r.wl, r.words) == \
            (W, 32, 1, True, wl, False)
        lanes = -(-W // wl)
        row = ((TMC.STAGE_COLUMNS + lanes - 1 + 3) // 4 | 1) * 4
        assert r.smem == row + 5 * wl * 32 * 4
        assert TMC.votes_counter(r) == "myers_votes_cuda_wide"
    r = TMC.votes_route(3100, 3172)
    per = TMC.votes_launch_pairs(r, 4096)
    assert 0 < per < 4096 and per * r.stride * 4 <= TMC.VOTES_SCRATCH_BYTES
    assert TMC.votes_launch_pairs(r, 4096, budget=1) == 1
    assert TMC.votes_launch_pairs(TMC.votes_route(112, 184), 4096) == 4096
    assert TMC.votes_launch_pairs(TMC.votes_route(800, 872), 4096) == 4096
    huge = TMC.votes_route(31 * 12000, 100)           # words past SMEM_MAX
    assert huge.words and huge.smem < TMC.SMEM_MAX
    assert set(TMC.LAUNCHES) == {"myers_batch_cuda", "myers_batch_cuda_wide",
                                 "myers_batch_cuda_shared",
                                 "myers_batch_cuda_carry", "myers_votes_cuda",
                                 "myers_votes_cuda_scratch",
                                 "myers_votes_cuda_wide",
                                 "myers_batch_planes_cuda",
                                 "myers_batch_planes_cuda_wide"}
    # at W 1, 2 and 4 the DP's 64-bit plane stores of a half-warp (the
    # lanes a shared-memory access serves together) hit distinct banks
    for Lq in (31, 62, 112):
        r = TMC.votes_route(Lq, Lq + 72)
        s = 40
        for half in (range(16), range(16, 32)):
            banks = []
            for lane in half:
                g, w = divmod(lane, r.G)
                word = g * r.stride + 2 * ((s - w) * r.W + w)
                banks += [word % 32, (word + 1) % 32]
            assert len(set(banks)) == len(banks), Lq


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
def test_cuda_votes_kernel_matches_plain(cuda):
    for seed, (P, Lq, band, lpad) in enumerate(((512, 112, 64, 512),
                                                (256, 62, 24, 256),
                                                (64, 744, 960, 2048))):
        q, t, ql, tl, bb, off, lb, qw, nb, lpad = batch(seed, P, Lq, band,
                                                        lpad=lpad)
        size_v, size_all = sizes(nb, lpad)
        ins = [x.to(cuda) for x in _t(q, t, ql, tl, bb, off, lb, qw)]
        for weighted in (False, True):
            a = ins[:7] + [ins[7] if weighted else None]
            kw = dict(min_identity=0.75, size_v=size_v, lpad=lpad,
                      ins_slots=SLOTS, max_steps=steps_for(Lq, 0.75))
            ref_m = torch.zeros(size_all + 1, dtype=torch.int32, device=cuda)
            ref, _ = TPU.myers_votes(ref_m, *a, **kw)
            r = TMC.votes_route(Lq, t.shape[1])
            key = TMC.votes_counter(r)
            n = TMC.LAUNCHES[key]
            got_m = torch.zeros_like(ref_m)
            got, _ = TMC.myers_votes_cuda(got_m, *a, **kw)
            assert TMC.LAUNCHES[key] == n + 1
            assert torch.equal(got.dist, ref.dist)
            assert torch.equal(got.tend, ref.tend)
            assert torch.equal(got_m[:size_all], ref_m[:size_all])
            assert int(got_m[size_all]) == 0           # the sink untouched
            # the other plane home on the same inputs
            r2, *ops, outs = TMC.votes_operands(torch.zeros_like(ref_m), *a,
                                                scratch=True, **kw)
            TMC.run_votes_kernel(r2, *ops, outs)
            assert torch.equal(ops[3][:size_all], ref_m[:size_all])
