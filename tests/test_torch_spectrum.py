"""Spectrum stage of the port (ops/kmer, ops/count, models/spectrum) against
the JAX package on the same numpy-seeded reads, exact."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models.spectrum import count_reads as jcount
from hga_tpu.ops import count as JC
from hga_tpu.ops import kmer as JK
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.io.fastq import iter_records
from hga_tpu_torch.models.spectrum import count_reads as tcount
from hga_tpu_torch.ops import count as TC
from hga_tpu_torch.ops import kmer as TK
from hga_tpu_torch.ops import kmer_cuda as TKC
from hga_tpu_torch.utils import sim

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _reads(seed=3, n=40):
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(n):
        L = int(rng.integers(10, 70))
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
        if i % 7 == 0:                       # ambiguous bases
            p = int(rng.integers(0, L))
            s = s[:p] + "N" + s[p + 1:]
        seqs.append(s)
    return seqs


@pytest.mark.parametrize("k", [5, 15, 17, 21, 32])
def test_extract_kmers_and_hash_match_jax(k):
    seqs = [s for s in _reads() if len(s) >= 1]
    pr = jpack(seqs, pad_len=80)
    ref = JK.extract_kmers(jnp.asarray(pr.packed), jnp.asarray(pr.bad),
                           jnp.asarray(pr.length), k)
    got = TK.extract_kmers(TK.words_to_tensor(pr.packed, "cpu"),
                           TK.words_to_tensor(pr.bad, "cpu"),
                           torch.from_numpy(pr.length), k)
    for f in ("hi", "lo", "strand", "valid"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.int64),
            np.asarray(getattr(ref, f)).astype(np.int64), err_msg=f)
    np.testing.assert_array_equal(
        TK.kmer_hash32(got.hi, got.lo).numpy(),
        np.asarray(JK.kmer_hash32(ref.hi, ref.lo)).astype(np.int64))


def _border_reads(pad, k, seed, n=48):
    """Reads padded to `pad`: lengths 0, 1, k - 1, k, k + 1, pad and random
    ones, N bases on the borders of packed words (16) and bad-flag words
    (32) in some of them."""
    rng = np.random.default_rng(seed)
    fixed = [0, 1, max(0, k - 1), k, k + 1, pad, pad - 1]
    seqs = []
    for i in range(n):
        L = min(pad, fixed[i] if i < len(fixed) else
                int(rng.integers(0, pad + 1)))
        s = list("ACGT"[c] for c in rng.integers(0, 4, L))
        if i % 3 == 1:
            for b in (15, 16, 31, 32, 47, 48, 63, 64):
                if b < L and rng.random() < 0.5:
                    s[b] = "N"
        seqs.append("".join(s))
    return seqs


def _jax_keys(pr, k):
    """The JAX package's extract_kmers, packed into int64 keys (hi, lo) ->
    ((hi << 32) | lo) ^ 2^63 and masked with the sentinel key."""
    ref = JK.extract_kmers(jnp.asarray(pr.packed), jnp.asarray(pr.bad),
                           jnp.asarray(pr.length), k)
    v = ((np.asarray(ref.hi).astype(np.uint64) << np.uint64(32))
         | np.asarray(ref.lo).astype(np.uint64)) ^ np.uint64(1 << 63)
    return np.where(np.asarray(ref.valid), v.view(np.int64),
                    TC.SENTINEL_KEY).reshape(-1)


def _t(pr):
    return (TK.words_to_tensor(pr.packed, "cpu"),
            TK.words_to_tensor(pr.bad, "cpu"), torch.from_numpy(pr.length))


@pytest.mark.parametrize("k,pad", [(k, pad) for k in (1, 15, 16, 17, 21, 31,
                                                      32)
                                   for pad in (16, 80, 112) if pad >= k])
def test_kmer_keys_match_jax(k, pad):
    """kmer_keys' plain version against the JAX package's extract_kmers ->
    pack -> mask: N bases on word borders, reads shorter than k, empty
    reads."""
    pr = jpack(_border_reads(pad, k, seed=k * 1000 + pad), pad_len=pad)
    got = TK.kmer_keys(*_t(pr), k)
    assert got.dtype == torch.int64
    assert got.shape == (pr.packed.shape[0] * (pad - k + 1),)
    np.testing.assert_array_equal(got.numpy(), _jax_keys(pr, k))


def _funnel(lo, hi, s):
    """__funnelshift_r on uint64 arrays holding uint32 words."""
    return ((hi << np.uint64(32) | lo) >> s.astype(np.uint64)) & \
        np.uint64(0xFFFFFFFF)


def _rev2(v):
    """Each uint32 word's 16 2-bit codes in reverse order."""
    out = np.zeros_like(v)
    for g in range(16):
        out |= ((v >> np.uint64(2 * g)) & np.uint64(3)) << np.uint64(
            2 * (15 - g))
    return out


def _kernel_schedule(packed, bad, length, k):
    """csrc/kmer.cu's order of work in numpy: the tiles of
    kmer_cuda.geometry, each staging its rows' words (in order, reversed,
    the bad flags; zero words after) within the tile's shared bytes, then
    each of the block's threads stepping its (row, group of V positions)
    work, the V windows cut from the same three words of each stream (two
    of flags) at the kernel's own offsets.  Asserts that every slot is
    written exactly once and that no read leaves a staged row; returns the
    keys."""
    R, W = packed.shape
    BW = bad.shape[1]
    m = 16 * W - k + 1
    g = TKC.geometry(R, W, k)
    V = g.vec
    assert g.smem <= TKC.SMEM_MAX and m % V == 0 and g.span % V == 0
    packed = packed.astype(np.uint64)
    bad = bad.astype(np.uint64)
    mask = np.uint64((1 << 2 * k) - 1)
    bmask = np.uint64((1 << k) - 1)
    out = np.zeros(R * m, np.int64)
    written = np.zeros(R * m, np.int64)
    for tile in range(g.tiles):
        r0 = tile // g.tiles_row * g.rows
        p0 = tile % g.tiles_row * g.span
        assert p0 % 32 == 0
        nr, np_ = min(g.rows, R - r0), min(g.span, m - p0)
        wa, ba = p0 >> 4, p0 >> 5
        nw = ((p0 + np_ + k - 2) >> 4) - wa + 1
        nb = ((p0 + np_ + k - 2) >> 5) - ba + 1
        assert wa + nw <= W and ba + nb <= BW
        sw, sb = nw + 2, nb + 1
        assert 4 * nr * (2 * sw + sb + 1) <= g.smem
        fw = np.zeros((nr, sw), np.uint64)
        fw[:, :nw] = packed[r0:r0 + nr, wa:wa + nw]
        rv = np.zeros((nr, sw), np.uint64)
        rv[:, :nw] = _rev2(fw[:, :nw])[:, ::-1]
        bw = np.zeros((nr, sb), np.uint64)
        bw[:, :nb] = bad[r0:r0 + nr, ba:ba + nb]
        ln = length[r0:r0 + nr].astype(np.int64)
        qr = 16 * nw - k - (V - 1)
        ng = np_ // V
        step_r, step_g = divmod(TKC.THREADS, ng)
        t = np.arange(TKC.THREADS)
        rr, gg = t // ng, t % ng
        while True:
            a = rr < nr
            if not a.any():
                break
            r, pp = rr[a], gg[a] * V
            qv = qr - pp
            fi, bi, zi = pp >> 4, qv >> 4, pp >> 5
            assert (qv >= 0).all() and (fi + 2 < sw).all()
            assert (bi + 2 < sw).all() and (zi + 1 < sb).all()
            f = [fw[r, fi + i] for i in range(3)]
            b = [rv[r, bi + i] for i in range(3)]
            z = [bw[r, zi + i] for i in range(2)]
            of, ov, oz = (pp & 15) << 1, (qv & 15) << 1, pp & 31
            room = ln[r] - k - p0 - pp
            for j in range(V):
                o, u = of + 2 * j, ov + 2 * (V - 1 - j)
                assert (o <= 31).all() and (u <= 31).all()
                assert (oz + j <= 31).all()
                rc = ~((_funnel(f[1], f[2], o) << np.uint64(32))
                       | _funnel(f[0], f[1], o)) & mask
                fwd = ((_funnel(b[1], b[2], u) << np.uint64(32))
                       | _funnel(b[0], b[1], u)) & mask
                flags = _funnel(z[0], z[1], oz + j) & bmask
                ok = (flags == 0) & (j <= room)
                key = (np.minimum(fwd, rc) ^ np.uint64(1 << 63)).view(
                    np.int64)
                idx = (r0 + r) * m + p0 + pp + j
                out[idx] = np.where(ok, key, TC.SENTINEL_KEY)
                np.add.at(written, idx, 1)
            gg = gg + step_g
            rr = rr + step_r + (gg >= ng)
            gg = np.where(gg >= ng, gg - ng, gg)
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("pad,k,n", [
    (112, 21, 100),     # the count's shape: 44 whole reads a tile, V 2
    (16, 1, 40),        # m 16
    (80, 16, 40),       # m 65, V 1
    (32, 32, 2300),     # m 1, V 1: 1,117 reads a tile (shared bytes)
    (1024, 17, 9),      # m 1,008: four reads a tile
    (4160, 21, 3),      # m 4,140: two tiles a read, the last of 44 slots
    (8224, 32, 2),      # m 8,193, V 1: tiles of 4,096 positions
    (8224, 31, 2),      # m 8,194, V 2: tiles of 4,096 positions
])
def test_kmer_kernel_schedule(pad, k, n):
    """The kernel's tiles, staging and slot stepping (emulated) give
    kmer_keys' plain version slot for slot."""
    seqs = _border_reads(pad, k, seed=pad + k, n=n)
    if pad >= 1024:                 # N bases far into the long reads too
        seqs = [s[:1500] + "N" + s[1501:] if len(s) > 1501 else s
                for s in seqs]
    pr = tpack(seqs, pad_len=pad)
    got = _kernel_schedule(pr.packed, pr.bad, pr.length, k)
    np.testing.assert_array_equal(got, TK.kmer_keys(*_t(pr), k).numpy())


def test_kmer_geometry_by_shape():
    """Every shape's tiles stay within 48 KB of shared memory and cover
    each read's positions once; whole reads go ~SLOTS slots a tile."""
    for W in (1, 2, 3, 7, 18, 64, 255, 256, 257, 258, 513, 1938):
        for k in (1, 16, 17, 21, 32):
            m = 16 * W - k + 1
            if m < 1:
                continue
            g = TKC.geometry(65536, W, k)
            assert 0 < g.smem <= TKC.SMEM_MAX
            assert g.tiles_row * g.span >= m > (g.tiles_row - 1) * g.span
            assert g.rows == 1 or g.span == m
            assert g.vec == 2 - m % 2 and g.span % g.vec == 0
            assert g.tiles == -(-65536 // g.rows) * g.tiles_row
            if m <= TKC.SLOTS and W > 2:
                assert g.rows * m > TKC.SLOTS - m
    assert TKC.geometry(65536, 7, 21) == (44, 92, 1, 1490, 4224, 2)


@pytest.mark.parametrize("case", ["k0", "k33", "bad_rows", "length_rows",
                                  "short_pad", "bad_words"])
def test_kmer_keys_raises(case):
    pr = tpack(["ACGT" * 10] * 3, pad_len=48)
    packed, bad, length = _t(pr)
    k = {"k0": 0, "k33": 33}.get(case, 21)
    if case == "bad_rows":
        bad = bad[:2]
    elif case == "length_rows":
        length = torch.cat([length, length[:1]])
    elif case == "short_pad":
        packed, bad = packed[:, :1], bad[:, :1]
    elif case == "bad_words":
        packed = torch.cat([packed, packed], dim=1)     # 96 bases, 64 flags
    with pytest.raises(ValueError):
        TK.kmer_keys(packed, bad, length, k)


def test_count_ops_match_jax():
    rng = np.random.default_rng(5)
    n = 3000
    hi = rng.integers(0, 4, n).astype(np.uint32)
    hi[::17] = rng.integers(0, 2**32, hi[::17].size, dtype=np.uint64)
    lo = rng.integers(0, 50, n).astype(np.uint32)
    hi[::11] = 0xFFFFFFFF                       # sentinels
    lo[::11] = 0xFFFFFFFF
    w = rng.integers(0, 3, n).astype(np.int32)
    t = lambda x: torch.from_numpy(x.astype(np.int64))
    ref = JC.sort_and_count(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w))
    got = TC.sort_and_count(t(hi), t(lo), t(w))
    assert got.n == int(ref.n)
    for f in ("hi", "lo", "count"):
        np.testing.assert_array_equal(getattr(got, f).numpy().astype(np.int64),
                                      np.asarray(getattr(ref, f)).astype(
                                          np.int64), err_msg=f)
    np.testing.assert_array_equal(
        TC.spectrum_histogram(got, 20).numpy(),
        np.asarray(JC.spectrum_histogram(ref, 20)))
    rs, gs = JC.filter_solid(ref, jnp.int32(3)), TC.filter_solid(got, 3)
    assert gs.n == int(rs.n)
    np.testing.assert_array_equal(gs.hi.numpy(), np.asarray(rs.hi))
    np.testing.assert_array_equal(gs.count.numpy(), np.asarray(rs.count))
    rm = JC.merge_counted(ref, rs)
    gm = TC.merge_counted(got, gs)
    np.testing.assert_array_equal(gm.count.numpy(), np.asarray(rm.count))
    np.testing.assert_array_equal(gm.lo.numpy(), np.asarray(rm.lo))
    qhi, qlo = hi[::3].copy(), lo[::3].copy()
    qlo[::5] += 7
    np.testing.assert_array_equal(
        TC.member_sorted(gs.hi, gs.lo, t(qhi), t(qlo)).numpy(),
        np.asarray(JC.member_sorted(rs.hi, rs.lo, jnp.asarray(qhi),
                                    jnp.asarray(qlo))))


@pytest.fixture(scope="module")
def spectra():
    ds = sim.make_dataset(genome_len=8000, short_cov=20, long_cov=0,
                          seed=61, short_err=0.01)
    kw = dict(k=15, w=5, batch_reads=256)
    pr = jpack(ds.short_seqs, names=ds.short_names, pad_len=112)
    return (jcount(pr, JCfg(**kw)),
            tcount(tpack(ds.short_seqs, names=ds.short_names, pad_len=112),
                   TCfg(**kw), device="cpu"))


def test_count_reads_matches_jax(spectra, tmp_path):
    ref, got = spectra
    assert got.threshold == ref.threshold and got.k == ref.k
    assert got.n_distinct == ref.n_distinct
    for f in ("hi", "lo", "count", "hist"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(got.solid_set(), ref.solid_set()):
        np.testing.assert_array_equal(a, b)
    ref.save(str(tmp_path / "j.npz"))
    got.save(str(tmp_path / "t.npz"))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert zj.files == zt.files
    for f in zj.files:
        np.testing.assert_array_equal(zj[f], zt[f])


def test_golden_spectrum():
    recs = list(iter_records(os.path.join(FIX, "short.fasta")))
    pr = tpack([r.seq for r in recs], names=[r.name for r in recs],
               pad_len=112)
    cfg = TCfg(k=15, w=5, band=32, batch_reads=256,
               min_shared_minimizers=2, min_overlap_len=30)
    spec = tcount(pr, cfg, device="cpu")
    got = "".join(f"{c}\t{int(n)}\n" for c, n in enumerate(spec.hist))
    with open(os.path.join(FIX, "golden_spectrum.tsv")) as fh:
        assert got == fh.read()


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU behaviour")
    pr = tpack(["ACGTACGTACGTACGTACGT"], pad_len=32)
    with pytest.raises(RuntimeError, match="cuda"):
        tcount(pr, TCfg(k=15, w=5), device="cuda")
