"""The port's evaluation module (utils/evalx.py) against the JAX package's
on the same numpy-seeded contigs and genomes, exactly: n50, the k-mer
metrics (linear and circular), the contig-set diff, alignment_identity
(the long-read engine) and segment_identity (every segment against one
shared row of 2 x genome + 1 columns) — and the shared-target mode of the
plain Myers engine, K1''s CPU path, against the reference's XLA engine
given a one-row target."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.ops import myers as JM
from hga_tpu.utils import evalx as JE
from hga_tpu_torch.io.encode import revcomp_str
from hga_tpu_torch.ops import myers as TM
from hga_tpu_torch.ops import myers_cuda as TMC
from hga_tpu_torch.utils import evalx as TE
from hga_tpu_torch.utils import sim


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
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _edit(seq: str, rng, rate: float) -> str:
    """Substitutions, insertions and deletions at `rate` each third."""
    out = []
    for c in seq:
        u = rng.random()
        if u < rate / 3:
            continue
        out.append("ACGT"[(("ACGT".index(c)) + 1 + int(u * 1e6) % 3) % 4]
                   if u < 2 * rate / 3 else c)
        if u > 1 - rate / 3:
            out.append("ACGT"[int(u * 1e7) % 4])
    return "".join(out)


def _contigs(genome: str, seed: int):
    """A rotated copy, a reverse-complemented piece with edits, a chimera
    of two distant pieces, a short piece, a piece with an N."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    rot = genome[G // 3:] + genome[: G // 3]
    pieces = [("rot", rot[: G - G // 5]),
              ("rc", revcomp_str(_edit(genome[G // 4: G // 2], rng, 0.02))),
              ("chim", genome[: G // 6] + genome[G // 2: G // 2 + G // 6]),
              ("short", genome[100:140]),
              ("withN", genome[G // 2: G // 2 + 300] + "N"
               + genome[G // 2 + 301: G // 2 + 700])]
    return pieces


def test_n50_matches_jax():
    rng = np.random.default_rng(3)
    for lens in ([], [5], [10, 10], [1, 2, 3, 4, 100],
                 list(rng.integers(1, 10_000, 57))):
        assert TE.n50(lens) == JE.n50(lens)


@pytest.mark.parametrize("circular", [False, True])
def test_evaluate_contigs_matches_jax(circular):
    genome = sim.random_genome(6000, seed=5)
    contigs = _contigs(genome, 6)
    for cs in (contigs, contigs[:1], [], [("whole", genome)],
               [("rot", genome[2000:] + genome[:2000])]):
        for k in (15, 21):
            assert TE.evaluate_contigs(cs, genome, k=k, circular=circular) \
                == JE.evaluate_contigs(cs, genome, k=k, circular=circular)
    # a rotation of the genome: identity 1 only when judged as a circle
    ev = TE.evaluate_contigs([("rot", genome[2000:] + genome[:2000])],
                             genome, circular=circular)
    assert (ev["identity"] == 1.0) == circular


def test_exact_contig_match_matches_jax():
    genome = sim.random_genome(3000, seed=7)
    cs = _contigs(genome, 8)
    flipped = [(n + "_x", revcomp_str(s)) for n, s in cs]
    for a, b in ((cs, cs), (cs, flipped), (cs, cs[1:]), ([], cs), (cs, [])):
        assert TE.exact_contig_match(a, b) == JE.exact_contig_match(a, b)
    # orientation is presentation (an N does not survive revcomp_str)
    assert TE.exact_contig_match(cs[:4], flipped[:4])["exact_match"]


def test_alignment_identity_matches_jax():
    genome = sim.random_genome(8000, seed=9)
    rng = np.random.default_rng(10)
    cs = [("a", _edit(genome[:5000], rng, 0.03)),
          ("b", revcomp_str(_edit(genome[3000:], rng, 0.01))),
          ("c", sim.random_genome(900, seed=11))]
    for contigs in ([], cs):
        got = TE.alignment_identity(contigs, genome, device="cpu")
        assert got == JE.alignment_identity(contigs, genome)
    assert 0.9 < got["alignment_identity"] < 1.0


def test_segment_identity_matches_jax():
    genome = sim.random_genome(2500, seed=12)
    rng = np.random.default_rng(13)
    cs = [("a", _edit(genome[:1500], rng, 0.02)),
          ("b", revcomp_str(genome[900:2500])),
          ("c", sim.random_genome(500, seed=14)),
          ("d", genome[1000:1001])]
    for contigs in (cs, [], cs[1:2]):
        got = TE.segment_identity(contigs, genome, device="cpu")
        assert got == JE.segment_identity(contigs, genome, mesh=None)
    ev = TE.segment_identity(cs[1:2], genome, device="cpu")
    assert ev["segment_identity"] == 1.0 and ev["n_segments"] == 5


def _shared_inputs(seed, N, Lq, Lt):
    """Queries copied from the shared row with edits, and random ones;
    qlen 0, 1, 31, 32, Lq; code 4 past qlen; a sentinel column and codes
    -1, 4, 9 in the row; ragged tlen per pair."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (1, Lt)).astype(np.int32)
    t[0, Lt // 2] = 4
    t[0, 5:9] = [-1, 4, 9, 9]
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    for n in range(0, N, 2):
        off = int(rng.integers(0, Lt - Lq))
        q[n] = t[0, off:off + Lq] % 4
        q[n, rng.integers(0, Lq, 3)] = rng.integers(0, 4, 3)
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    ql[:5] = [0, 1, 31, 32, Lq]
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    tl = np.full(N, Lt, np.int32)
    tl[N // 2:] = rng.integers(0, Lt + 1, N - N // 2)
    return q, t, ql, tl


@pytest.mark.parametrize("shape", [(64, 384, 1201), (96, 112, 700),
                                   (40, 20, 300)])
def test_shared_target_myers_matches_jax(shape):
    q, t, ql, tl = _shared_inputs(15, *shape)
    tq, tt, tql, ttl = (torch.from_numpy(x) for x in (q, t, ql, tl))
    ref = JM.myers_batch(*(jnp.asarray(x) for x in (q, t, ql, tl)))
    # through K1''s wrapper on CPU tensors: the plain version
    got = TMC.myers_batch_cuda(tq, tt, tql, ttl)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(got.tend.numpy(), np.asarray(ref.tend))
    # the same as every pair given its own copy of the row
    each = TM.myers_batch(tq, tt.expand(q.shape[0], -1).contiguous(), tql,
                          ttl)
    assert torch.equal(each.dist, got.dist)
    assert torch.equal(each.tend, got.tend)
    assert int(got.dist[:2].sum()) <= 1 and int(got.tend.max()) > 0


def test_shared_target_mode_rules():
    q = torch.zeros((8, 112), dtype=torch.int32)
    one = torch.ones(8, dtype=torch.int32)
    row = torch.zeros((1, 200), dtype=torch.int32)
    assert TMC.is_shared(q, row) and not TMC.is_shared(q[:1], row)
    ops = TMC.kernel_operands(q, row, one, one)
    assert ops[5] is True and ops[1] is row        # the row as given
    assert TMC.kernel_operands(q, q, one, one)[5] is False
    assert "myers_batch_cuda_shared" in TMC.LAUNCHES
    # K2 and K2' keep one target row a pair; K1' takes 1 or N rows only
    with pytest.raises(ValueError):
        TMC.myers_batch_planes_cuda(q, row, one, one)
    with pytest.raises(ValueError):
        TMC.myers_batch_cuda(q, torch.zeros((2, 200), dtype=torch.int32),
                             one, one)


@pytest.mark.cuda
def test_cuda_shared_target_matches_plain(cuda):
    for shape in ((64, 384, 1201), (96, 112, 700), (40, 20, 300),
                  (1000, 384, 3000)):
        args = [torch.from_numpy(x).to(cuda)
                for x in _shared_inputs(16, *shape)]
        ref = TM.myers_batch(*args)
        n = TMC.LAUNCHES["myers_batch_cuda_shared"]
        got = TMC.myers_batch_cuda(*args)
        assert TMC.LAUNCHES["myers_batch_cuda_shared"] == n + 1
        assert torch.equal(got.dist, ref.dist)
        assert torch.equal(got.tend, ref.tend)
