"""The port's kernel harnesses (hga_tpu_torch.exp) against the JAX package's
harness kernels run in Pallas interpret mode: X2 (exp/sw_variants.py v1, v2,
v3), X1 (exp/myers_micro.py run_b) and X3 (exp/vpu_micro.py make) equal
the port's plain versions exactly, on the same numpy-seeded inputs.  Then
the wrappers' rules: a CPU tensor gives the plain result without a launch,
bad operands raise, and the CUDA kernels (marked ``cuda``) equal the plain
versions on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import exp.myers_micro as JMM
import exp.sw_variants as JSV
import exp.vpu_micro as JVM
from hga_tpu.ops.myers import query_planes as jax_query_planes
from hga_tpu_torch.exp import myers_micro as MM
from hga_tpu_torch.exp import sw_variants as SV
from hga_tpu_torch.exp import vpu_micro as VM
from hga_tpu_torch.ops import align as TA
from hga_tpu_torch.ops import myers as TM

SW_FIELDS = ("score", "qend", "tend")
INT32_MAX = 2**31 - 1


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


# ------------------------------------------------------------------ X2 inputs

def _sw_inputs(seed, N, Lq, Lt):
    """check()'s kind of pairs at a small size: random codes, a real overlap
    planted in every other pair, ragged lengths; then rows with qlen/tlen 0,
    homopolymers and ACAC... repeats (ties), and codes 4 and -1."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(0, N, 2):
        L = int(rng.integers(Lq // 2, Lq))
        off = int(rng.integers(0, Lt - L))
        t[n, off:off + L] = q[n, :L]
    ql = rng.integers(Lq // 2, Lq + 1, N).astype(np.int32)
    tl = rng.integers(Lt // 2, Lt + 1, N).astype(np.int32)
    ql[1], tl[3] = 0, 0
    ql[5], tl[5] = Lq, Lt
    q[7:11], t[7:11] = 0, 0                       # homopolymers
    q[11:15, ::2], q[11:15, 1::2] = 0, 1          # ACAC... against CACA...
    t[11:15, ::2], t[11:15, 1::2] = 1, 0
    q[16, ::3], t[16, : Lt // 2] = 4, -1          # padding codes
    q[17, Lq // 2:], t[17, Lt // 3:] = -1, 4
    return q, t, ql, tl


# (N, Lq, Lt, band): the harness's layouts at a size interpret mode runs
SW_SHAPES = {"32x64_b8": (256, 32, 64, 8), "48x96_b16": (256, 48, 96, 16)}


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
@pytest.mark.parametrize("shape", sorted(SW_SHAPES))
def test_sw_variants_plain_matches_pallas_interpret(variant, shape):
    N, Lq, Lt, band = SW_SHAPES[shape]
    q, t, ql, tl = _sw_inputs(11, N, Lq, Lt)
    with pltpu.force_tpu_interpret_mode():
        ref = JSV.sw_pallas_exp(jnp.asarray(q), jnp.asarray(t),
                                jnp.asarray(ql), jnp.asarray(tl), band=band,
                                blk=8, variant=variant)
    got = SV.sw_pallas_exp(*_t(q, t, ql, tl), band=band, variant=variant)
    assert int(np.asarray(ref.score).max()) > 0
    for f in SW_FIELDS:
        r = np.asarray(getattr(ref, f))
        g = getattr(got, f).numpy()
        assert g.dtype == r.dtype == np.int32, f
        np.testing.assert_array_equal(g, r, err_msg=f)


def test_dlohi_matches_the_harness():
    rng = np.random.default_rng(4)
    ql = rng.integers(0, 49, 64).astype(np.int32)
    tl = rng.integers(0, 97, 64).astype(np.int32)
    for band in (0, 8, 16, 64):
        jlo, jhi = JSV._dlohi(jnp.asarray(ql), jnp.asarray(tl), 48, band)
        lo, hi = SV._dlohi(*_t(ql, tl), 48, band)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_variant_names_parse_as_the_harness_reads_them():
    assert SV.parse_variant("v1") == (False, 1, 0)
    assert SV.parse_variant("v1nots") == (False, 1, 1)
    assert SV.parse_variant("v1nomasknobest") == (False, 1, 12)
    assert SV.parse_variant("v2") == (True, 1, 0)
    assert SV.parse_variant("v3") == (False, 4, 0)
    assert SV.parse_variant("v3g2") == (False, 2, 0)
    with pytest.raises(ValueError, match="unknown variant"):
        SV.parse_variant("v9")
    assert [SV.slots_per_lane("v1", lq) for lq in (1, 32, 33, 128, 256)] \
        == [1, 1, 2, 4, 8]
    with pytest.raises(ValueError, match="exceeds"):
        SV.slots_per_lane("v3", 129)


# ------------------------------------------------------------------ X1

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
    ql[:4] = [0, 1, min(31, Lq), Lq]
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    tl = rng.integers(1, Lt + 1, N).astype(np.int32)
    tl[:2] = Lt
    t[:64, :6] = rng.choice([-1, 4, 9], size=(64, 6))
    return q, t, ql, tl


def _tiled(q, t, ql, tl, S):
    """exp/myers_micro.prep's (G, S, 128) TPU tiling of given pairs."""
    N, Lq = q.shape
    W = TM.n_words(Lq)
    planes = map(np.asarray, jax_query_planes(jnp.asarray(q), jnp.asarray(ql),
                                              W))
    G = N // (S * 128)
    to4 = lambda x: np.ascontiguousarray(     # noqa: E731
        x.reshape(G, S, 128, x.shape[1]).transpose(0, 3, 1, 2))
    to3 = lambda x: x.reshape(G, S, 128)      # noqa: E731
    return (to3(ql), to3(tl), *(to4(p) for p in planes), to4(t))


@pytest.mark.parametrize("Lq", [31, 40])       # W 1 and 2
def test_run_b_plain_matches_pallas_interpret(Lq):
    N, Lt, S, BLK = 1024, 40, 8, 8
    q, t, ql, tl = _myers_inputs(21 + Lq, N, Lq, Lt)
    with pltpu.force_tpu_interpret_mode():
        d, e = JMM.run_b(*[jnp.asarray(x) for x in _tiled(q, t, ql, tl, S)],
                         S=S, BLK=BLK)
    qd, td, qld, tld = _t(q, t, ql, tl)
    planes = TM.query_planes(qd, qld, TM.n_words(Lq))
    got = MM.run_b(qld, tld, *planes, td, S=S, BLK=BLK)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(d).reshape(-1))
    np.testing.assert_array_equal(got.tend.numpy(), np.asarray(e).reshape(-1))
    ref = TM.myers_batch(qd, td, qld, tld)
    assert torch.equal(got.dist, ref.dist) and torch.equal(got.tend, ref.tend)


def test_prep_matches_the_harness_inputs():
    args, q, t, ql, tl = JMM.prep(1024, 40, 48, S=8)
    ops, (tq, tt, tql, ttl) = MM.prep(1024, 40, 48, "cpu")
    for a, b in ((q, tq), (t, tt), (ql, tql), (tl, ttl)):
        np.testing.assert_array_equal(b.numpy(), a)
    # the port's operands are the (G, S, 128) tiles untiled
    untile4 = lambda x: x.transpose(0, 2, 3, 1).reshape(1024, -1)  # noqa
    for a, b in zip(args[2:6], ops[2:6]):
        np.testing.assert_array_equal(b.numpy(), untile4(a))
    np.testing.assert_array_equal(ops[0].numpy(), args[0].reshape(-1))


# ------------------------------------------------------------------ X3

@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("start", ["arange", "near_max"])
def test_vpu_chains_plain_matches_pallas_interpret(C, start):
    R, steps = 8, 16
    if start == "arange":
        x = np.arange(R * 128, dtype=np.int32).reshape(R, 128)
    else:                          # the chains wrap and then stop at the max
        x = (INT32_MAX - np.arange(R * 128) % 40).astype(np.int32)
        x = x.reshape(R, 128)
        x[0, :3] = [-2**31, -1, 0]
    run, _ = JVM.make(R=R, C=C, STEPS=steps)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(run(jnp.asarray(x)))
    got = VM.chains(torch.from_numpy(x), C, steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if start == "arange" and C == 2:
        np.testing.assert_array_equal(ref, 2 * x + 17)


def test_vpu_chains_wrapper_on_cpu_repeats_the_plain_version():
    x = torch.arange(256, dtype=torch.int32).reshape(2, 128)
    before = dict(VM.LAUNCHES)
    got = VM.vpu_chains_cuda(x, 4, 16, reps=3)
    assert got.shape == (3, 2, 128)
    for r in range(3):
        assert torch.equal(got[r], VM.chains(x, 4, 16))
    assert VM.LAUNCHES == before


def test_vpu_chains_wrapper_rejects_bad_operands():
    x = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        VM.vpu_chains_cuda(x.long())
    with pytest.raises(ValueError, match="2-D"):
        VM.vpu_chains_cuda(x[0])
    with pytest.raises(ValueError, match="contiguous"):
        VM.vpu_chains_cuda(x[:, ::2])
    with pytest.raises(ValueError, match="reps"):
        VM.vpu_chains_cuda(x, reps=0)


# ------------------------------------------------------------------ wrappers

def test_run_b_wrapper_on_cpu_runs_the_plain_version_without_launching():
    q, t, ql, tl = _t(*_myers_inputs(5, 200, 40, 48))
    planes = TM.query_planes(q, ql, 2)
    before = dict(MM.LAUNCHES)
    got = MM.run_b(ql, tl, *planes, t, S=2, BLK=8)
    ref = TM.myers_batch(q, t, ql, tl)
    assert torch.equal(got.dist, ref.dist) and torch.equal(got.tend, ref.tend)
    assert MM.LAUNCHES == before


def test_run_b_wrapper_rejects_bad_operands():
    q, t, ql, tl = _t(*_myers_inputs(6, 64, 40, 48))
    planes = list(TM.query_planes(q, ql, 2))
    with pytest.raises(ValueError, match="int32"):
        MM.run_b(ql, tl, *planes, t.long())
    with pytest.raises(ValueError, match="shape"):
        MM.run_b(ql[:8], tl, *planes, t)
    with pytest.raises(ValueError, match="contiguous"):
        MM.run_b(ql, tl, *planes, t[:, ::2])
    with pytest.raises(ValueError, match="exceeds"):      # 256 x 1024 bytes
        MM.run_b(ql, tl, *planes, t, S=64, BLK=256)
    wide = torch.zeros((64, MM.MAX_WORDS + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="words"):
        MM.run_b(ql, tl, wide, wide, wide, wide, t)


def test_sw_variants_wrapper_on_cpu_and_its_limits():
    q, t, ql, tl = _t(*_sw_inputs(8, 32, 32, 64))
    before = dict(SV.LAUNCHES)
    for v in ("v1", "v2", "v3", "v3g2"):
        got = SV.sw_pallas_exp(q, t, ql, tl, band=8, variant=v)
        ref = TA.banded_sw_batch(q, t, ql, tl, band=8)
        for f in SW_FIELDS:
            assert torch.equal(getattr(got, f), getattr(ref, f)), (v, f)
    assert SV.LAUNCHES == before
    with pytest.raises(ValueError, match="ablation"):
        SV.sw_pallas_exp(q, t, ql, tl, band=8, variant="v1nots")
    with pytest.raises(ValueError, match="int32"):
        SV.sw_pallas_exp(q.long(), t, ql, tl, variant="v1")
    with pytest.raises(ValueError, match="pair_tile"):
        SV.sw_pallas_exp(q, t, ql, tl, variant="v1", pair_tile=48)
    # v2 holds scores and anti-diagonals in int16
    qq = torch.zeros((1, 128), dtype=torch.int32)
    tt = torch.zeros((1, 32700), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int16"):
        SV.sw_pallas_exp(qq, tt, one, one, variant="v2")
    with pytest.raises(ValueError, match="int16"):
        SV.sw_pallas_exp(qq, tt[:, :64], one, one, match=300, variant="v2")
    SV.sw_pallas_exp(qq, tt, one, one, variant="v1")      # v1 takes it


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
def test_cuda_harness_kernels_match_plain(cuda):
    x = torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128)
    x[0, :3] = torch.tensor([INT32_MAX - 5, INT32_MAX, -2**31])
    xd = x.to(cuda)
    for C in (1, 2, 4, 8):
        n = VM.LAUNCHES["vpu_chains_cuda"]
        got = VM.vpu_chains_cuda(xd, C, 16, reps=2)
        assert VM.LAUNCHES["vpu_chains_cuda"] == n + 1
        assert torch.equal(got.cpu(), VM.chains(x, C, 16).expand(2, 8, 128))
    q, t, ql, tl = (a.to(cuda) for a in _t(*_myers_inputs(9, 1000, 40, 48)))
    planes = TM.query_planes(q, ql, 2)
    ref = TM.myers_batch(q, t, ql, tl)
    for S, BLK in ((8, 8), (2, 32)):
        n = MM.LAUNCHES["run_b_cuda"]
        got = MM.run_b(ql, tl, *planes, t, S=S, BLK=BLK)
        assert MM.LAUNCHES["run_b_cuda"] == n + 1
        assert torch.equal(got.dist, ref.dist)
        assert torch.equal(got.tend, ref.tend)
    q, t, ql, tl = (a.to(cuda) for a in _t(*_sw_inputs(10, 300, 48, 96)))
    ref = TA.banded_sw_batch(q, t, ql, tl, band=16)
    for v in ("v1", "v2", "v3", "v3g2"):
        n = SV.LAUNCHES[v[:2]]
        got = SV.sw_pallas_exp(q, t, ql, tl, band=16, variant=v)
        assert SV.LAUNCHES[v[:2]] == n + 1
        for f in SW_FIELDS:
            assert torch.equal(getattr(got, f), getattr(ref, f)), (v, f)
