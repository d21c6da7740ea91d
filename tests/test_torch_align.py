"""Banded Smith-Waterman of the port (the plain version of K3 and its CUDA
wrapper) against the JAX package's XLA wavefront and its Pallas kernel in
interpret mode: score, qend and tend equal, including ties and edge cases."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.ops import align as JA
from hga_tpu.ops.align_pallas import banded_sw_batch_pallas
from hga_tpu_torch.ops import align as TA
from hga_tpu_torch.ops import align_cuda as TAC
from hga_tpu_torch.utils import spans

FIELDS = ("score", "qend", "tend")


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


def _random(seed, N, Lq, Lt):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    ql = rng.integers(1, Lq + 1, N).astype(np.int32)
    tl = rng.integers(1, Lt + 1, N).astype(np.int32)
    return q, t, ql, tl


def _planted(seed, N, Lq, Lt):
    """Targets hold a mutated copy of the query: long positive paths."""
    q, t, ql, tl = _random(seed, N, Lq, Lt)
    rng = np.random.default_rng(seed + 1)
    for i in range(N):
        lead = int(rng.integers(0, max(1, Lt - Lq)))
        seg = q[i, : Lt - lead].copy()
        flip = rng.random(seg.size) < 0.08
        seg[flip] = (seg[flip] + 1) % 4
        t[i, lead:lead + seg.size] = seg
    return q, t, ql, tl


def _edges(seed, N, Lq, Lt):
    """qlen/tlen 0 and full, padding codes 4 and -1, homopolymers and
    ACAC... repeats (many equal-score cells: the tie-break decides)."""
    q, t, ql, tl = _planted(seed, N, Lq, Lt)
    ql[0], tl[1] = 0, 0
    ql[2], tl[2] = Lq, Lt
    q[3], t[3] = 4, 4
    q[4, ::3], t[4, : Lt // 2] = 4, -1
    q[5], t[5] = 0, 0
    q[6], t[6] = 2, 2
    q[7, ::2], q[7, 1::2] = 0, 1
    t[7, ::2], t[7, 1::2] = 1, 0
    return q, t, ql, tl


# (inputs, band, Lq, Lt): the bands and widths of tests/test_align_pallas.py,
# the refine's forward shape, band >= Lq, and band 0
CASES = {
    "b9_24x32": (_random, 9, 24, 32),
    "b16_40x40": (_random, 16, 40, 40),
    "planted_b9": (_planted, 9, 24, 32),
    "edges_b16": (_edges, 16, 40, 40),
    "edges_b64_112x184": (_edges, 64, 112, 184),
    "band_ge_lq": (_edges, 50, 24, 32),
    "band0": (_planted, 0, 24, 24),
}


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla(case):
    make, band, Lq, Lt = CASES[case]
    q, t, ql, tl = make(3, 16, Lq, Lt)
    ref = JA.banded_sw_batch(jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
                             jnp.asarray(tl), band=band)
    got = TA.banded_sw_batch(*_t(q, t, ql, tl), band=band)
    assert int(np.asarray(ref.score).max()) > 0
    for f in FIELDS:
        r = np.asarray(getattr(ref, f))
        g = getattr(got, f).numpy()
        assert g.dtype == r.dtype == np.int32, f
        np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.mark.parametrize("case", ["b9_24x32", "b16_40x40", "edges_b16",
                                  "band_ge_lq"])
def test_plain_matches_pallas_interpret(case):
    make, band, Lq, Lt = CASES[case]
    q, t, ql, tl = make(5, 8, Lq, Lt)
    ref = banded_sw_batch_pallas(jnp.asarray(q), jnp.asarray(t),
                                 jnp.asarray(ql), jnp.asarray(tl), band=band,
                                 pair_tile=8, interpret=True, blk=8)
    got = TA.banded_sw_batch(*_t(q, t, ql, tl), band=band)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_scores_and_match_scheme_follow_arguments():
    q, t, ql, tl = _planted(9, 16, 24, 32)
    kw = dict(band=9, match=3, mismatch=-2, gap=-1)
    ref = JA.banded_sw_batch(jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
                             jnp.asarray(tl), **kw)
    got = TAC.banded_sw_batch_cuda(*_t(q, t, ql, tl), **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_sw_cells_matches_jax():
    rng = np.random.default_rng(11)
    ql = rng.integers(0, 113, 64)
    tl = rng.integers(0, 185, 64)
    for band in (0, 9, 64, 128, 500):
        assert TA.sw_cells(ql, tl, band) == JA.sw_cells(ql, tl, band)
    assert TA.sw_cells([], [], 64) == 0


def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    q, t, ql, tl = _t(*_edges(1, 16, 40, 40))
    before = spans.launches()["banded_sw_batch_cuda"]
    got = TAC.banded_sw_batch_cuda(q, t, ql, tl, band=16)
    ref = TA.banded_sw_batch(q, t, ql, tl, band=16)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert spans.launches()["banded_sw_batch_cuda"] == before
    empty = TAC.banded_sw_batch_cuda(q[:0], t[:0], ql[:0], tl[:0], band=16)
    assert all(x.shape == (0,) and x.dtype == torch.int32 for x in empty)


def test_wrapper_rejects_bad_operands():
    q, t, ql, tl = _t(*_random(2, 8, 24, 32))
    with pytest.raises(ValueError, match="int32"):
        TAC.banded_sw_batch_cuda(q.long(), t, ql, tl)
    with pytest.raises(ValueError, match="shape"):
        TAC.banded_sw_batch_cuda(q, t[:4], ql, tl)
    with pytest.raises(ValueError, match="contiguous"):
        TAC.banded_sw_batch_cuda(q[:, ::2], t, ql, tl)
    with pytest.raises(ValueError, match="band"):
        TAC.banded_sw_batch_cuda(q, t, ql, tl, band=-1)
    with pytest.raises(ValueError, match="gap"):
        TAC.banded_sw_batch_cuda(q, t, ql, tl, gap=1)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    for case, (make, band, Lq, Lt) in sorted(CASES.items()):
        q, t, ql, tl = (x.to(cuda) for x in _t(*make(7, 300, Lq, Lt)))
        before = spans.launches()["banded_sw_batch_cuda"]
        got = TAC.banded_sw_batch_cuda(q, t, ql, tl, band=band)
        ref = TA.banded_sw_batch(q, t, ql, tl, band=band)
        assert spans.launches()["banded_sw_batch_cuda"] == before + 1
        for f in FIELDS:
            assert torch.equal(getattr(got, f).cpu(),
                               getattr(ref, f).cpu()), (case, f)
