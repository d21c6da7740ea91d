"""The ring Myers engine (hga_tpu_torch.parallel.ring_myers) and its step,
the resumable plain recurrence ops/myers.myers_cols (the plain version of
K1''s carried-state mode), against the JAX package: myers_cols resumed over
chunks of 1, 31, 32, 1024 and 1025 columns (odd Lt), myers_ring at
(P, blocks_per_dev) = (2, 2), (4, 1), (4, 4) and a shared target at (4, 2)
on gloo CPU ranks against hga_tpu.parallel.ring_myers on a P-device mesh,
and segment_identity on 4 ranks against the JAX mesh value and one rank.

No JAX import at the top: the rank processes import this module.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from hga_tpu_torch.ops import myers as TM
from hga_tpu_torch.ops import myers_cuda as TMC
from hga_tpu_torch.parallel.launch import launch

HERE = os.path.dirname(os.path.abspath(__file__))
# (P, blocks_per_dev, shared target)
RINGS = [(2, 2, False), (4, 1, False), (4, 4, False), (4, 2, True)]
CHUNKS = [1, 31, 32, 1024, 1025]      # resumed chunk sizes, Lt 2113 (odd)


def _ring_inputs(P, bpd, shared, seed=11):
    """test_ring_myers.py's planted overlaps, some across chunk borders
    (shared: planted segments of one target row)."""
    rng = np.random.default_rng(seed + 7 * P + bpd)
    N, Lq, Lt = 4 * P * bpd, 45, 48 * P
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (1 if shared else N, Lt)).astype(np.int32)
    for n in range(0, N, 2):
        off = int(rng.integers(0, Lt - Lq))
        if shared:
            q[n] = t[0, off:off + Lq]
            q[n, 5] = (q[n, 5] + 1) % 4
        else:
            t[n, off:off + Lq] = q[n]
            t[n, off + 7] = (t[n, off + 7] + 1) % 4
    ql = rng.integers(1, Lq + 1, N).astype(np.int32)
    ql[1] = 0
    tl = rng.integers(Lt // 2, Lt + 1, N).astype(np.int32)
    return q, t, ql, tl


def _genome_contigs():
    """test_ring_myers.py's segment_identity case: a 3 kb genome, a clean
    contig and one with sprinkled substitutions."""
    from hga_tpu_torch.utils import sim

    genome = sim.random_genome(3000, seed=21)
    c1 = list(genome[1300:2900])
    for p in range(10, len(c1), 97):
        c1[p] = "ACGT"[("ACGT".index(c1[p]) + 1) % 4]
    return genome, [("c0", genome[:1400]), ("c1", "".join(c1))]


# ---------------------------------------------------------------- worker

def _w_rings(P: int):
    """Every ring case of this world size, and segment_identity at P 4."""
    from hga_tpu_torch.parallel.mesh import make_mesh
    from hga_tpu_torch.parallel.ring_myers import myers_ring
    from hga_tpu_torch.utils.evalx import segment_identity

    mesh = make_mesh()
    out = {}
    for p, bpd, shared in RINGS:
        if p != P:
            continue
        q, t, ql, tl = (torch.from_numpy(x)
                        for x in _ring_inputs(p, bpd, shared))
        r = myers_ring(mesh, q, t, ql, tl, blocks_per_dev=bpd)
        out[f"{bpd}{shared}"] = [r.dist.tolist(), r.tend.tolist()]
    if P == 4:
        genome, contigs = _genome_contigs()
        out["seg"] = segment_identity(contigs, genome, seg=96, device="cpu",
                                      mesh=mesh)
        out["perfect"] = segment_identity([("g", genome)], genome, seg=96,
                                          device="cpu", mesh=mesh)
    return out


# ---------------------------------------------------------------- tests

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ring cases on 2 and on 4 gloo CPU ranks, started together."""
    root = tmp_path_factory.mktemp("ring")
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futs = {P: pool.submit(launch, "test_torch_ring:_w_rings", P,
                           str(root / f"p{P}"), {"P": P}, threads=1,
                           pythonpath=[HERE], timeout=400)
            for P in (2, 4)}
    return futs


def _ranks(ranks, P):
    outs = ranks[P].result()
    for o in outs:
        assert not o["jax_loaded"] and not o["hga_tpu_loaded"], o
        assert o["backend"] == "gloo" and o["world"] == P
    return outs


def _state_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_myers_cols_resumed_over_chunks():
    """myers_cols resumed chunk by chunk (sizes 1, 31, 32, 1024, 1025, so
    Lt 2113 is odd) from myers_init_state equals the JAX package's
    myers_cols resumed the same way (every state word), and one
    myers_batch over the whole target (dist, tend)."""
    import jax.numpy as jnp

    from hga_tpu.ops import myers as JM

    rng = np.random.default_rng(5)
    N, Lq = 24, 100
    Lt = sum(CHUNKS)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(-1, 6, (N, Lt)).astype(np.int32)      # codes -1 .. 5
    for n in range(0, N, 3):       # plant the query across chunk edges
        off = int(rng.integers(0, Lt - Lq))
        t[n, off:off + Lq] = q[n]
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    ql[:4] = [0, 1, 31, 32]
    tl = rng.integers(1, Lt + 1, N).astype(np.int32)
    tl[4] = 33                     # tlen inside a later chunk
    W = TM.n_words(Lq)
    T = torch.from_numpy
    planes = TM.query_planes(T(q), T(ql), W)
    jplanes = JM.query_planes(jnp.asarray(q), jnp.asarray(ql), W)
    st = TM.myers_init_state(T(ql), W)
    jst = JM.myers_init_state(jnp.asarray(ql), W)
    _state_equal(st, jst)
    j0 = 0
    for c in CHUNKS:
        st = TM.myers_cols(*planes, T(t[:, j0:j0 + c]), T(tl), st, j0=j0)
        jst = JM.myers_cols(*jplanes, jnp.asarray(t[:, j0:j0 + c]),
                            jnp.asarray(tl), jst, j0=j0)
        _state_equal(st, jst)
        j0 += c
    one = TM.myers_batch(T(q), T(t), T(ql), T(tl))
    res = TM.state_result(T(ql), st)
    assert torch.equal(res.dist, one.dist) and torch.equal(res.tend,
                                                           one.tend)
    # the wrapper's CPU path is that plain version, state packed and back
    st2, res2 = TMC.myers_cols_cuda(T(q), T(t), T(ql), T(tl),
                                    TM.myers_init_state(T(ql), W))
    _state_equal(st2, st)
    assert torch.equal(res2.dist, one.dist)
    _state_equal(TM.unpack_state(TM.pack_state(st), W), st)


def test_myers_cols_shared_row_and_checks():
    """A one-row target runs every query against that row (resumed ==
    broadcast rows), and the wrapper rejects a state of the wrong shape
    or a negative j0."""
    rng = np.random.default_rng(6)
    N, Lq, Lt = 12, 40, 300
    T = torch.from_numpy
    q = T(rng.integers(0, 4, (N, Lq)).astype(np.int32))
    t1 = T(rng.integers(0, 4, (1, Lt)).astype(np.int32))
    ql = T(rng.integers(0, Lq + 1, N).astype(np.int32))
    tl = torch.full((N,), Lt - 5, dtype=torch.int32)
    W = TM.n_words(Lq)
    st = TM.myers_init_state(ql, W)
    for j0 in range(0, Lt, 100):
        st, res = TMC.myers_cols_cuda(q, t1[:, j0:j0 + 100].contiguous(), ql,
                                      tl, st, j0=j0)
    ref = TM.myers_batch(q, t1.expand(N, Lt).contiguous(), ql, tl)
    assert torch.equal(res.dist, ref.dist) and torch.equal(res.tend,
                                                           ref.tend)
    with pytest.raises(ValueError, match="state"):
        TMC.myers_cols_cuda(q, t1, ql, tl, TM.myers_init_state(ql, W + 1))
    with pytest.raises(ValueError, match="j0"):
        TMC.myers_cols_cuda(q, t1, ql, tl, TM.myers_init_state(ql, W), -1)


@pytest.mark.parametrize("P,bpd,shared", RINGS)
def test_myers_ring_matches_jax(ranks, P, bpd, shared):
    """The port's ring on P ranks == the JAX ring on a P-device mesh == one
    myers_batch over the whole target, on every rank."""
    import jax
    import jax.numpy as jnp

    from hga_tpu.parallel.mesh import make_mesh
    from hga_tpu.parallel.ring_myers import myers_ring

    q, t, ql, tl = _ring_inputs(P, bpd, shared)
    mesh = make_mesh(devices=jax.devices()[:P])
    j = myers_ring(mesh, *(jnp.asarray(x) for x in (q, t, ql, tl)),
                   blocks_per_dev=bpd)
    T = torch.from_numpy
    one = TM.myers_batch(T(q), T(t) if not shared else
                         T(np.ascontiguousarray(np.broadcast_to(
                             t, (q.shape[0], t.shape[1])))), T(ql), T(tl))
    for o in _ranks(ranks, P):
        dist, tend = o[f"{bpd}{shared}"]
        assert dist == np.asarray(j.dist).tolist() == one.dist.tolist()
        assert tend == np.asarray(j.tend).tolist() == one.tend.tolist()


def test_myers_ring_rejects_bad_shapes():
    """The JAX package's divisibility rules (N over B blocks, Lt over P)
    and target rows, on a mesh of one."""
    from hga_tpu_torch.parallel.mesh import Mesh
    from hga_tpu_torch.parallel.ring_myers import myers_ring

    q = torch.zeros((6, 10), dtype=torch.int32)
    ql = torch.full((6,), 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="must divide"):
        myers_ring(Mesh(1, 0), q, torch.zeros((6, 8), dtype=torch.int32),
                   ql, ql, blocks_per_dev=4)
    with pytest.raises(ValueError, match="rows"):
        myers_ring(Mesh(1, 0), q, torch.zeros((3, 8), dtype=torch.int32),
                   ql, ql)
    # a mesh of one is the one-device engine
    q, t, qln, tln = (torch.from_numpy(x) for x in
                      _ring_inputs(1, 2, False))
    r = myers_ring(Mesh(1, 0), q, t, qln, tln)
    ref = TM.myers_batch(q, t, qln, tln)
    assert torch.equal(r.dist, ref.dist) and torch.equal(r.tend, ref.tend)


def test_segment_identity_ring(ranks):
    """segment_identity through the ring on 4 ranks == the JAX package's on
    a 4-device mesh == one rank (the shared-target sweep); a perfect contig
    scores 1."""
    import jax

    from hga_tpu.parallel.mesh import make_mesh
    from hga_tpu.utils import evalx as JE
    from hga_tpu_torch.utils import evalx as TE

    genome, contigs = _genome_contigs()
    j = JE.segment_identity(contigs, genome, seg=96,
                            mesh=make_mesh(devices=jax.devices()[:4]))
    one = TE.segment_identity(contigs, genome, seg=96, device="cpu")
    assert one == j
    assert j["segment_dist"] > 0
    for o in _ranks(ranks, 4):
        assert o["seg"] == j
        assert o["perfect"]["segment_identity"] == 1.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_carry_mode_matches_plain(cuda):
    """K1''s carried-state mode == myers_cols, bit-exact, per pair (W 14)
    and on a shared row (W 13), chained over chunks of 1, 31, 32, 1024 and
    1025 columns, with qlen 0/1/31/32 and codes -1, 4, 9."""
    rng = np.random.default_rng(8)
    for N, Lq, rows in ((256, 414, None), (96, 384, 1)):
        Lt = sum(CHUNKS)
        q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
        t = rng.choice([-1, 0, 1, 2, 3, 4, 9], (rows or N, Lt)).astype(
            np.int32)
        ql = rng.integers(0, Lq + 1, N).astype(np.int32)
        ql[:4] = [0, 1, 31, 32]
        tl = rng.integers(1, Lt + 1, N).astype(np.int32)
        W = TM.n_words(Lq)
        host = [torch.from_numpy(x) for x in (q, t, ql, tl)]
        dev = [x.to(cuda) for x in host]
        st_h = TM.myers_init_state(host[2], W)
        st_d = TM.myers_init_state(dev[2], W)
        j0 = 0
        before = TMC.LAUNCHES["myers_batch_cuda_carry"]
        for c in CHUNKS:
            cut = lambda x: x[:, j0:j0 + c].contiguous()
            st_h, r_h = TMC.myers_cols_cuda(host[0], cut(host[1]), host[2],
                                            host[3], st_h, j0)
            st_d, r_d = TMC.myers_cols_cuda(dev[0], cut(dev[1]), dev[2],
                                            dev[3], st_d, j0)
            _state_equal([x.cpu() for x in st_d], st_h)
            j0 += c
        assert torch.equal(r_d.dist.cpu(), r_h.dist)
        assert torch.equal(r_d.tend.cpu(), r_h.tend)
        assert TMC.LAUNCHES["myers_batch_cuda_carry"] == before + len(CHUNKS)
