"""The port's distribution layer (hga_tpu_torch.parallel) against the JAX
package's (hga_tpu.parallel): the k-mer collectives at P = 2 and 4 ranks
(gloo on the CPU, one process a rank, started by parallel/launch.py)
against the JAX functions on a P-device mesh of the 8-device test mesh;
block_range, the ragged gathers, shard_batch_fn, the comm volume model and
the backend rule.

This module imports no JAX at its top: the rank processes import it to run
the `_w_*` workers, and each asserts that neither jax nor hga_tpu loaded.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from hga_tpu_torch.parallel import hostpart as HP
from hga_tpu_torch.parallel import mesh as TM
from hga_tpu_torch.parallel.launch import launch

HERE = os.path.dirname(os.path.abspath(__file__))
K_ = 21
CAP_SMALL = 8           # a lane capacity that must overflow


def run_ranks(target, P, outdir, **kw):
    """`target` of this module in P gloo CPU rank processes."""
    outs = launch(f"test_torch_parallel:{target}", P, str(outdir), kw,
                  threads=1, pythonpath=[HERE], timeout=300)
    for o in outs:
        assert not o["jax_loaded"] and not o["hga_tpu_loaded"], o
        assert o["backend"] == "gloo" and o["world"] == P
    return outs


# ---------------------------------------------------------------- workers

def _block(x, P, r):
    n = x.shape[0] // P
    return x[r * n:(r + 1) * n]


def _w_collectives(data: str, out: str):
    """Every collective on this rank's block of the reads; arrays to
    out/<rank>.npz."""
    from hga_tpu_torch.ops import count as C
    from hga_tpu_torch.ops import kmer as K
    from hga_tpu_torch.parallel import collectives as PC

    z = np.load(data)
    mesh = TM.make_mesh()
    P, r = mesh.size, mesh.rank
    packed = K.words_to_tensor(_block(z["packed"], P, r), "cpu")
    bad = K.words_to_tensor(_block(z["bad"], P, r), "cpu")
    length = torch.from_numpy(_block(z["length"], P, r))
    res = {}
    cap = int(z["shard_cap"])
    ck = PC.count_kmers_sharded(mesh, packed, bad, length, K_, cap)
    res.update(sh_hi=ck.hi, sh_lo=ck.lo, sh_count=ck.count, sh_n=ck.n)
    res["sh_hist"] = PC.spectrum_hist_sharded(mesh, packed, bad, length, K_,
                                              cap, 8)
    bcap = int(z["bucket_cap"])
    ck, ovf = PC.count_kmers_bucketed(mesh, packed, bad, length, K_, bcap)
    res.update(bk_hi=ck.hi, bk_lo=ck.lo, bk_count=ck.count, bk_n=ck.n,
               bk_ovf=ovf)
    hist, ovf = PC.spectrum_hist_bucketed(mesh, packed, bad, length, K_,
                                          bcap, 8)
    res.update(bk_hist=hist, bk_hist_ovf=ovf)
    _, ovf = PC.count_kmers_bucketed(mesh, packed, bad, length, K_,
                                     CAP_SMALL)
    res["bk_small_ovf"] = ovf
    kb = K.extract_kmers(packed, bad, length, K_)
    hi = torch.where(kb.valid, kb.hi, C.SENTINEL).reshape(-1)
    lo = torch.where(kb.valid, kb.lo, C.SENTINEL).reshape(-1)
    rh, rl, ovf = PC.route_by_bucket(mesh, hi, lo, bcap)
    res.update(rt_hi=rh, rt_lo=rl, rt_ovf=ovf)
    _, _, ovf = PC.route_by_bucket(mesh, hi, lo, CAP_SMALL)
    res["rt_small_ovf"] = ovf
    np.savez(os.path.join(out, f"{r}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    return {}


def _w_gathers():
    """Ragged host gathers: rank r holds COUNTS[r] rows (zero on some),
    then zero rows everywhere."""
    r, P = HP.pid(), HP.nproc()
    n = _ragged(P)[r]
    a = {"i": np.arange(n, dtype=np.int64) + 100 * r,
         "u": np.full(n, r, np.uint32),
         "f": np.full((n, 3), r + 0.5, np.float32),
         "b": np.arange(n) % 2 == 0}
    g = HP.allgather_concat(a)
    zero = HP.allgather_concat({"x": np.zeros((0, 2), np.int32)})
    idx, seqs = HP.allgather_indexed_strings(
        list(range(10 * r, 10 * r + n)), ["ACGT"[r % 4] * (i + r)
                                          for i in range(n)])
    e_idx, e_seqs = HP.allgather_indexed_strings([], [])
    return dict(i=g["i"].tolist(), u=g["u"].tolist(),
                u_dtype=str(g["u"].dtype), f=g["f"].tolist(),
                b=g["b"].tolist(), zero=list(zero["x"].shape),
                idx=idx.tolist(), seqs=seqs, e_idx=e_idx.tolist(),
                e_seqs=e_seqs, block=list(HP.block_range(11)))


def _w_shard_batch(Ns):
    """shard_batch_fn over a plain Myers batch: rows each rank ran, and the
    output against the unsplit run."""
    from hga_tpu_torch.ops.myers import MyersResult, myers_batch

    seen = []

    def inner(q, t, ql, tl):
        seen.append(int(q.shape[0]))
        return myers_batch(q, t, ql, tl)

    f = TM.shard_batch_fn(TM.make_mesh(), inner, 4, MyersResult)
    g = TM.shard_batch_fn(TM.make_mesh(), lambda *a: inner(*a).dist, 4)
    ok = []
    for N in Ns:
        q, t, ql, tl = (torch.from_numpy(x) for x in _myers_inputs(N))
        ref = myers_batch(q, t, ql, tl)
        got = f(q, t, ql, tl)
        ok.append(bool(torch.equal(got.dist, ref.dist)
                       and torch.equal(got.tend, ref.tend)
                       and torch.equal(g(q, t, ql, tl), ref.dist)))
    return dict(seen=seen, ok=ok)


def _ragged(P):
    return [0, 3, 0, 5][:P] if P <= 4 else [0] * P


def _myers_inputs(N, Lq=40, Lt=64, seed=9):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    tl = np.full(N, Lt, np.int32)
    return q, t, ql, tl


# ---------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """test_parallel.py's data set: 3 kb genome, 8x short reads (pad 112),
    a multiple of 8 reads; packed with the port, saved for the ranks."""
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.utils.sim import make_dataset

    ds = make_dataset(genome_len=3000, short_cov=8, long_cov=0, seed=4)
    seqs = ds.short_seqs[: len(ds.short_seqs) // 8 * 8]
    pr = pack_reads(seqs, pad_len=112)
    root = tmp_path_factory.mktemp("coll")
    R = pr.n_reads
    m = 112 - K_ + 1
    path = str(root / "reads.npz")
    np.savez(path, packed=pr.packed, bad=pr.bad, length=pr.length,
             shard_cap=R * m // 2 + 100, bucket_cap=R * m // 4 + 64)
    return dict(pr=pr, path=path, root=root, shard_cap=R * m // 2 + 100,
                bucket_cap=R * m // 4 + 64)


@pytest.fixture(scope="module", params=[2, 4])
def coll(request, reads):
    """The port's P ranks and the JAX package's P-device mesh on the same
    reads."""
    import jax
    import jax.numpy as jnp

    from hga_tpu.ops import count as JC
    from hga_tpu.ops import kmer as JK
    from hga_tpu.parallel import collectives as JPC
    from hga_tpu.parallel.mesh import make_mesh

    P = request.param
    out = reads["root"] / f"p{P}"
    out.mkdir()
    # the ranks run while this process runs the JAX side
    ranks_done = concurrent.futures.ThreadPoolExecutor(1).submit(
        run_ranks, "_w_collectives", P, out, data=reads["path"],
        out=str(out))
    pr = reads["pr"]
    mesh = make_mesh(devices=jax.devices()[:P])
    args = (jnp.asarray(pr.packed), jnp.asarray(pr.bad),
            jnp.asarray(pr.length))
    j = {}
    ck = JPC.count_kmers_sharded(mesh, *args, K_, reads["shard_cap"])
    j["sh"] = ck
    # spectrum_hist_sharded's histogram of the same counts (one shard_map
    # compile less); the JAX tests hold spectrum_hist_bucketed to it
    j["hist"] = np.asarray(JC.spectrum_histogram(ck, 8))
    j["bk"], j["bk_ovf"] = JPC.count_kmers_bucketed(mesh, *args, K_,
                                                    reads["bucket_cap"])
    kb = JK.extract_kmers(*args, K_)
    hi = jnp.where(kb.valid, kb.hi, JC.SENTINEL).ravel()
    lo = jnp.where(kb.valid, kb.lo, JC.SENTINEL).ravel()
    j["rt_hi"], j["rt_lo"], j["rt_ovf"] = JPC.route_by_bucket(
        mesh, hi, lo, reads["bucket_cap"])
    _, _, j["rt_small_ovf"] = JPC.route_by_bucket(mesh, hi, lo, CAP_SMALL)
    ranks_done.result()
    ranks = [dict(np.load(out / f"{r}.npz")) for r in range(P)]
    return P, ranks, j


def _u32(x):
    return np.asarray(x).astype(np.uint64)


def test_count_kmers_sharded(coll):
    """Every rank holds the exact global multiset, equal to the JAX
    mesh's replicated result (hi, lo, count arrays and n)."""
    P, ranks, j = coll
    for r in ranks:
        np.testing.assert_array_equal(_u32(r["sh_hi"]), _u32(j["sh"].hi))
        np.testing.assert_array_equal(_u32(r["sh_lo"]), _u32(j["sh"].lo))
        np.testing.assert_array_equal(r["sh_count"], np.asarray(j["sh"].count))
        assert int(r["sh_n"]) == int(j["sh"].n) > 0


def test_spectrum_hists(coll):
    """Both global histograms (spectrum_hist_sharded and _bucketed),
    replicated on every rank, equal the JAX mesh's exact histogram."""
    P, ranks, j = coll
    for r in ranks:
        np.testing.assert_array_equal(r["sh_hist"], j["hist"])
        np.testing.assert_array_equal(r["bk_hist"], j["hist"])
        assert int(r["bk_hist_ovf"]) == 0


def test_count_kmers_bucketed(coll):
    """Rank s's owned counts equal shard s of the JAX mesh's sharded
    output, array for array; n is each shard's distinct count."""
    P, ranks, j = coll
    ck = j["bk"]
    seg = np.asarray(ck.hi).shape[0] // P
    for s, r in enumerate(ranks):
        sl = slice(s * seg, (s + 1) * seg)
        np.testing.assert_array_equal(_u32(r["bk_hi"]), _u32(ck.hi)[sl])
        np.testing.assert_array_equal(_u32(r["bk_lo"]), _u32(ck.lo)[sl])
        np.testing.assert_array_equal(r["bk_count"], np.asarray(ck.count)[sl])
        assert int(r["bk_n"]) == int(np.asarray(ck.n)[s])
        assert int(r["bk_ovf"]) == int(j["bk_ovf"]) == 0


def test_route_by_bucket(coll):
    """Each shard receives the same multiset of k-mers as JAX's shard (the
    JAX side's sort is not stable, so lane order may differ), every one
    owned by it (kmer_hash32 % P == shard)."""
    from hga_tpu_torch.ops import kmer as K

    P, ranks, j = coll
    jh, jl = _u32(j["rt_hi"]), _u32(j["rt_lo"])
    seg = jh.shape[0] // P
    S = np.uint64(0xFFFFFFFF)
    for s, r in enumerate(ranks):
        th, tl = _u32(r["rt_hi"]), _u32(r["rt_lo"])
        assert th.shape[0] == seg
        mine = (th << np.uint64(32)) | tl
        mine = np.sort(mine[~((th == S) & (tl == S))])
        jh_s, jl_s = jh[s * seg:(s + 1) * seg], jl[s * seg:(s + 1) * seg]
        theirs = (jh_s << np.uint64(32)) | jl_s
        theirs = np.sort(theirs[~((jh_s == S) & (jl_s == S))])
        np.testing.assert_array_equal(mine, theirs)
        h = K.kmer_hash32(torch.from_numpy((mine >> np.uint64(32)).astype(
            np.int64)), torch.from_numpy((mine & S).astype(np.int64)))
        assert bool((h % P == s).all())
        assert int(r["rt_ovf"]) == int(j["rt_ovf"]) == 0


def test_overflow_detected(coll):
    """At a lane capacity of 8 the routing overflows, by JAX's count (the
    sum over lanes of what did not fit), on every rank; the bucketed count
    routes the same k-mers and reports the same overflow."""
    P, ranks, j = coll
    for r in ranks:
        assert int(r["rt_small_ovf"]) == int(j["rt_small_ovf"]) > 0
        assert int(r["bk_small_ovf"]) == int(j["rt_small_ovf"])


@pytest.mark.parametrize("P", range(1, 9))
def test_block_range(P, monkeypatch):
    """block_range for every rank of P and n 0..50: JAX's arithmetic,
    contiguous, covering, sizes within 1."""
    import jax

    from hga_tpu.parallel import hostpart as JHP

    monkeypatch.setattr(HP, "nproc", lambda: P)
    monkeypatch.setattr(jax, "process_count", lambda: P)
    for n in range(51):
        blocks = []
        for p in range(P):
            monkeypatch.setattr(HP, "pid", lambda p=p: p)
            monkeypatch.setattr(jax, "process_index", lambda p=p: p)
            blocks.append(HP.block_range(n))
            assert blocks[-1] == JHP.block_range(n)
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        sizes = [hi - lo for lo, hi in blocks]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("P", [2, 4])
def test_allgather_ragged(P, tmp_path):
    """allgather_concat and allgather_indexed_strings with ranks holding
    zero rows, and with every rank holding zero: rank order, dtypes and
    trailing shapes kept."""
    outs = run_ranks("_w_gathers", P, tmp_path)
    counts = _ragged(P)
    want_i = [i + 100 * r for r in range(P) for i in range(counts[r])]
    want_idx = [i for r in range(P) for i in range(10 * r, 10 * r + counts[r])]
    want_seqs = ["ACGT"[r % 4] * (i + r) for r in range(P)
                 for i in range(counts[r])]
    for r, o in enumerate(outs):
        assert o["i"] == want_i
        assert o["u"] == [r2 for r2 in range(P) for _ in range(counts[r2])]
        assert o["u_dtype"] == "uint32"
        assert o["f"] == [[r2 + 0.5] * 3 for r2 in range(P)
                          for _ in range(counts[r2])]
        assert o["b"] == [i % 2 == 0 for r2 in range(P)
                          for i in range(counts[r2])]
        assert o["zero"] == [0, 2]
        assert o["idx"] == want_idx and o["seqs"] == want_seqs
        assert o["e_idx"] == [] and o["e_seqs"] == []
        lo = r * (11 // P) + min(r, 11 % P)
        assert o["block"] == [lo, lo + 11 // P + (r < 11 % P)]


@pytest.mark.parametrize("P", [2, 4])
def test_shard_batch_fn(P, tmp_path):
    """A batch divisible by P runs in P blocks of N / P rows, one a rank;
    one that is not runs whole on every rank; both equal the unsplit run,
    for a NamedTuple output and for a single tensor."""
    Ns = [4 * P, 4 * P + 1]
    outs = run_ranks("_w_shard_batch", P, tmp_path, Ns=Ns)
    for o in outs:
        assert o["ok"] == [True, True]
        # per N, the NamedTuple call and the tensor call
        assert o["seen"] == [4, 4, 4 * P + 1, 4 * P + 1]


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_comm_volume_model(n_hosts):
    """The same dict as the JAX package's model, exactly."""
    from hga_tpu.utils.benchmarks import comm_volume_model as jmodel
    from hga_tpu_torch.utils.benchmarks import comm_volume_model

    assert comm_volume_model(n_hosts=n_hosts) == jmodel(n_hosts=n_hosts)
    assert comm_volume_model(n_hosts=n_hosts, n_overlaps=7, k=15) == \
        jmodel(n_hosts=n_hosts, n_overlaps=7, k=15)


def test_backend_rule(monkeypatch):
    """nccl only for CUDA ranks with a card each on the node; gloo for CPU
    ranks and for ranks sharing a card; a forbidden name raises before any
    process group starts; no world without WORLD_SIZE."""
    assert TM.backend_rule("cuda", 1, 1) == "nccl"
    assert TM.backend_rule("cuda", 4, 4) == "nccl"
    assert TM.backend_rule("cuda", 2, 1) == "gloo"
    assert TM.backend_rule("cpu", 2, 0) == "gloo"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert TM.init_distributed(device="cpu") is None
    assert TM.make_mesh() == TM.Mesh(size=1, rank=0)
    assert TM.auto_mesh() is None
    assert HP.nproc() == 1 and HP.block_range(5) == (0, 5)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="not allowed"):
        TM.init_distributed("nccl", device="cpu")
    with pytest.raises(ValueError, match="not allowed"):
        TM.init_distributed("mpi", device="cpu")
    assert not torch.distributed.is_initialized()


def test_pad_to_multiple():
    from hga_tpu.parallel.mesh import pad_to_multiple as jpad

    for n in range(20):
        for m in range(1, 6):
            assert TM.pad_to_multiple(n, m) == jpad(n, m)
