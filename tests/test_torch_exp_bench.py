"""The port's scale_run helpers (the read model, the judged config, the
split reconciliation), count_scale and bench_corr_tb (hga_tpu_torch.exp)
against the JAX package's scripts of exp/ on the CPU."""

import json
import re

import numpy as np
import torch

from torch_exp_common import (_one_torch_thread, jax_main,  # noqa: F401
                              port_main)


def test_scale_run_read_model_and_config_match_jax():
    """simulate() and judged_cfg(), which chip_smoke.py takes, hold the
    JAX script's read model and config."""
    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import pack_reads
    from hga_tpu.utils import sim
    from hga_tpu_torch.exp import scale_run as SR

    G = 12_000
    for repeats, circular in ((False, False), (True, True)):
        genome, pr_s, pr_l = SR.simulate(G, 42, repeats=repeats,
                                         circular=circular)
        jg = (sim.repeat_genome(G, seed=42) if repeats
              else sim.random_genome(G, seed=42))
        ss, sn = sim.simulate_short_reads(jg, coverage=30.0, read_len=100,
                                          error_rate=0.01, seed=43,
                                          circular=circular)
        ls, ln = sim.simulate_long_reads(jg, coverage=20.0, mean_len=8000,
                                         min_len=1000, error_rate=0.10,
                                         seed=44, circular=circular)
        js = pack_reads(ss, names=sn, pad_len=112)
        pad_l = ((max(len(s) for s in ls) + 31) // 32) * 32
        jl = pack_reads(ls, names=ln, category=[1] * len(ls), pad_len=pad_l)
        assert genome == jg
        for a, b in ((pr_s, js), (pr_l, jl)):
            assert a.pad_len == b.pad_len and list(a.names) == list(b.names)
            np.testing.assert_array_equal(a.packed, b.packed)
            np.testing.assert_array_equal(a.length, b.length)
    for passes in (1, 2):
        want = AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                               min_shared_minimizers=2, min_overlap_len=500,
                               min_identity=0.75, polish_passes=2,
                               corr_passes=passes, corr_batch_pairs=4096,
                               min_contig_len=2000)
        assert SR.judged_cfg(passes).to_json() == want.to_json()


def test_scale_run_reconciliation_warns_as_the_script_does():
    from hga_tpu_torch.exp import scale_run as SR

    stages = {"corrected": {"seconds": 10.0}, "polish": {"seconds": 4.0}}
    splits = {"correction_split": {"loop_s": 9.0, "shared_index_s": 1.0},
              "polish_split": {"cand_s": 5.0, "loop_s": 4.0},
              "arbitrate_split": {}, "overlap_split": {}}
    recon, warnings = SR.reconcile(stages, splits)
    assert recon == {"corrected": {"stage_s": 10.0, "split_sum_s": 10.0},
                     "polish": {"stage_s": 4.0, "split_sum_s": 9.0}}
    # 0.5 * 9 > 4 * 1.05: the polish split does not reconcile
    assert warnings == ["WARNING: polish split 9s does not reconcile with "
                        "stage 4s"]


def test_count_scale_matches_jax(tmp_path):
    out = {k: str(tmp_path / f"{k}.json") for k in ("jax", "port")}
    jax_main("count_scale", ["0.02", out["jax"]])
    got = port_main("count_scale", ["0.02", out["port"]])
    j = json.load(open(out["jax"]))
    t = json.load(open(out["port"]))
    assert t == got and list(t) == list(j)
    timed = ("seconds_warm", "seconds_first", "reads_per_s", "kmers_per_s")
    assert {k: v for k, v in t.items() if k not in timed} == \
        {k: v for k, v in j.items() if k not in timed}
    assert t["distinct_kmers"] > t["genome_kmers_expected"]


def test_bench_corr_tb_vote_buffers_agree(capsys):
    """At a small P on the CPU: the three lines, no random pair gated (as
    in the JAX script), and on planted pairs the vote buffer of the K2
    planes' traceback == K2' unbounded == K2' bounded == the JAX package's
    accumulate_backbone_votes_myers on its own planes DP."""
    import jax.numpy as jnp

    from hga_tpu.models.correction import _planes_inner
    from hga_tpu.ops import pileup as JPU
    from hga_tpu_torch.exp import bench_corr_tb as B

    capsys.readouterr()
    out = port_main("bench_corr_tb", ["64", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "dp_only", "fused_full_S", "fused_bounded"]
    assert all(re.fullmatch(r"\w+: [0-9.]+ ms/batch = [0-9,]+ aln/s", ln)
               for ln in lines)
    assert out["gated"] == 0 and out["planted_gated"] == 64
    m = out["merged"]
    assert int(m["dp_only"][:-1].sum()) > 64 * 100
    assert torch.equal(m["dp_only"], m["fused_full_S"])
    assert torch.equal(m["dp_only"], m["fused_bounded"])

    (q, t, ql, tl, bb, off, lb), size_v = B.inputs(64, torch.device("cpu"))
    qp = B.planted(q, t)
    J = lambda x: jnp.asarray(x.numpy())
    r, pv, mv = _planes_inner()(J(qp), J(t), J(ql), J(tl))
    ok = (r.dist <= B.MAX_ED) & (r.tend > 0)
    merged = jnp.zeros((m["dp_only"].shape[0] - 1,), jnp.int32)
    got = JPU.accumulate_backbone_votes_myers(
        merged, pv, mv, r.dist, jnp.where(ok, J(ql), 0), r.tend, J(qp),
        J(t), J(bb), J(off), J(lb), size_v=size_v, lpad=B.LPAD,
        ins_slots=B.INS_SLOTS, max_steps=B.LQ + B.MAX_ED + 2)
    np.testing.assert_array_equal(np.asarray(got),
                                  m["fused_bounded"][:-1].numpy())


