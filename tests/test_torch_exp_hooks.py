"""The diagnostics hooks of the port, models/overlap_long._CAND_DEBUG
(read by exp/diag_leak) and models/correction._DEBUG_SINK (read by
exp/diag_polish_votes), against the JAX package's on a 20 kb
sim.repeat_genome: the same arrays, and the same results with a hook on
and off."""

import numpy as np
import pytest

from torch_exp_common import _one_torch_thread  # noqa: F401

REP_KB = "20"


@pytest.fixture(scope="module")
def repeat_inputs():
    """The diagnostics' inputs on both packages (the same simulated reads
    packed by each): the genome, then (short reads, long reads, the derived
    config, the solid set, the seed index) of the port and of JAX."""
    from hga_tpu.config import AssemblerConfig as JCfg
    from hga_tpu.io.encode import pack_reads as jpack
    from hga_tpu.models.overlap_long import build_seed_index as jindex
    from hga_tpu.models.spectrum import count_reads as jcount
    from hga_tpu_torch.exp import diag_repeat_corr as TD
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.models.overlap_long import build_seed_index
    from hga_tpu_torch.models.spectrum import count_reads
    from hga_tpu_torch.utils import sim

    genome = sim.repeat_genome(int(REP_KB) * 1000, seed=42)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0, read_len=100,
                                      error_rate=0.01, seed=43)
    ls, ln = sim.simulate_long_reads(genome, coverage=20.0, mean_len=8000,
                                     min_len=1000, error_rate=0.10, seed=44)
    pad_l = ((max(len(s) for s in ls) + 31) // 32) * 32
    cfg0 = TD.base_cfg()
    out = []
    for pack, count, index, device in (
            (pack_reads, count_reads, build_seed_index, {"device": "cpu"}),
            (jpack, jcount, jindex, {})):
        pr_s = pack(ss, names=sn, pad_len=112)
        pr_l = pack(ls, names=ln, category=[1] * len(ls), pad_len=pad_l)
        c0 = cfg0 if device else JCfg.from_json(cfg0.to_json())
        spec = count(pr_s, c0, **device)
        cfg, _ = TD.derive(c0, spec, float(pr_s.length.mean()))
        solid = spec.solid_set()
        out.append((pr_s, pr_l, cfg, solid,
                    index(pr_s, cfg, solid=solid, **device)))
    return genome, out[0], out[1]


def test_cand_debug_hook_matches_jax(repeat_inputs):
    """_CAND_DEBUG's four arrays equal the JAX hook's, and the candidates
    are the same with the hook on and off (and the JAX package's)."""
    import hga_tpu.models.overlap_long as JOL
    from hga_tpu_torch.models import overlap_long as OL

    _, (pr_s, pr_l, cfg, solid, idx), (js, jl, jcfg, jsolid, jidx) = \
        repeat_inputs
    kw = dict(depth_cap=cfg.corr_depth_cap, rare_cap=cfg.corr_rare_seed_freq,
              anchor_min=cfg.corr_anchor_min)
    off = OL.find_candidates_cross_indexed(pr_s, pr_l, cfg, solid=solid,
                                           index=idx, device="cpu", **kw)
    OL._CAND_DEBUG = {}
    try:
        on = OL.find_candidates_cross_indexed(pr_s, pr_l, cfg, solid=solid,
                                              index=idx, device="cpu", **kw)
        dbg = {k: np.concatenate(v) for k, v in OL._CAND_DEBUG.items()}
    finally:
        OL._CAND_DEBUG = None
    JOL._CAND_DEBUG = {}
    try:
        jon = JOL.find_candidates_cross_indexed(js, jl, jcfg, solid=jsolid,
                                                index=jidx, **kw)
        jdbg = {k: np.concatenate(v) for k, v in JOL._CAND_DEBUG.items()}
    finally:
        JOL._CAND_DEBUG = None
    for a, b, c in zip(off, on, jon):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert sorted(dbg) == sorted(jdbg) == ["A", "cnt", "min_comb",
                                           "rare_cnt"]
    for k in dbg:
        assert dbg[k].shape == (len(on[0]),)
        np.testing.assert_array_equal(dbg[k], jdbg[k], err_msg=k)
    # without rare_cap the hook records nothing, as the reference's
    OL._CAND_DEBUG = {}
    try:
        OL.find_candidates_cross_indexed(pr_s, pr_l, cfg, solid=solid,
                                         index=idx, device="cpu",
                                         depth_cap=cfg.corr_depth_cap)
        assert OL._CAND_DEBUG == {}
    finally:
        OL._CAND_DEBUG = None


def test_debug_sink_hook_matches_jax(repeat_inputs):
    """_DEBUG_SINK's vote tensors equal the JAX hook's, and polish gives the
    same contig with the hook on and off (candidates through the shared
    solid-seed index, as the pipeline's polish takes them)."""
    import hga_tpu.models.correction as JMC
    from hga_tpu_torch.models import correction as MC

    genome, (pr_s, _, cfg, solid, idx), (js, _, jcfg, jsolid, jidx) = \
        repeat_inputs
    rng = np.random.default_rng(11)
    s0 = int(rng.integers(0, len(genome) - 6000))
    contig = [("c0", genome[s0:s0 + 6000])]
    kw = dict(solid=solid, seed_index=idx, device="cpu")
    off = MC.polish_contigs(contig, pr_s, cfg, **kw)
    MC._DEBUG_SINK = {}
    try:
        on = MC.polish_contigs(contig, pr_s, cfg, **kw)
        sink = dict(MC._DEBUG_SINK)
    finally:
        MC._DEBUG_SINK = None
    JMC._DEBUG_SINK = {}
    try:
        jon = JMC.polish_contigs(contig, js, jcfg, solid=jsolid,
                                 seed_index=jidx)
        jsink = dict(JMC._DEBUG_SINK)
    finally:
        JMC._DEBUG_SINK = None
    assert on == off == jon
    assert sorted(sink) == sorted(jsink) == ["ins_votes", "votes"]
    for k in sink:
        assert sink[k].dtype == jsink[k].dtype
        np.testing.assert_array_equal(sink[k], jsink[k], err_msg=k)
    assert int(sink["votes"].sum()) > 0
