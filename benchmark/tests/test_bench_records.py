"""The records cell (evalseg.kpn78578-replicons) at a cut size on the CPU:
its plain reference against a brute force, a sound run correct, the timed
path broken underneath not, the control not, and its traced metrics
on a made-up run."""

import copy
import os
import time
import types

import numpy as np
import pytest
import torch

from benchmark import control, gen, gen_records, harness
from benchmark.reference import segdist, segdist_records
from hga_tpu_torch.utils import spans

CELL = "evalseg.kpn78578-replicons"
SEG = 64
EDITS = dict(rotate=True, edit_rate=3e-3, indel_share=0.5, indel_len=[1, 3])


def _bench():
    return harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def _small(c, length=4000):
    c = copy.deepcopy(c)
    c["genome"]["length"] = length
    c["genome"]["repeats"].update(rrna_len=300, is_len=150, tandem_unit=40)
    return c


def _brute(row, segments):
    """The full DP of every segment against the whole row, a column at a
    time over all segments: D[i][0] = i, D[0][j] = 0, a code outside 0..3
    matches nothing; the least D[m][j] over the columns, and D[m][0] = m."""
    ql = np.array([len(s) for s in segments])
    M = int(ql.max())
    q = np.full((len(segments), M), -1, np.int64)
    for i, s in enumerate(segments):
        q[i, :len(s)] = s
    D = np.tile(np.arange(M + 1), (len(segments), 1))
    best = ql.copy()
    for c in np.asarray(row, np.int64):
        cost = ((q != c) | (c >= 4)).astype(np.int64)
        nd = np.empty_like(D)
        nd[:, 0] = 0
        for r in range(1, M + 1):
            nd[:, r] = np.minimum(np.minimum(D[:, r - 1] + cost[:, r - 1],
                                             D[:, r] + 1), nd[:, r - 1] + 1)
        D = nd
        best = np.minimum(best, D[np.arange(len(segments)), ql])
    return best


@pytest.mark.parametrize("seed", [11, 12])
def test_records_reference_equals_brute_force(seed):
    """Against the row written out as the configuration states it, and the
    control against the records joined."""
    spec = _small(harness.Cell(_bench(), CELL).config, 2500)["genome"]
    recs = gen_records.genome(gen.rng_for(seed, 1), spec)
    contigs = gen_records.assembly(gen.rng_for(seed, 3), recs, EDITS)
    rc = [(g, circ) for _, g, circ in recs]
    segs = [c[o:o + SEG] for c in contigs for o in range(0, len(c), SEG)]
    fwd = []
    for g, circ in rc:
        fwd += ([4] if fwd else []) + list(g) + (
            list(g[:2 * SEG - 1]) if circ else [])
    row = fwd + [4] + [4 if x == 4 else 3 - x for x in reversed(fwd)]
    assert segdist_records.row_columns(
        [(len(g), c) for g, c in rc], SEG) == len(row)
    want = _brute(row, segs)
    assert want.sum() > 0
    got = segdist_records.segment_distances(rc, contigs, SEG)
    assert np.array_equal(got, want)
    joined = segdist.two_strand_row(np.concatenate([g for g, _ in rc]))
    assert np.array_equal(segdist_records.joined_distances(rc, contigs, SEG),
                          _brute(joined, segs))


def _run(monkeypatch, edit_rate=None, seed=2**31 + 99):
    """A whole run of the cell at a cut size, past its look for a card;
    with edit_rate, the mix's assemblies carry more edits."""
    if edit_rate is not None:
        load = harness.load_json

        def more_edits(path):
            d = load(path)
            if path.endswith(os.path.join("traffic", "evalrec.json")):
                d["assembly"] = dict(d["assembly"], edit_rate=edit_rate)
            return d

        monkeypatch.setattr(harness, "load_json", more_edits)
    out, lines = harness.run_cell(_bench(), CELL, seed, 0.0, False, "cpu",
                                  time.perf_counter(), _small)
    assert out["attempted"] >= 1 and lines
    return out


def test_cut_size_run_is_correct(monkeypatch):
    out = _run(monkeypatch)
    assert out["correct"] is True
    assert out["checks"]["dist_off"]["value"] == 0


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    """Half a batch left out (the rest standing in for it), or one
    distance altered where it is produced."""
    import hga_tpu_torch.models.overlap as O

    orig = O.default_edit

    def default_edit(cfg, mesh=None, **kw):
        edit = orig(cfg, mesh, **kw)

        def broken(q, t, ql, tl):
            r = edit(q, t, ql, tl)
            dist = r.dist.clone()
            if fault == "altered":
                dist[0] += 1
            else:
                h = len(dist) // 2
                dist[h:] = torch.round(dist[:h].float().mean()).to(
                    dist.dtype)
            return r._replace(dist=dist)
        return broken

    monkeypatch.setattr(O, "default_edit", default_edit)
    out = _run(monkeypatch, edit_rate=3e-3)
    assert out["correct"] is False and out["failed"] == out["attempted"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_control_is_not_correct():
    """The records joined as one string fail the comparison on three
    seeds (each rotated contig has a segment across its origin); a sound
    run reads 0."""
    rows = []
    lower, upper, limits = control.readings(
        _bench(), CELL, [31], [41, 42, 43], device="cpu",
        config_override=_small, emit=rows.append)
    assert all(v <= limits[k] for k, v in lower.items())
    for r in rows:
        if r["kind"] == "control":
            assert any(v > limits[k] for k, v in r["readings"].items()), r


def test_metric_readers_read_a_made_up_run():
    """The cell's traced metrics: the evaluation cells' readers (K1's
    roofline from the cell's shapes, the host prep's idle, the device's
    idle) and its own reader of the bytes shipped a job."""
    def read(name, run):
        return harness.load_module("metrics", name).read(run)

    cell = harness.Cell(_bench(), CELL)
    assert [m["name"] for m in cell.metrics(True)] == [
        "evalseg.k1_roofline", "device_idle_pct.evalseg",
        "evalseg.prep_idle_ms_per_job", "evalrec.h2d_MB_per_job"]
    assert [m["name"] for m in cell.metrics(False)] == [
        "evalseg_Mbp_per_s", "setup_s"]
    shapes = dict(segments=14835, seg=384, target_cols=11399003)
    jobs = types.SimpleNamespace(shapes=lambda i: shapes)
    gaps = {"evalseg.encode_reference": 0.1, "evalseg.cut": 0.2,
            "evalseg.h2d": 0.05, "evalseg.sweep": 9.0, "aten::copy_": 3.0}
    trace = dict(jobs=2, n_ops=10, window_s=16.0, busy_s=15.0,
                 device_s=15.0, gaps_by_name=gaps)
    run = types.SimpleNamespace(
        trace=trace, jobs=jobs, device_kind="NVIDIA H100 80GB HBM3",
        window=types.SimpleNamespace(inputs=[0, 1, 0]))
    bound = 14835 * 11399003 * 12 * 20 / (132 * 64 * 1.98e9)
    assert read("evalseg.k1_roofline", run) == pytest.approx(
        100 * 2 * bound / 15.0)
    assert read("evalseg.prep_idle_ms_per_job", run) == pytest.approx(
        0.35 * 1e3 / 2)
    assert read("device_idle_pct.evalseg", run) == pytest.approx(6.25)
    spans.reset("evalseg.")
    assert read("evalrec.h2d_MB_per_job", run) is None    # no call counted
    spans.count("evalseg.calls", 3)
    spans.count("evalseg.h2d_bytes", 3 * 68_400_000)
    assert read("evalrec.h2d_MB_per_job", run) == pytest.approx(68.4)
    spans.reset("evalseg.")
