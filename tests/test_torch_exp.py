"""The port's judged-scale scripts (hga_tpu_torch.exp) against the JAX
package's scripts of exp/ at a small size: scale_run at 0.02 Mb (the
artifacts byte for byte, the evaluation and the stats' keys), then
reoverlap, polish_retry, asm_sweep, diag_false_ov and diag_graph on the two
run directories it made (their outputs equal, the seconds left out).
Each script's main() runs with its arguments as ``python -m`` gives them
(tests/torch_exp_common.py)."""

import json
import os
import shutil

import pytest

from torch_exp_common import (_one_torch_thread, jax_main,  # noqa: F401
                              port_main, untimed)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GMB = "0.02"
ARTIFACTS = ("corrected.npz", "overlaps.npz", "spectrum.npz",
             "contigs.fasta", "arbitrated.fasta", "polished.fasta")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """scale_run 0.02 Mb by both packages: {"jax": dir, "port": dir}."""
    root = tmp_path_factory.mktemp("scale")
    dirs = {"jax": str(root / "jax"), "port": str(root / "port")}
    jax_main("scale_run", [GMB, dirs["jax"]])
    port_main("scale_run", [GMB, dirs["port"]])
    return dirs


def test_scale_run_matches_jax(runs):
    got = {k: json.load(open(os.path.join(d, "scale_metrics.json")))
           for k, d in runs.items()}
    j, t = got["jax"], got["port"]
    assert list(t) == list(j)
    for key in ("genome_mb", "repeats", "circular", "n_short", "n_long",
                "eval", "assembly", "derived"):
        assert t[key] == j[key], key
    assert j["eval"]["identity"] > 0.99
    assert list(t["stages"]) == list(j["stages"])
    # the splits carry the same keys (the port's LAST_TIMINGS under the
    # reference's names), and the same counts
    for key in ("correction_split", "polish_split", "arbitrate_split",
                "overlap_split", "split_reconciliation"):
        assert sorted(t[key]) == sorted(j[key]), key
    for key in ("n_pairs", "n_batches", "bytes_up"):
        assert t["correction_split"][key] == j["correction_split"][key]
        assert t["polish_split"][key] == j["polish_split"][key]
    assert t["arbitrate_split"]["n_chunks"] == j["arbitrate_split"][
        "n_chunks"]
    for key in ("n_anchors", "n_pairs", "n_segments"):
        assert t["overlap_split"][key] == j["overlap_split"][key]
    for f in ARTIFACTS:
        a = open(os.path.join(runs["jax"], f), "rb").read()
        b = open(os.path.join(runs["port"], f), "rb").read()
        assert a == b, f


def test_reoverlap_matches_jax(runs, tmp_path):
    out = {k: str(tmp_path / k) for k in runs}
    jax_main("reoverlap", [runs["jax"], out["jax"], GMB, "42", "--polish"])
    port_main("reoverlap", [runs["port"], out["port"], GMB, "42",
                            "--polish"])
    got = {k: json.load(open(os.path.join(d, "reoverlap_metrics.json")))
           for k, d in out.items()}
    assert untimed(got["port"]) == untimed(got["jax"])
    assert list(got["port"]) == list(got["jax"])
    for f in ("overlaps.npz", "contigs.fasta"):
        assert (open(os.path.join(out["port"], f), "rb").read()
                == open(os.path.join(out["jax"], f), "rb").read()), f
    # --polish polishes nothing (the reference's quirk): the contigs are
    # the run's unpolished contigs.fasta
    assert (open(os.path.join(out["port"], "contigs.fasta"), "rb").read()
            == open(os.path.join(runs["port"], "contigs.fasta"), "rb").read())
    assert not os.path.exists(os.path.join(out["port"], "polished.fasta"))


def test_polish_retry_matches_jax(runs, tmp_path):
    """One pass: each pass of the JAX script finds its candidates by the
    device self-join, ~25 s here; chip_smoke.py phase d runs two."""
    dirs = {}
    for k, d in runs.items():
        dirs[k] = str(tmp_path / k)
        shutil.copytree(d, dirs[k])
    jax_main("polish_retry", [dirs["jax"], "1", GMB, "42"])
    port_main("polish_retry", [dirs["port"], "1", GMB, "42"])
    got = {k: json.load(open(os.path.join(d, "polish_retry.json")))
           for k, d in dirs.items()}
    assert list(got["port"]) == list(got["jax"]) == ["pass1"]
    assert untimed(got["port"]["pass1"]) == untimed(got["jax"]["pass1"])
    assert (open(os.path.join(dirs["port"], "polished.fasta"), "rb").read()
            == open(os.path.join(dirs["jax"], "polished.fasta"), "rb").read())


def test_asm_sweep_and_run_diagnostics_match_jax(runs, capsys):
    """asm_sweep's nine variants, then diag_false_ov and diag_graph, which
    print the same lines; the JAX scripts of the two diagnostics run at
    import on /tmp/scale_4.6mb, so the path is swapped for the run
    directory in the source they execute (the file stays as it is)."""
    capsys.readouterr()
    jax_main("asm_sweep", [runs["jax"], GMB, "42"])
    j = capsys.readouterr().out.splitlines()
    rows = port_main("asm_sweep", [runs["port"], GMB, "42"])
    t = capsys.readouterr().out.splitlines()
    assert t[0] == j[0]
    jl = [json.loads(x) for x in j[1:]]
    tl = [json.loads(x) for x in t[1:]]
    assert len(tl) == 9 and [untimed(r) for r in tl] == [untimed(r)
                                                         for r in jl]
    assert [r["variant"] for r in rows] == [r["variant"] for r in jl]

    capsys.readouterr()
    jax_main("diag_false_ov", [runs["jax"]])
    j = capsys.readouterr().out
    port_main("diag_false_ov", [runs["port"]])
    assert capsys.readouterr().out == j
    assert j.startswith("records: ")

    path = os.path.join(ROOT, "exp", "diag_graph.py")
    src = open(path).read().replace("/tmp/scale_4.6mb", runs["jax"])
    with pytest.MonkeyPatch.context() as m:
        m.setenv("HGA_JAX_CACHE", "0")
        exec(compile(src, path, "exec"), {"__name__": "__main__"})
    j = capsys.readouterr().out
    port_main("diag_graph", [runs["port"]])
    assert capsys.readouterr().out == j
    assert "cleaned" in j
