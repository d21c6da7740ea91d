"""The port's truth-labelled diagnostics (hga_tpu_torch.exp.diag_*)
against the JAX package's scripts of exp/ on a 20 kb sim.repeat_genome (the
smallest that still holds copies of every repeat family and is longer than
the 8 kb mean long read): what they print is compared line for line with
the seconds taken out.  Randomness is a local np.random.default_rng."""

import re

import numpy as np

from torch_exp_common import (_one_torch_thread, jax_main,  # noqa: F401
                              port_main)

REP_KB = "20"


def _untimed_lines(text):
    """The printed lines with the seconds taken out."""
    return [re.sub(r" in \d+s", "", ln) for ln in text.splitlines()]


def test_diag_repeat_corr_matches_jax(capsys):
    capsys.readouterr()
    jax_main("diag_repeat_corr", [REP_KB, "--no-correct"])
    j = capsys.readouterr().out
    port_main("diag_repeat_corr", [REP_KB, "--no-correct"])
    t = capsys.readouterr().out
    assert _untimed_lines(t) == _untimed_lines(j)
    assert "[filter ON]" in j and "misplaced" in j


def test_diag_repeat_corr_helpers_match_jax():
    """probe_sites and residual_identity (the --no-correct run skips them)
    on the raw long reads, against exp/'s."""
    import exp.diag_repeat_corr as JD
    from hga_tpu_torch.exp import diag_repeat_corr as TD
    from hga_tpu_torch.utils import sim

    genome, annot, ls, *_, l_truth = TD.repeat_reads(int(REP_KB) * 1000)
    assert genome == sim.repeat_genome(int(REP_KB) * 1000, seed=42)
    texts = ls[:12]
    for fn in ("probe_sites", "residual_identity"):
        got = getattr(TD, fn)(genome, annot, texts, l_truth[:12])
        want = getattr(JD, fn)(genome, annot, texts, l_truth[:12])
        assert got == want, fn
    assert TD.probe_sites(genome, annot, ls, l_truth)["own_kept"] > 0


def test_diag_leak_matches_jax(capsys):
    capsys.readouterr()
    jax_main("diag_leak", [REP_KB])
    j = capsys.readouterr().out
    port_main("diag_leak", [REP_KB])
    t = capsys.readouterr().out
    assert t == j
    assert "misplaced survivors" in j


def test_diag_polish_votes_matches_jax(tmp_path, capsys):
    """On a contig that is the repeat genome with 1 substitution in 500
    (from a local default_rng): the same mappable sites and votes."""
    from hga_tpu_torch.io.fastq import write_fasta
    from hga_tpu_torch.utils import sim

    seq = np.array(list(sim.repeat_genome(int(REP_KB) * 1000, seed=42)))
    rng = np.random.default_rng(5)
    pos = rng.choice(seq.size, seq.size // 500, replace=False)
    bases = np.array(list("ACGT"))
    seq[pos] = bases[(np.searchsorted(bases, seq[pos])
                      + rng.integers(1, 4, pos.size)) % 4]
    path = str(tmp_path / "contig.fasta")
    write_fasta(path, [("contig_0", "".join(seq))])
    capsys.readouterr()
    jax_main("diag_polish_votes", [path, REP_KB])
    j = capsys.readouterr().out
    port_main("diag_polish_votes", [path, REP_KB])
    t = capsys.readouterr().out
    assert t == j
    assert "mappable rRNA divergent sites" in j and "votes at sites" in j


