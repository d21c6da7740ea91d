"""The vectorised generators hold the read and repeat models: lengths,
coverage, error rate, strands, repeat copies, the assembly's edits; the
packing is the port's."""

import numpy as np
import pytest

from benchmark import gen

READS = dict(read_len=100, coverage=30.0, error_rate=0.01, pad_len=112)
REPEATS = dict(rrna_copies=7, rrna_len=5000, rrna_ident=0.99, is_families=3,
               is_copies=5, is_len=1200, is_ident=0.97, tandem_loci=2,
               tandem_unit=350, tandem_copies=6)


def test_same_seed_same_arrays_and_large_seeds():
    for seed in (0, 2**31 + 7, 2**40 + 3, -5):
        a = gen.random_genome(gen.rng_for(seed, 1), 1000, 0.5)
        b = gen.random_genome(gen.rng_for(seed, 1), 1000, 0.5)
        assert np.array_equal(a, b)
    assert not np.array_equal(gen.random_genome(gen.rng_for(1, 1), 1000, .5),
                              gen.random_genome(gen.rng_for(2, 1), 1000, .5))


def test_genome_gc_share():
    g = gen.random_genome(gen.rng_for(3, 1), 200_000, 0.508)
    gc = np.isin(g, (1, 2)).mean()
    assert abs(gc - 0.508) < 0.005


@pytest.mark.parametrize("circular", [False, True])
def test_short_reads_model(circular):
    g = gen.random_genome(gen.rng_for(4, 1), 50_000, 0.5)
    n_err = n_base = n_rc = n = 0
    for _, codes, starts, rc in gen.read_chunks(gen.rng_for(4, 2), g, READS,
                                                circular):
        assert codes.shape[1] == 100
        idx = starts[:, None] + np.arange(100)
        if circular:
            assert starts.max() >= 50_000 - 100     # some cross the origin
            idx %= len(g)
        else:
            assert idx.max() < len(g)
        truth = g[idx]
        truth[rc] = 3 - truth[rc, ::-1]
        n_err += int((truth != codes).sum())
        n_base += codes.size
        n_rc += int(rc.sum())
        n += len(codes)
    assert n == int(30.0 * 50_000 / 100)                # coverage
    assert abs(n_err / n_base - 0.01) < 0.001           # error rate
    assert abs(n_rc / n - 0.5) < 0.02                   # strands


def test_packing_is_the_ports():
    from hga_tpu_torch.io.encode import pack_reads

    g = gen.random_genome(gen.rng_for(5, 1), 5_000, 0.5)
    packed, bad, length = gen.short_reads(gen.rng_for(5, 2), g, READS, False)
    _, codes, _, _ = next(gen.read_chunks(gen.rng_for(5, 2), g, READS, False))
    pr = pack_reads([gen.decode(c) for c in codes[:50]], pad_len=112)
    assert np.array_equal(pr.packed, packed[:50])
    assert np.array_equal(pr.bad, bad[:50])
    assert np.array_equal(pr.length, length[:50])
    assert packed.dtype == bad.dtype == np.uint32


def test_repeat_genome_copies():
    """At the configuration's full length: every copy placed, copies of a
    family at about the family's identity squared to each other."""
    g, copies = gen.repeat_genome(gen.rng_for(6, 1), 4_641_652, 0.508,
                                  **REPEATS)
    assert len(g) == 4_641_652
    fam = {}
    for c in copies:
        seq = g[c["start"]:c["end"]]
        fam.setdefault(c["family"], []).append(
            gen.revcomp(seq) if c["strand"] else seq)
    assert len(fam["rrna"]) == 7 and len(fam["rrna"][0]) == 5000
    assert all(len(fam[f"is{i}"]) == 5 for i in range(3))
    assert {"tandem0", "tandem1"} <= set(fam)
    for name, ident in (("rrna", 0.99), ("is0", 0.97)):
        a, b = fam[name][0], fam[name][1]
        assert abs((a == b).mean() - ident ** 2) < 0.01
    t = fam["tandem0"][0]
    assert np.array_equal(t[:350], t[350:700])


def test_assembly_edits():
    g = gen.random_genome(gen.rng_for(7, 1), 100_000, 0.5)
    none = dict(rotate=True, edit_rate=0.0, indel_share=0.5, indel_len=[1, 3])
    c = gen.assembly(gen.rng_for(7, 3), g, none, True)
    doubled = gen.decode(np.concatenate([g, g]))
    assert len(c) == len(g)
    assert gen.decode(c) in doubled or gen.decode(gen.revcomp(c)) in doubled
    spec = dict(none, edit_rate=1e-3, indel_share=0.0)
    c = gen.assembly(gen.rng_for(8, 3), g, spec, False)
    fwd = (c != g).sum()
    rev = (gen.revcomp(c) != g).sum()
    assert 60 < min(fwd, rev) < 140                     # ~100 substitutions
    spec = dict(none, edit_rate=1e-3, indel_share=1.0)
    c = gen.assembly(gen.rng_for(9, 3), g, spec, False)
    assert len(c) != len(g) and abs(len(c) - len(g)) < 300
