"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (set-up, window, check) on the CPU at a small size,
past its look for a card, once sound and once for each fault a cell can
have.  Neither cell keeps a state from step to step or exchanges anything
between cards, so the faults are a batch half left out (the rest standing
in for it) and an answer altered where it is produced."""

import copy
import os
import time

import pytest
import torch

from benchmark import harness

COUNT = "count.ecoli46-hybrid"
EVALSEG = "evalseg.ecoli46-repeats-circ"


def _small(c):
    c = copy.deepcopy(c)
    if c["genome"]["model"] == "random":
        c["genome"]["length"] = 100_000
        c["batch_reads"] = 8192
    else:
        c["genome"]["length"] = 3000
        c["genome"]["repeats"].update(rrna_len=300, is_len=150,
                                      tandem_unit=40)
    return c


def _run(cell, seed=2**31 + 99):
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    out, lines = harness.run_cell(bench, cell, seed, 0.0, False, "cpu",
                                  time.perf_counter(), _small)
    assert out["attempted"] >= 1 and lines
    return out


def _half_keys(monkeypatch):
    import hga_tpu_torch.models.spectrum as S

    orig = S._batch_keys

    def half(pr, sel, k, device):
        keys = orig(pr, sel, k, device).reshape(len(sel), -1).clone()
        h = len(sel) // 2
        keys[h:2 * h] = keys[:h]          # the first half counted twice
        return keys.reshape(-1)

    monkeypatch.setattr(S, "_batch_keys", half)


def _count_altered(monkeypatch):
    import hga_tpu_torch.ops.count as C

    orig = C.count_keys

    def altered(key, weight):
        keys, counts = orig(key, weight)
        counts = counts.clone()
        counts[len(counts) // 2] += 1
        return keys, counts

    monkeypatch.setattr(C, "count_keys", altered)


def _edit_fault(monkeypatch, kind):
    import hga_tpu_torch.models.overlap as O

    orig = O.default_edit

    def default_edit(cfg, mesh=None, **kw):
        edit = orig(cfg, mesh, **kw)

        def broken(q, t, ql, tl):
            r = edit(q, t, ql, tl)
            dist = r.dist.clone()
            if kind == "altered":
                dist[0] += 1
            else:
                h = len(dist) // 2
                dist[h:] = torch.round(dist[:h].float().mean()).to(
                    dist.dtype)
            return r._replace(dist=dist)
        return broken

    monkeypatch.setattr(O, "default_edit", default_edit)


@pytest.mark.parametrize("cell", [COUNT, EVALSEG])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell,fault", [
    (COUNT, "half"), (COUNT, "altered"),
    (EVALSEG, "half"), (EVALSEG, "altered")])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    if cell == COUNT:
        (_half_keys if fault == "half" else _count_altered)(monkeypatch)
    else:
        _edit_fault(monkeypatch, fault)
    out = _run(cell)
    assert out["correct"] is False and out["failed"] == out["attempted"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
