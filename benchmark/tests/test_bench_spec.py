"""BENCHMARK.json and the files it names: the form the benchmark's contract
fixes, and every cell, configuration, mix and metric found by name."""

import json
import math
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head|expert|"
                   r"state_size|projection|expansion")


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_form():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(b["command"]) <= 32 and all(map(_line, b["command"]))
    assert b["command"][1].startswith(b["paths"][0] + "/")
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_cells():
    b = bench()
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    cfg_names = [c["name"] for c in b["configs"]]
    assert len(set(cfg_names)) == len(cfg_names)
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        data = harness.load_json(os.path.join(ROOT, c["file"]))
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in data and not WIDTH.search(key)
        assert "assumed" in data and "guarantees" in data
    used = {w["config"] for w in b["workloads"]}
    assert used == set(cfg_names)
    pairs, names = set(), set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in names and _line(w["why"])
        names.add(w["name"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_metrics():
    b = bench()
    seen = set()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(harness.load_module("metrics", m["name"]).read)
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_loads_by_name(cell):
    """Each cell's configuration, mix, jobs and metrics load by name, and
    the cell reports setup_s, another end-to-end metric and a per-layer
    metric."""
    c = harness.Cell(bench(), cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert c.mix["jobs"] == c.jobs_mod.__name__.rsplit(".", 1)[-1]
    for attr in ("Jobs", "LIMITS"):
        assert hasattr(c.jobs_mod, attr)
    assert c.mix["distinct_inputs"] >= 2


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel


def test_json_files_parse():
    for sub in ("configs", "traffic"):
        d = os.path.join(ROOT, "benchmark", sub)
        for f in os.listdir(d):
            assert f.endswith(".json")
            with open(os.path.join(d, f)) as fh:
                json.load(fh)


def test_roofline_arithmetic_is_the_frozen_count():
    from benchmark import roofline

    # segments x columns x ceil(384 / 32) words x 20 ops over 16.7e12
    b = roofline.myers_bound_s(12088, 9283305, 384, "NVIDIA H100 80GB HBM3")
    assert math.isclose(b, 12088 * 9283305 * 12 * 20 / (132 * 64 * 1.98e9))
    assert roofline.myers_bound_s(1, 1, 1, "cpu") is None
