"""BENCHMARK.json against the benchmark's contract: names and units in
the allowed characters, every cell's files present, every metric's
reader present, every metric that moves an end-to-end metric listed only
in cells that report that metric, and the check's time budget."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    assert all(PATH.match(p) for p in man["paths"])
    assert len(man["command"]) <= 32
    assert man["command"][1] == "portbench/run.py"
    assert 1 <= man["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(man):
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in man["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in man["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200


def test_cell_files_exist(man):
    confs = {c["name"]: c for c in man["configs"]}
    used = set()
    for w in man["workloads"]:
        c = confs[w["config"]]
        used.add(c["name"])
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        for sub in (f"traffic/{w['traffic']}.json",
                    f"checks/{w['name']}.json"):
            assert os.path.exists(os.path.join(BENCH, sub)), sub
    assert used == set(confs)
    assert len({c["file"] for c in man["configs"]}) == len(confs)
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_metric_has_a_reader(man):
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_moves_is_reported_where_listed(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e, m
        target = e2e[m["moves"]]
        for w in m.get("workloads", sorted(cells)):
            assert w in cells, (m["name"], w)
            assert "workloads" not in target or w in target["workloads"]


def test_end_to_end_rules(man):
    names = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in names
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or m["name"].endswith(".roofline"):
            assert m["unit"] == "%"


def test_run_seconds_fits_the_check_with_24_cells(man):
    s = man["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200
    assert total <= 43200, total


def test_one_chip_unless_across_chips(man):
    four = [w for w in man["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(man["workloads"]) // 4)
