"""Tiny end-to-end rehearsals on the CPU of each traffic kind, through
cells added as files and manifest entries only: the result line's keys,
`correct` on sound runs, and `correct` false once the timed path is
broken underneath (half of each batch left out; a token altered where
it is produced; the colour-space pass-2 kernels' paths chosen by wrong
arithmetic) or the reference at lower precision takes the program's
place (the control; in the paired cell its float32 half alone, on the
pair's mapping qualities)."""

import json
import time

import pytest

from harness import cell as cellmod
from harness import core as harness
from harness import faults, program

SEED = 2**33 + 1234567
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(root, name, trace=False, seconds=1.0):
    c = cellmod.load_cell(name, root=root)
    return harness.run_cell(c, SEED, seconds, trace, "cpu",
                            time.perf_counter(), {})


@pytest.mark.parametrize("name", ["tiny-ls", "tiny-cs", "tiny-pairs"])
def test_cell_runs_and_is_correct(tiny_root, name):
    line, checks = _run(tiny_root, name)
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"], checks
    assert set(line["metrics"]) == {"reads_per_s", "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.dumps(line)


def test_traced_run_reports_per_layer_metrics(tiny_root):
    line, _ = _run(tiny_root, "tiny-ls", trace=True)
    m = line["metrics"]
    assert {"stream.batch_p95_ms", "readprep.ms_per_kread",
            "candidates.ms_per_kread", "pass2.ms_per_kread",
            "sam.ms_per_kread", "setup.index_s"} <= set(m)
    # the CPU has no device events: no roofline, no idle share
    assert "pass1.roofline" not in m and "device.idle_share" not in m
    assert "pairing.ms_per_kread" not in m
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _broken_stream(fault):
    orig = program.stream

    def stream(mapper, traffic, items):
        for k, res in enumerate(orig(mapper, traffic, items)):
            if traffic["generator"] == "pairs":
                if fault == "half" and k % 2:
                    res.paired_hits, res.unpaired_hits = [], []
                elif fault == "token":
                    for h0, h1, _ in res.paired_hits:
                        h0.score_full += 1
                    for _, h in res.unpaired_hits:
                        h.score_full += 1
                yield res
                continue
            re_e, hits = res
            if fault == "half" and k % 2:
                hits = []
            elif fault == "token":
                for h in hits:
                    h.score_full += 1
            yield re_e, hits
    return stream


@pytest.mark.parametrize("fault", ["half", "token"])
@pytest.mark.parametrize("name", ["tiny-ls", "tiny-cs", "tiny-pairs"])
def test_a_broken_timed_path_is_not_correct(tiny_root, name, fault,
                                            monkeypatch):
    monkeypatch.setattr(program, "stream", _broken_stream(fault))
    line, checks = _run(tiny_root, name)
    assert not line["correct"], checks


@pytest.mark.parametrize("name", ["tiny-ls", "tiny-cs", "tiny-pairs"])
def test_the_control_is_not_correct(tiny_root, name):
    c = cellmod.load_cell(name, root=tiny_root)
    run = harness.Run(c, SEED, 1.0, False, "cpu", time.perf_counter())
    run.prepare()
    run.drive()
    r = run.readings()
    ok = lambda nums: harness.verdict(nums, c.limits)[0]  # noqa: E731
    assert ok(r["program"]), r
    assert not ok(r["control"]), r


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_pass2_fault_is_not_correct(tiny_root, fault):
    """Paths that K7+K8 choose by a flat crossover score or a cheap gap
    open score below the best of their span: only `below_best_pct`
    sees it."""
    with faults.planted(fault):
        line, checks = _run(tiny_root, "tiny-cs", seconds=2.0)
    assert not line["correct"], checks
    assert checks["below_best_pct"]["value"] > 3.0, checks


def test_the_float32_control_fails_the_pairs_mapping_qualities(tiny_root):
    c = cellmod.load_cell("tiny-pairs", root=tiny_root)
    run = harness.Run(c, SEED, 1.0, False, "cpu", time.perf_counter())
    run.prepare()
    run.drive()
    r = run.readings()
    assert harness.verdict(r["program"], c.limits)[0], r
    f32 = r["control_float32"]
    assert not harness.verdict(f32, c.limits)[0], r
    # the float32 half keeps every alignment: only MAPQ and Z fields move
    assert f32["record_errors"] > 0
    assert f32["lost_pct"] == r["program"]["lost_pct"]
