"""The readers of the program's pass-2 and device-fetch spans: each is
1e6 x its stage's window seconds over the reads, and None where the
program has no such stage (a program without the spans, or letter space
for the posterior); and in a tiny traced run on the CPU all five are
reported, the dispatch and the finish adding up to pass 2."""

import time

import pytest

from harness import cell as cellmod
from harness import core as harness

READERS = {
    "pass2.dispatch_ms_per_kread": "pass2_dispatch",
    "pass2.finish_ms_per_kread": "pass2_finish",
    "pass2.select_ms_per_kread": "pass2_select",
    "pass2.posterior_ms_per_kread": "post_sw",
    "device.fetch_ms_per_kread": "device_fetch",
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_its_stage(name):
    mod = cellmod.load_metric(name)
    stages = {"pass2": 9.0, "pass1": 1.0, READERS[name]: 0.75}
    assert mod.read({"reads": 3000, "stages": stages}) == pytest.approx(
        1e6 * 0.75 / 3000)
    # the parent's program, or a stage never entered: nothing to read
    assert mod.read({"reads": 3000, "stages": {"pass2": 9.0}}) is None


def test_posterior_absent_in_letter_space():
    mod = cellmod.load_metric("pass2.posterior_ms_per_kread")
    ls = {"pass2": 9.0, "pass2_dispatch": 1.0, "pass2_finish": 7.9,
          "pass2_select": 6.0, "device_fetch": 0.2}
    assert mod.read({"reads": 3000, "stages": ls}) is None


def test_traced_tiny_run_reports_the_split(tiny_root):
    c = cellmod.load_cell("tiny-cs", root=tiny_root)
    line, _ = harness.run_cell(c, 2**33 + 7654321, 1.0, True, "cpu",
                               time.perf_counter(), {})
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(READERS) <= set(m)
    split = m["pass2.dispatch_ms_per_kread"] + m["pass2.finish_ms_per_kread"]
    assert 0.9 * m["pass2.ms_per_kread"] <= split
    assert split <= m["pass2.ms_per_kread"] * (1 + 1e-9)
    assert (m["pass2.select_ms_per_kread"] + m["pass2.posterior_ms_per_kread"]
            <= m["pass2.finish_ms_per_kread"] * (1 + 1e-9))
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert "stage.pass2_finish" in gaps or "stage.post_sw" in gaps
