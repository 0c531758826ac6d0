"""On the card (marker `cuda`; skipped without one): the tiny cells run
through the kernels and come out correct, their traced runs read every
device metric within its range, and the control (the reference in the
program's place at lower precision; in the paired cell its float32
half alone too) and the colour-space kernels' planted faults come out
not correct.  Run on the
H100 with

    python3 -m pytest portbench/tests/test_portbench_card.py -q
"""

import time

import pytest

from harness import cell as cellmod
from harness import core as harness
from harness import faults

SEED = 2**31 + 99


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-ls", "tiny-cs", "tiny-pairs"])
def test_tiny_cell_on_the_card(tiny_root, card, name):
    c = cellmod.load_cell(name, root=tiny_root)
    line, checks = harness.run_cell(c, SEED, 2.0, True, card,
                                    time.perf_counter(), {})
    assert line["correct"], checks
    m = line["metrics"]
    assert 0 < m["device.idle_share"]["value"] < 100
    for k in ("pass1.roofline", "pass2.roofline"):
        assert 0 < m[k]["value"] <= 100, (k, m[k])
    assert line["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-ls", "tiny-cs", "tiny-pairs"])
def test_control_on_the_card(tiny_root, card, name):
    c = cellmod.load_cell(name, root=tiny_root)
    run = harness.Run(c, SEED, 2.0, False, card, time.perf_counter())
    run.prepare()
    run.drive()
    r = run.readings()
    assert harness.verdict(r["program"], c.limits)[0], r
    assert not harness.verdict(r["control"], c.limits)[0], r
    if name == "tiny-pairs":
        assert not harness.verdict(r["control_float32"], c.limits)[0], r


@pytest.mark.cuda
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_fault_on_the_card(tiny_root, card, fault):
    c = cellmod.load_cell("tiny-cs", root=tiny_root)
    with faults.planted(fault):
        line, checks = harness.run_cell(c, SEED, 2.0, False, card,
                                        time.perf_counter(), {})
    assert not line["correct"], checks
