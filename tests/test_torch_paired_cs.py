"""Paired-end mapping through the PyTorch port's CLI on the CPU (the
plain versions of the kernels), colour space: the paired goldens of the
JAX package's colour-space suites (opp-in, col-fw, two --paired-options
rounds, the seed-quality filter) and the colour-space legacy golden,
each with the flags its golden was made with.  SAM goldens are held byte
for byte minus `@PG`, the legacy golden byte for byte."""

import pytest

from shrimp_tpu_torch.utils import golden_cli

CASES = {**golden_cli.PAIRED_CS,
         "golden_legacy_cs": golden_cli.LEGACY["golden_legacy_cs"]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paired_golden_cs(case, tmp_path):
    spec = CASES[case]
    rc, out, err = golden_cli.run_case(spec, str(tmp_path), device="cpu")
    assert rc == 0, err[-2000:]
    got = golden_cli.compared(out, spec[4])
    want = golden_cli.expected(spec[4])
    assert got == want, (f"first difference at "
                         f"{golden_cli.first_difference(got, want)}")
