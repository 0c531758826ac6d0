"""Paired-end mapping through the PyTorch port's CLI on the CPU (the
plain versions of the kernels), letter space: every paired golden of the
JAX package's suites (the four pair modes, the reference's pairing
fixture, match modes 2-3 and --no-half-paired, --sam-r2, --all-contigs,
--paired-options rounds, the medium, draft-genome, messy and
seed-quality-filter corpora) and the legacy SHRiMP-format goldens of
letter space, each with the flags its golden was made with.  SAM goldens
are held byte for byte minus `@PG`, legacy goldens byte for byte."""

import pytest

from shrimp_tpu_torch.utils import golden_cli

CASES = {**golden_cli.PAIRED_LS,
         **{k: v for k, v in golden_cli.LEGACY.items()
            if k != "golden_legacy_cs"}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paired_golden(case, tmp_path):
    spec = CASES[case]
    rc, out, err = golden_cli.run_case(spec, str(tmp_path), device="cpu")
    assert rc == 0, err[-2000:]
    got = golden_cli.compared(out, spec[4])
    want = golden_cli.expected(spec[4])
    assert got == want, (f"first difference at "
                         f"{golden_cli.first_difference(got, want)}")


def test_messy_pairs_intake_drops(tmp_path):
    """Both mates get the intake check; the statistics count the reads
    of dropped pairs (gmapper.c:495-531,933), as the JAX CLI does."""
    rc, out, err = golden_cli.run_case(
        golden_cli.PAIRED_LS["golden_messy_paired"], str(tmp_path),
        device="cpu")
    assert rc == 0, err[-2000:]
    assert "warning: skipping read [drop1/1]" in err
    assert ("Pairs Dropped:                          2    (16.6667%)"
            in err)


def test_legacy_output_refuses_sam_flags(tmp_path):
    """-R needs the legacy format, --sam-unaligned the SAM one
    (gmapper.c:2466-2474)."""
    prog, flags, reads, genome, gold = golden_cli.LEGACY["golden_legacy_ls"]
    for extra, msg in ((["-E", "-R"], "-E and -R are incompatable"),
                       (["--sam-unaligned"], "must also use -E/--sam")):
        rc, out, err = golden_cli.run_case(
            (prog, flags + extra, reads, genome, gold), str(tmp_path),
            device="cpu")
        assert rc == 1 and msg in err and out == ""


def test_pair_stream_counts_equal_batch():
    """map_pair_stream's two worker threads add to one Telemetry: the
    kernel counters come out as one map_pair_batch over the same pairs
    gives them, and so do the SAM lines."""
    import numpy as np

    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch import seeds as seedmod
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.pipeline import paired
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    from shrimp_tpu_torch.utils import synth

    chroms = synth.make_genome(np.random.default_rng(5), 200_000)
    idx = gindex.build_index(
        [fastx.Contig(name=f"chr{i + 1}", codes=g)
         for i, g in enumerate(chroms)], seedmod.make_seed_set(None))
    pairs, _ = synth.make_pairs(idx, np.random.default_rng(17), 96)
    pcfg = paired.PairedConfig(pair_mode=paired.PAIR_OPP_IN,
                               min_insert_size=50, max_insert_size=600)
    out = []
    for stream in (False, True):
        m = paired.PairedMapper(idx, MapperConfig(qual_delta=64), pcfg,
                                device="cpu")
        res = (list(m.map_pair_stream(iter(pairs), batch_size=8)) if stream
               else m.map_pair_batch(pairs))
        out.append(([rec.line() for pr in res
                     for rec in m.sam_records_pair(pr)],
                    [(k.invocs, k.cells) for k in (m.tel.f1, m.tel.f2)]))
    assert out[0][1][0][0] > 0 and out[0][1][1][0] > 0
    assert out[1] == out[0]


def test_telemetry_keeps_every_update_from_threads():
    """Kernel counters, stage timers and new stages updated from many
    threads at once, with thread switches as frequent as CPython allows:
    no update is lost."""
    import sys
    import threading

    from shrimp_tpu_torch.utils import telemetry

    tel = telemetry.Telemetry(lock=threading.Lock())
    n_threads, n = 8, 4000
    start = threading.Barrier(n_threads)

    def work(t):
        start.wait()
        for i in range(n):
            tel.f1.add(1, 3, 0.5)
            with tel.stage(f"s{i % 16}"):
                pass
            tel.stages[f"s{i % 16}"].secs                 # read under load

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(old)
    assert (tel.f1.invocs, tel.f1.cells) == (n_threads * n, 3 * n_threads * n)
    assert tel.f1.secs == 0.5 * n_threads * n
    assert sorted(k for k in tel.stages if k.startswith("s")) == sorted(
        f"s{i}" for i in range(16))
    assert all(tel.stages[k].lock is tel.lock for k in tel.stages)
    assert tel.f2.lock is tel.lock and tel.fwbw.lock is tel.lock
