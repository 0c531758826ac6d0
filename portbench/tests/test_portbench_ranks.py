"""The rank runner (`harness/ranks.py`): a tiny letter-space cell over two
gloo ranks on the CPU (`SHRIMP_TPU_TORCH_DEVICE=cpu`, which the
program's `rank_device` honours), its merged record, the dealing, the
ranks' SAM lines against one process mapping the same reads, the
control and the broken runs that have to come out not correct, and a
rank that fails or hangs ending the run; on the cards (marker `cuda`,
two cards or more) the same cell over two nccl ranks."""

import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from conftest import ROOT
from harness import cell as cellmod
from harness import core as harness
from harness import data, program, ranks

SEED = 2**33 + 424242
SECONDS = 2.0


@pytest.fixture(scope="module")
def rank_env():
    """Rank processes start from the checkout's run.py: the program is
    found on PYTHONPATH, as at the checkout's root."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", ROOT + os.pathsep
                  + os.environ.get("PYTHONPATH", ""))
        yield


def _launch(root, device="cpu", trace=False):
    c = cellmod.load_cell("tiny-ranks", root=root)
    launch = ranks.Launch(c, SEED, SECONDS, trace, device,
                          time.perf_counter())
    launch.prepare()
    launch.run()
    return launch


def _line(launch):
    correct, checks = harness.verdict(launch.check(), launch.cell.limits)
    return harness.result_line(launch, correct, checks, launch.peak), checks


@pytest.fixture(scope="module")
def launched(tiny_root, rank_env):
    launch = _launch(tiny_root, trace=True)
    line, checks = _line(launch)
    return launch, line, checks


def test_the_run_is_correct_and_reports_its_metrics(launched):
    launch, line, checks = launched
    assert line["correct"], checks
    assert list(line)[-1] == "checks"
    m = line["metrics"]
    assert {"ranks.rate_spread_pct", "stream.batch_p95_ms",
            "readprep.ms_per_kread", "pass2.ms_per_kread",
            "sam.ms_per_kread", "setup.index_s"} <= set(m)
    assert m["ranks.rate_spread_pct"]["value"] >= 0
    assert line["device"]["count"] == 2
    assert line["attempted"] == launch.record["reads"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_merged_record_sums_the_ranks(launched):
    launch = launched[0]
    rec, recs = launch.record, launch.rank_records
    B = int(launch.cell.traffic["batch_size"])
    assert [r["rank"] for r in recs] == [0, 1]
    for k in ("reads", "batches", "sam_s"):
        assert rec[k] == pytest.approx(sum(r[k] for r in recs))
    for k in rec["stages"]:
        assert rec["stages"][k] == pytest.approx(
            sum(r["stages"].get(k, 0.0) for r in recs))
    assert rec["stats"]["reads"] == rec["reads"]
    # whole batches only, each rank's window at least the cell's length
    for r in recs:
        assert r["reads"] == r["batches"] * B
        assert r["window_s"] >= SECONDS
        assert len(r["batch_ms"]) == r["batches"]
    t0 = min(r["t0"] for r in recs)
    assert rec["window_s"] == pytest.approx(
        max(r["t0"] + r["window_s"] for r in recs) - t0)
    assert len(rec["batch_ms"]) == rec["batches"]
    assert rec["setup_s"] == pytest.approx(t0 - launch.t_start)
    assert rec["setup"]["warmup_s"] == max(r["setup"]["warmup_s"]
                                           for r in recs)


def test_merge_of_two_records():
    def rank(r, t0, ms, busy):
        return {"rank": r, "t0": t0, "reads": 2 * len(ms),
                "batches": len(ms), "window_s": sum(ms) / 1e3,
                "batch_ms": ms, "setup": {"warmup_s": 1.0 + r},
                "stages": {"pass2": 0.5}, "stats": {"reads": 2 * len(ms)},
                "sam_s": 0.25, "launches": {"pass1.roofline": [{"c": r}]},
                "cores": [r], "device": {
                    "busy_s": busy, "window_s": 1.0,
                    "by_name": {"k": busy}, "all_by_name": {"k": busy},
                    "idle_by_range": {"stage.pass2": 1.0 - busy}}}
    rec = ranks.merge([rank(0, 10.0, [400.0, 600.0], 0.25),
                       rank(1, 10.002, [700.0, 500.0], 0.75)], 4.0,
                      {"genome_s": 0.1})
    assert rec["reads"] == 8 and rec["batches"] == 4
    assert rec["window_s"] == pytest.approx(1.202)
    assert rec["batch_ms"] == pytest.approx([400.0, 600.0, 702.0, 500.0])
    assert rec["setup_s"] == pytest.approx(6.0)
    assert rec["setup"] == {"warmup_s": 2.0, "launcher": {"genome_s": 0.1}}
    assert rec["stages"] == {"pass2": 1.0} and rec["sam_s"] == 0.5
    assert rec["launches"] == {"pass1.roofline": [{"c": 0}, {"c": 1}]}
    assert rec["device"]["busy_s"] == pytest.approx(0.5)
    assert rec["device"]["by_name"] == {"k": 1.0}
    spread = cellmod.load_metric("ranks.rate_spread_pct").read(rec)
    # rates 4 / 1.0 and 4 / 1.2 reads/s
    assert spread == pytest.approx(100 * (4 - 4 / 1.2) / ((4 + 4 / 1.2) / 2))


def test_rate_spread_reads_nothing_on_one_card():
    mod = cellmod.load_metric("ranks.rate_spread_pct")
    assert mod.read({"reads": 10, "window_s": 1.0}) is None


def _blocks(seq, B):
    return sorted(tuple(seq[i:i + B]) for i in range(0, len(seq), B))


def test_each_rank_maps_the_share_the_program_deals_it(launched):
    from shrimp_tpu_torch.parallel import multihost
    launch = launched[0]
    traffic = launch.cell.traffic
    B = int(traffic["batch_size"])
    names = [it[0] for it in launch.items]
    seen = []
    for r, pool in enumerate(launch.pools):
        dealt = [it[0] for it in multihost.host_read_blocks(
            iter(launch.items), 2, r, block=int(traffic["deal_block"]))]
        mine = [it[0] for it in pool.items]
        assert len(mine) % B == 0
        assert _blocks(mine, B) == _blocks(dealt, B)
        qnames = {ln.split("\t", 1)[0].rsplit("_", 1)[0]
                  for ln in launch.texts[r].split("\n") if ln}
        assert qnames and qnames <= set(mine)
        seen += mine
    assert sorted(seen) == sorted(names)


def test_the_ranks_sam_is_one_process_mapping_the_same_reads(launched):
    """The reads axis: the ranks' lines, rank after rank, are byte for
    byte the lines of one process mapping their window reads in the same
    order."""
    import itertools
    launch = launched[0]
    c = launch.cell
    B = int(c.traffic["batch_size"])
    reads = []
    for pool, rec in zip(launch.pools, launch.rank_records):
        reads += itertools.islice(pool.cycled(), launch.window_first,
                                  launch.window_first + rec["batches"] * B)
    idx = program.load_index(data.index_prefix(c.config, c.root))
    mapper = program.make_mapper(c.config, c.traffic, idx, device="cpu")
    lines = [ln for res in program.stream(mapper, c.traffic, iter(reads))
             for ln in program.sam_lines(mapper, c.traffic, res)]
    assert "".join(launch.texts) == "".join(ln + "\n" for ln in lines)


def test_the_control_is_not_correct(launched):
    launch = launched[0]
    r = launch.readings()
    ok = lambda nums: harness.verdict(nums, launch.cell.limits)[0]  # noqa
    assert ok(r["program"]), r
    assert not ok(r["control"]), r


def test_a_rank_left_out_of_the_merge_is_not_correct(launched):
    launch = launched[0]
    texts = launch.texts
    try:
        launch.texts = [texts[0], ""]
        numbers = launch.check()
    finally:
        launch.texts = texts
    assert not harness.verdict(numbers, launch.cell.limits)[0], numbers


def _patched_root(tiny_root, tmp_path, module, code):
    """A copy of the tiny checkout whose `harness/<module>.py` ends with
    `code`: a fault planted in the copy, which the ranks import."""
    root = str(tmp_path / "checkout")
    shutil.copytree(tiny_root, root, symlinks=True)
    with open(os.path.join(root, "portbench", "harness",
                           f"{module}.py"), "a") as fh:
        fh.write(code)
    return root


BROKEN_STREAM = '''

_stream_as_built = stream


def stream(mapper, traffic, items):
    for k, (re_e, hits) in enumerate(_stream_as_built(mapper, traffic,
                                                      items)):
        if {fault!r} == "half" and k % 2:
            hits = []
        elif {fault!r} == "token":
            for h in hits:
                h.score_full += 1
        yield re_e, hits
'''


@pytest.mark.parametrize("fault", ["half", "token"])
def test_a_broken_timed_path_is_not_correct(tiny_root, tmp_path, rank_env,
                                            fault):
    root = _patched_root(tiny_root, tmp_path, "program",
                         BROKEN_STREAM.format(fault=fault))
    c = cellmod.load_cell("tiny-ranks", root=root)
    line, checks = harness.run_cell(c, SEED, SECONDS, False, "cpu",
                                    time.perf_counter(), {})
    assert not line["correct"], checks


FAILING_RANK = '''

_rank_main_as_built = rank_main


def rank_main(cell, args, t_start, threads):
    if args.rank == 1:
        {action}
    return _rank_main_as_built(cell, args, t_start, threads)
'''


@pytest.mark.parametrize("action,limit", [("sys.exit(7)",
                                           "rank 1 exited with code 7"),
                                          ("time.sleep(3600)",
                                           "had not reached the window")])
def test_a_failed_rank_ends_the_run(tiny_root, tmp_path, rank_env, action,
                                    limit):
    root = _patched_root(tiny_root, tmp_path, "ranks",
                         FAILING_RANK.format(action=action))
    c = cellmod.load_cell("tiny-ranks", root=root)
    launch = ranks.Launch(c, SEED, SECONDS, False, "cpu",
                          time.perf_counter())
    launch.open_limit_s = 45.0
    launch.prepare()
    t = time.perf_counter()
    with pytest.raises(harness.RankFailed, match=limit):
        launch.run()
    assert time.perf_counter() - t < 120
    assert all(p.poll() is not None for p in launch.procs)
    assert not os.path.exists(launch.run_dir)


KILLED_LAUNCHER = """
import sys, time
sys.path[:0] = [{bench!r}, {root!r}]
from harness import cell, ranks
launch = ranks.Launch(cell.load_cell("tiny-ranks", root={root!r}), {seed},
                      600.0, False, "cpu", time.perf_counter())
launch.prepare()
launch.run()
"""


def _ranks_of(run_dir: str) -> list[int]:
    """The live processes whose command line names `run_dir` (a run's
    ranks); zombies count as ended."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().split(b"\0")
            with open(f"/proc/{pid}/stat") as fh:
                state = fh.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if b"--rank" in cmd and run_dir.encode() in cmd and state != "Z":
            out.append(int(pid))
    return out


def test_a_killed_launcher_takes_its_ranks_with_it(tiny_root, tmp_path,
                                                   rank_env):
    """SIGKILL runs no clean-up in the launcher: its ranks, in their
    window, end all the same."""
    root = _patched_root(tiny_root, tmp_path, "ranks", "")
    run_dir = os.path.join(root, "build", "portbench", "ranks")
    code = KILLED_LAUNCHER.format(bench=os.path.join(root, "portbench"),
                                  root=root, seed=SEED)
    launcher = subprocess.Popen([sys.executable, "-c", code],
                                stdin=subprocess.DEVNULL,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        while not all(os.path.exists(os.path.join(run_dir, f"rank{r}.open"))
                      for r in range(2)):
            assert launcher.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        alive = _ranks_of(run_dir)
        assert len(alive) == 2
    finally:
        launcher.send_signal(signal.SIGKILL)
        launcher.wait(timeout=30)
    deadline = time.monotonic() + 30
    while _ranks_of(run_dir) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _ranks_of(run_dir) == []


def test_a_second_run_of_one_checkout_is_refused(tiny_root):
    """The ranks' directory is the checkout's: while one launcher holds
    it, another fails at once and starts no rank."""
    import fcntl
    c = cellmod.load_cell("tiny-ranks", root=tiny_root)
    launch = ranks.Launch(c, SEED, SECONDS, False, "cpu",
                          time.perf_counter())
    os.makedirs(os.path.dirname(launch.run_dir), exist_ok=True)
    with open(launch.run_dir + ".lock", "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        with pytest.raises(harness.RankFailed, match="another run"):
            launch.run()
    assert launch.procs == []


def test_rank_cells_deal_whole_batches():
    man = cellmod.load_manifest()
    multi = [w for w in man["workloads"] if w["chips"] > 1]
    assert multi
    for w in multi:
        c = cellmod.load_cell(w["name"])
        ranks.check_traffic(c.traffic, c.chips)
        assert "pass2.posterior_ms_per_kread" not in {
            m["name"] for m in c.per_layer}
    with pytest.raises(ValueError):
        ranks.check_traffic(dict(c.traffic, deal_block=1000), c.chips)


@pytest.fixture
def two_cards():
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.cuda
def test_two_nccl_ranks_on_the_cards(tiny_root, rank_env, two_cards):
    launch = _launch(tiny_root, device="cuda", trace=True)
    line, checks = _line(launch)
    assert line["correct"], checks
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 2
    assert line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["device.idle_share"]["value"] < 100
    assert [r["kind"] for r in launch.rank_records][0] == \
        line["device"]["kind"]
