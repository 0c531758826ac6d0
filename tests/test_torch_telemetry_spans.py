"""The port's own profiler ranges (`utils/telemetry.py`, the stages of
`pipeline/mapper.py`) on the CPU: under a torch profiler, with nothing
patched, the mapper opens `stage.<name>` ranges around its stages, each
inside its parent's and carrying its batch's id; with no profiler it
opens none.  The nested stages' seconds add up, and the -D kernel
seconds are the seconds of their spans."""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline import paired
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig
from shrimp_tpu_torch.utils import telemetry

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# letter space on K10's plain version (its column read is a fetch too),
# colour space on host candidates (the posterior is a stage)
CASES = {
    "ls": ("golden_reads.fq", "golden_unpaired.sam",
           dict(qual_delta=64, device_candidates=True)),
    "cs": ("golden_reads_cs.fq", "golden_cs.sam",
           dict(colour_space=True, params=SWParams.colour_space(),
                qual_delta=33, device_candidates=False)),
}
# each new stage and the stages it lies inside
PARENTS = {
    "pass2_dispatch": ("pass2",),
    "pass2_finish": ("pass2",),
    "pass2_select": ("pass2_finish",),
    "post_sw": ("pass2_finish",),
    "device_fetch": ("pass1", "pass2_finish", "anchor_list"),
}


def _reads(name):
    return [(r.name, r.seq, r.qual)
            for r in fastx.iter_reads(os.path.join(GOLDEN, name))]


def _golden_body(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


def _lines(mapper, results):
    return [rec.line() for re_e, hits in results
            for rec in mapper.sam_records(re_e, hits)]


@pytest.fixture(scope="module")
def indexes():
    contigs = list(fastx.iter_contigs(os.path.join(GOLDEN,
                                                   "golden_genome.fa")))
    return {"ls": gindex.build_index(contigs),
            "cs": gindex.build_index(contigs, colour_space=True)}


def _mapper(indexes, case, **cfg):
    return Mapper(indexes[case], MapperConfig(**{**CASES[case][2], **cfg}),
                  device="cpu")


@pytest.fixture
def opened(monkeypatch):
    """Every profiler range the program opens, (name, args) in order;
    the ranges still open for real."""
    calls = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        calls.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return calls


def _spans(prof, calls):
    """The program's stage ranges from the profile, each with the batch
    its opener passed: name -> [(start_us, end_us, args)] by start (ranges
    of one name on one thread never overlap, so the n-th range of a name
    is its n-th opening)."""
    events: dict[str, list] = {}
    for e in prof.events():
        if e.name.startswith("stage."):
            events.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    args: dict[str, list] = {}
    for name, a in calls:
        args.setdefault(name, []).append(a)
    out = {}
    for name, ivs in events.items():
        assert len(ivs) == len(args[name]), name
        out[name[len("stage."):]] = [
            (lo, hi, a) for (lo, hi), a in zip(sorted(ivs), args[name])]
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_map_stream_opens_its_own_ranges(indexes, opened, case):
    """With the benchmark's patch not applied: each new stage's range
    lies inside one of its parent's ranges of the same batch, the
    per-read stage opens none, and the SAM is map_batch's."""
    reads = _reads(CASES[case][0])[:96]
    m = _mapper(indexes, case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lines = _lines(m, m.map_stream(iter(reads), batch_size=32))
    spans = _spans(prof, opened)
    plain = _mapper(indexes, case)
    assert lines == _lines(plain, plain.map_batch(reads))
    want = set(PARENTS) - ({"post_sw"} if case == "ls" else set())
    assert want <= set(spans)
    assert "post_sw" not in spans or case == "cs"
    # entered, yet no range of its own
    assert m.tel.stages["duplicate_removal"].secs > 0
    assert "duplicate_removal" not in spans
    n_batches = len(reads) // 32
    assert [a for _, _, a in spans["readparse"]] == [
        f"batch={k}" for k in range(n_batches)]
    assert [a for _, _, a in spans["pass2_finish"]] == [
        f"batch={k}" for k in range(n_batches)]
    for child in want:
        for lo, hi, a in spans[child]:
            outer = [pa for p in PARENTS[child] for plo, phi, pa in
                     spans.get(p, []) if plo <= lo and hi <= phi]
            assert outer == [a], (child, a)


def test_no_range_without_a_profiler(indexes, monkeypatch):
    """With no profiler recording, no stage enters a record_function."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for case in sorted(CASES):
        reads, gold, _ = CASES[case]
        m = _mapper(indexes, case)
        assert _lines(m, m.map_stream(iter(_reads(reads)),
                                      batch_size=48)) == _golden_body(gold)
        assert _lines(m, m.map_batch(_reads(reads))) == _golden_body(gold)
        assert m.tel.stages["pass2_select"].secs > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_nested_seconds_add_up(indexes, case):
    m = _mapper(indexes, case)
    list(m.map_stream(iter(_reads(CASES[case][0])), batch_size=48))
    st = {k: v.secs for k, v in m.tel.stages.items()}
    up = 1 + 1e-9                 # float sums in another order
    split = st["pass2_dispatch"] + st["pass2_finish"]
    assert 0.9 * st["pass2"] <= split <= st["pass2"] * up
    assert (st["pass2_select"] + st.get("post_sw", 0.0)
            <= st["pass2_finish"] * up)
    assert st["device_fetch"] <= (st["pass1"] + st["pass2_finish"]
                                  + st["anchor_list"]) * up
    assert ("post_sw" in st) == (case == "cs")


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_seconds_are_their_spans(indexes, case):
    """-D's Vector / Scalar SW seconds are the fetches' seconds (host
    candidates: no fetch of K10's columns), Forward-Backward's the
    posterior's."""
    m = _mapper(indexes, case, device_candidates=False)
    m.map_batch(_reads(CASES[case][0]))
    tel = m.tel
    assert tel.f1.secs > 0 and tel.f2.secs > 0
    assert tel.f1.secs + tel.f2.secs == pytest.approx(
        tel.stages["device_fetch"].secs, rel=1e-12)
    if case == "cs":
        assert tel.fwbw.secs == tel.stages["post_sw"].secs > 0
    else:
        assert tel.fwbw.secs == 0 and "post_sw" not in tel.stages


def test_a_range_holds_its_interval(opened):
    """The range opens before the timer's start and closes after its end;
    a stage outside any batch passes no argument, and a per-read stage
    opens no range."""
    tel = telemetry.Telemetry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tel.stage("pass1"):
            torch.zeros(64).sum()
        tel.begin_batch()
        with tel.stage("duplicate_removal"):
            pass
    (lo, hi, a), = _spans(prof, opened)["pass1"]
    assert a is None and opened == [("stage.pass1", None)]
    assert 0 < tel.stages["pass1"].secs <= (hi - lo) / 1e6
    assert tel.stages["duplicate_removal"].secs > 0


def test_batch_ids_are_per_thread():
    """Each thread reads its own current batch; ids are never reused."""
    import threading

    tel = telemetry.Telemetry()
    assert tel.begin_batch() == 0
    seen = []
    th = threading.Thread(target=lambda: seen.append(
        (getattr(tel.batch, "k", None), tel.begin_batch())))
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    assert seen == [(None, 1)] and tel.batch.k == 0
    tel.set_batch(7)
    assert tel.batch.k == 7 and tel.begin_batch() == 2


def test_map_pair_batch_numbers_its_batches(opened):
    """A paired batch's ranges carry its id, one id a call, and its full
    SW dispatch (both mates in one launch) has the pass-2 dispatch's
    range."""
    idx = gindex.build_index(list(fastx.iter_contigs(
        os.path.join(GOLDEN, "golden_genome.fa"))))
    rs = _reads("golden_pairs.fq")[:32]
    pairs = list(zip(rs[0::2], rs[1::2]))
    pcfg = paired.PairedConfig(pair_mode=paired.PAIR_OPP_IN,
                               min_insert_size=0, max_insert_size=500)
    m = paired.PairedMapper(idx, MapperConfig(qual_delta=64), pcfg,
                            device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.map_pair_batch(pairs[:8])
        m.map_pair_batch(pairs[8:])
    spans = _spans(prof, opened)
    assert [a for _, _, a in spans["readparse"]] == ["batch=0", "batch=1"]
    assert {a for _, _, a in spans["pass2_dispatch"]} == {"batch=0",
                                                          "batch=1"}
