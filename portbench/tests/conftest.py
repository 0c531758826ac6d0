"""Test set-up of the benchmark's own tests: the harness's modules and
the program importable, the card marker registered, and a fixture that
builds a checkout holding the benchmark plus tiny cells added as files
and manifest entries only."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# the benchmark's packages first: the checkout's root has a `bench.py`
for p in (ROOT, BENCH):
    if p in sys.path:
        sys.path.remove(p)
    sys.path.insert(0, p)

TINY_GENOME = {"generator": "make_genome", "seed": 11, "genome_bp": 1_000_000,
               "contigs": 25}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skips "
        "without one")


def add_cell(root: str, name: str, base_config: str, traffic: dict,
             limits: dict, genome: dict = TINY_GENOME,
             chips: int = 1) -> None:
    """Add a cell the way a later change would: a configuration, a
    traffic mix and the limits of its checks as new files, and one new
    entry each in BENCHMARK.json."""
    bench = os.path.join(root, "portbench")
    man_path = os.path.join(root, "BENCHMARK.json")
    with open(man_path) as fh:
        man = json.load(fh)
    with open(os.path.join(bench, "configs", f"{base_config}.json")) as fh:
        conf = json.load(fh)
    conf["name"] = f"{name}-config"
    conf["genome"] = dict(genome)
    cfile = f"portbench/configs/{name}-config.json"
    with open(os.path.join(root, cfile), "w") as fh:
        json.dump(conf, fh)
    with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(bench, "checks", f"{name}.json"), "w") as fh:
        json.dump(limits, fh)
    man["configs"].append({"name": f"{name}-config", "source": "test",
                           "file": cfile, "reduced": ["genome"],
                           "why": "a test cell"})
    man["workloads"].append({"name": name, "config": f"{name}-config",
                             "traffic": name, "chips": chips,
                             "why": "test"})
    for m in man["per_layer"]:
        if "workloads" in m and (m["name"] != "pairing.ms_per_kread"
                                 or traffic["generator"] == "pairs"):
            m["workloads"].append(name)
    with open(man_path, "w") as fh:
        json.dump(man, fh)


def rank_traffic() -> dict:
    """Tiny letter-space reads dealt to two ranks, two batches each."""
    t = tiny_traffic("reads")
    t.update(deal_block=128, pool_batches=4)
    return t


def tiny_traffic(generator: str) -> dict:
    t = {"generator": generator, "read_len": 50, "batch_size": 128,
         "workers": 1, "pool_batches": 2, "pool_seed": 5, "warmup_batches": 1,
         "sample": 96}
    if generator == "pairs":
        del t["workers"]
        t.update(batch_size=64, sample=48,
                 pairing={"mode": "opp-in", "min_insert": 50,
                          "max_insert": 600},
                 true_insert=[150, 450])
    return t


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout of the benchmark with four tiny cells (1 Mbp genome,
    batches of 128 reads or 64 pairs; one of them over two ranks) added
    as files plus entries."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    # colour-space reads lose about a fifth at their true locus (a base
    # error is two colour errors for the seeds), letter-space ones 5-7%
    def lim(pct, **more):
        return {"record_errors": 0, "lost_pct": pct, **more}
    add_cell(root, "tiny-ls", "ls-illumina-100m", tiny_traffic("reads"),
             lim(25.0))
    add_cell(root, "tiny-cs", "cs-solid-100m", tiny_traffic("cs_reads"),
             lim(40.0, below_best_pct=3.0))
    add_cell(root, "tiny-pairs", "ls-illumina-100m", tiny_traffic("pairs"),
             lim(25.0))
    add_cell(root, "tiny-ranks", "ls-illumina-100m", rank_traffic(),
             lim(25.0), chips=2)
    return root
