"""The port's multi-process runner (`shrimp_tpu_torch.parallel.multihost`)
on the CPU: two ranks of a gloo group map disjoint read shares and rank 0
assembles them in read order, byte-equal to the single-process goldens
(the three cases of tests/test_multihost.py); and the refusal of an nccl
group that would put two ranks on one card."""

import os
import socket
import subprocess
import sys

import pytest
import torch

from shrimp_tpu_torch.parallel import multihost

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(out: str, runner_args: list, gmapper_args: list,
              n: int = 2) -> list:
    """`python -m shrimp_tpu_torch.parallel.multihost` as ranks 0..n-1 on
    the CPU; returns their (rc, stderr)."""
    env = dict(os.environ, SHRIMP_TPU_TORCH_DEVICE="cpu")
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "shrimp_tpu_torch.parallel.multihost",
         "--coordinator", coord, "--num-processes", str(n),
         "--process-id", str(rank), "--out", out, *runner_args,
         "--", *gmapper_args],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE) for rank in range(n)]
    res = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        res.append((p.returncode, err.decode()))
    return res


def body(path: str) -> list:
    with open(path) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


def golden_body(name: str) -> list:
    return body(os.path.join(GOLDEN, name))


CASES = {
    "unpaired": (["--block", "50"], ["-Q"], "golden_reads.fq",
                 "golden_unpaired.sam"),
    "paired": (["--block", "20"], ["-Q", "-p", "opp-in"],
               "golden_pairs.fq", "golden_paired.sam"),
    # the reads x genome grid: each rank maps its share on a mesh of two
    # genome shards
    "two_genome_shards": (["--block", "50"], ["-Q", "--genome-shards", "2"],
                          "golden_reads.fq", "golden_unpaired.sam"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_process_mapping(case, tmp_path):
    runner, flags, reads, gold = CASES[case]
    out = str(tmp_path / "mh.sam")
    for rc, err in run_ranks(out, runner, flags + [
            os.path.join(GOLDEN, reads),
            os.path.join(GOLDEN, "golden_genome.fa")]):
        assert rc == 0, err[-2000:]
        assert "PyTorch port on cpu" in err
    assert body(out) == golden_body(gold)
    assert sorted(os.listdir(tmp_path)) == [
        "mh.sam", "mh.sam.rank00000", "mh.sam.rank00000.done",
        "mh.sam.rank00001", "mh.sam.rank00001.done"]


def test_nccl_refuses_two_ranks_on_one_card():
    card = torch.device("cuda", 0)
    with pytest.raises(SystemExit, match="--backend gloo"):
        multihost.check_backend("nccl", card, ranks_per_host=2,
                                device_count=1)
    with pytest.raises(SystemExit, match="--backend gloo"):
        multihost.check_backend("nccl", torch.device("cpu"), 1, 0)
    multihost.check_backend("nccl", card, ranks_per_host=2, device_count=2)
    multihost.check_backend("gloo", card, ranks_per_host=4, device_count=1)


def test_nccl_on_the_cpu_exits_1(monkeypatch, capsys):
    """No silent switch: asked for nccl where the ranks map on the CPU,
    the runner exits 1 before it forms a group."""
    monkeypatch.setenv("SHRIMP_TPU_TORCH_DEVICE", "cpu")
    rc = multihost.main(["--num-processes", "2", "--process-id", "0",
                         "--backend", "nccl", "--", "-Q", "reads.fq",
                         "genome.fa"])
    assert rc == 1
    assert "--backend gloo" in capsys.readouterr().err
