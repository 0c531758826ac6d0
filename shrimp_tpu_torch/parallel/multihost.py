"""Multi-process runtime, the cluster axis (reference README:1246-1474); the
counterpart of `shrimp_tpu/parallel/multihost.py`.

The reference scales across machines with shell scripts: shard reads
(`splitreads.py`), run independent gmapper jobs, merge SAM files
(`mergesam`).  Here the processes form a `torch.distributed` group: each
rank takes an interleaved block of the read stream, maps it against its
(whole or in-process sharded) index, writes a rank-ordered output file,
and rank 0 assembles the files in read order: deterministic final SAM,
identical to the single-process run.

A rank maps on card `process_id % device_count` (its `--genome-shards`
mesh starts there), or on the CPU when SHRIMP_TPU_TORCH_DEVICE=cpu.  The
group's backend is `nccl` on cards and `gloo` on the CPU unless
`--backend` says otherwise; NCCL refuses two ranks on one card, so such a
group exits 1 and names `--backend gloo`, with which ranks still map on
their cards and only the small host payloads (z sums, the barrier) cross
gloo.

Usage (one command per process):
    python -m shrimp_tpu_torch.parallel.multihost \\
        --coordinator host0:9999 --num-processes 4 --process-id $RANK \\
        [--backend nccl|gloo] --out out.sam -- -Q reads.fq genome.fa

The mapping arguments after `--` are standard gmapper arguments.
"""

from __future__ import annotations

import os
import sys


def rank_device(process_id: int):
    """The device a rank maps on: the CPU when SHRIMP_TPU_TORCH_DEVICE=cpu
    asks for it, else card process_id % device_count."""
    import torch
    if os.environ.get("SHRIMP_TPU_TORCH_DEVICE", "").startswith("cpu"):
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise SystemExit("multihost: no CUDA device; map on the CPU with "
                         "SHRIMP_TPU_TORCH_DEVICE=cpu")
    return torch.device("cuda", process_id % n)


def check_backend(backend: str, device, ranks_per_host: int,
                  device_count: int) -> None:
    """Refuse (SystemExit) a group NCCL cannot form: ranks off the cards,
    or two ranks of one host on one card (ranks take card
    rank % device_count).  Never switches backend by itself."""
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise SystemExit("multihost: --backend nccl needs ranks on cards; "
                         "use --backend gloo on the CPU")
    if ranks_per_host > device_count:
        raise SystemExit(
            f"multihost: {ranks_per_host} ranks share {device_count} "
            "card(s) and NCCL refuses two ranks on one card; run with "
            "--backend gloo (the ranks still map on their cards)")


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str, device) -> None:
    """torch.distributed.init_process_group over TCP at `coordinator`
    (host:port), after `check_backend`."""
    import torch
    import torch.distributed as dist
    # ranks of one host: torchrun's LOCAL_WORLD_SIZE where set
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    check_backend(backend, device, per_host,
                  torch.cuda.device_count() if device.type == "cuda" else 0)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def host_read_blocks(reads_iter, num_processes: int, process_id: int,
                     block: int = 1000, paired: bool = False):
    """Deterministic rank-sharded read intake: the stream is cut into
    `block`-read chunks dealt round-robin to ranks (the reference's
    splitreads.py dealing, paired-aware so mates stay together)."""
    if paired and block % 2:
        block += 1
    buf = []
    chunk_id = 0
    for rec in reads_iter:
        buf.append(rec)
        if len(buf) == block:
            if chunk_id % num_processes == process_id:
                yield from buf
            buf = []
            chunk_id += 1
    if buf and chunk_id % num_processes == process_id:
        yield from buf


def rank_output_path(out: str, process_id: int) -> str:
    return f"{out}.rank{process_id:05d}"


def concat_rank_outputs(out: str, num_processes: int,
                        reads_order=None) -> None:
    """Rank-0 final assembly.  With `reads_order` (the read-name stream),
    records are re-interleaved into original read order, the exact
    analogue of mergesam's reads-file-driven ordering
    (mergesam/fastx_readnames.c); without it, rank files are concatenated
    in rank order (block-deterministic)."""
    parts = [rank_output_path(out, p) for p in range(num_processes)]
    if reads_order is None:
        with open(out, "w") as fh:
            for p in parts:
                with open(p) as pf:
                    fh.write(pf.read())
        return
    # read-order interleave: index each rank file by QNAME
    by_name: dict[str, list[str]] = {}
    header: list[str] = []
    for p in parts:
        with open(p) as pf:
            for line in pf:
                line = line.rstrip("\n")
                if line.startswith("@"):
                    if p == parts[0]:
                        header.append(line)
                    continue
                by_name.setdefault(line.split("\t", 1)[0], []).append(line)
    with open(out, "w") as fh:
        for line in header:
            fh.write(line + "\n")
        for name in reads_order:
            for line in by_name.get(name, ()):
                fh.write(line + "\n")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    coordinator = "127.0.0.1:9357"
    num_processes = 1
    process_id = 0
    out = "out.sam"
    block = 1000
    genome_axis = False
    backend = None
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--coordinator":
            coordinator = argv[i + 1]; i += 2
        elif a == "--num-processes":
            num_processes = int(argv[i + 1]); i += 2
        elif a == "--process-id":
            process_id = int(argv[i + 1]); i += 2
        elif a == "--out":
            out = argv[i + 1]; i += 2
        elif a == "--block":
            block = int(argv[i + 1]); i += 2
        elif a == "--genome-axis":
            genome_axis = True; i += 1
        elif a == "--backend":
            backend = argv[i + 1]; i += 2
            if backend not in ("nccl", "gloo"):
                sys.stderr.write(f"error: unknown backend {backend}\n")
                return 1
        elif a == "--":
            rest = argv[i + 1:]
            break
        else:
            sys.stderr.write(f"error: unknown multihost option {a}\n")
            return 1

    try:
        device = rank_device(process_id)
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if num_processes > 1 or genome_axis:
            init_distributed(coordinator, num_processes, process_id, backend,
                             device)
    except SystemExit as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    try:
        if genome_axis:
            # the genome axis spans the processes: each rank holds one
            # index shard and maps the FULL read stream; z statistics
            # cross the process group (parallel/genome_axis.py)
            from shrimp_tpu_torch.parallel import genome_axis as ga
            return ga.run(rest, out, num_processes, process_id, device)
        return _map_read_share(rest, out, num_processes, process_id, block,
                               device)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _map_read_share(rest, out, num_processes, process_id, block,
                    device) -> int:
    """Run gmapper over this rank's read share: the reads file is dealt
    up front into a rank-local temp file, then the standard CLI maps it."""
    import tempfile

    from shrimp_tpu_torch.io import fastx

    reads_path = None
    for tok in rest:
        if not tok.startswith("-") and os.path.exists(tok):
            reads_path = tok
            break
    if reads_path is None:
        sys.stderr.write("error: no reads file found in gmapper args\n")
        return 1
    fastq = fastx.detect_fastq(reads_path)
    paired = ("-p" in rest or "--pair-mode" in rest)
    fd, shard_path = tempfile.mkstemp(suffix=".fq" if fastq else ".fa")
    os.close(fd)
    recs = host_read_blocks(
        fastx.iter_reads(reads_path, fastq=fastq),
        num_processes, process_id, block=block, paired=paired)
    if fastq:
        fastx.write_fastq(shard_path, recs)
    else:
        fastx.write_fasta(shard_path, list(recs))

    rank_out = rank_output_path(out, process_id)
    gm_args = ["gmapper"] + [shard_path if t == reads_path else t
                             for t in rest]
    from shrimp_tpu_torch import gmapper
    with open(rank_out, "w") as fh:
        old = sys.stdout
        sys.stdout = fh
        try:
            rc = gmapper.main(gm_args, device=str(device))
        finally:
            sys.stdout = old
    os.unlink(shard_path)
    if rc != 0:
        return rc

    # completion marker + rank-0 assembly.  The markers live on the
    # shared filesystem (the reference's cluster assumption); every rank
    # waits for all of them, then meets the others at the group's
    # barrier before the group is torn down.
    with open(rank_out + ".done", "w") as fh:
        fh.write("ok\n")
    # EVERY rank waits (not just rank 0): leaving early would tear the
    # process group down while slower ranks still map
    from shrimp_tpu_torch.parallel.genome_axis import _wait_for
    _wait_for([rank_output_path(out, p) + ".done"
               for p in range(num_processes)])
    if num_processes > 1:
        import torch.distributed as dist
        dist.barrier(device_ids=[device.index]
                     if dist.get_backend() == "nccl" else None)
    if process_id == 0:
        names = [r.name for r in fastx.iter_reads(reads_path, fastq=fastq)]
        if paired:
            # paired SAM lines carry the common-prefix-trimmed qname:
            # order by the same key the emitter used
            from shrimp_tpu_torch.pipeline.paired import common_qname
            names = [common_qname(names[i], names[i + 1])
                     for i in range(0, len(names) - 1, 2)]
        concat_rank_outputs(out, num_processes, reads_order=names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
