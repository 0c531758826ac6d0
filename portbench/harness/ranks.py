"""A cell over several cards: one rank a card, each a process of its own
that runs the program's path on its share of the reads, as SHRiMP2
scales a job across machines (`splitreads.py`, one `gmapper` a node)
and as the program's own runner does it
(`shrimp_tpu_torch/parallel/multihost.py`).

The launcher (the `run.py` process) loads the cell, makes the genome,
builds the program's index if it is missing and makes the pool, so that
no rank builds anything of the inputs; then it starts `chips` ranks,
`run.py` again with `--rank r --world N --coordinator 127.0.0.1:<port
the OS gave> --run-dir <dir> --launcher <its pid>`, looks for the cards
while they start (torch's start takes seconds, which the ranks pay
anyway), and waits.  A rank that exits nonzero, or that has not reached
the window within `open_limit_s`, or not ended within `close_limit_s`
after the window's length, ends the run: the launcher kills every rank
and fails with that rank's standard error.  A launcher that is killed
takes its ranks with it: each rank asks the kernel to kill it when its
parent ends (`die_with`).  The run's directory is a fixed one in the
checkout (`build/portbench/ranks/`), held under a lock for the run,
cleared when a run starts and removed when it ends.

Each rank, in this order: ends with its launcher; fixes its thread
pools (in `run.py`'s `main`) and binds itself to its own cores
(`os.sched_setaffinity`, on its own process); takes card r and joins the group
(`multihost.rank_device`, `multihost.init_distributed`: nccl on cards,
gloo on the CPU); attaches the saved index (`load_mmap`: the pages are
shared between the ranks); builds its mapper on its card; takes its
share of the pool as the program deals reads to ranks
(`multihost.host_read_blocks`, blocks of `deal_block` reads), its whole
batches in an order drawn from the seed; runs the warm-up; meets the
others at a barrier and opens its window when it leaves it; streams
whole batches until the first completion at or after the window's
length; writes its record and its window's SAM lines to the run's
directory (after the window, untimed); meets the others again, leaves
the group, and checks its own modules for JAX.

The window's clock is `time.perf_counter`, CLOCK_MONOTONIC on Linux:
one clock for every process of the host, so the ranks' times are
compared as they are.  The cell's window opens at the first rank's
leaving the barrier (`t0`) and closes at the last rank's last
completion; the merged record (`merge`) holds the reads of all ranks
over that time, so the reader of `reads_per_s` gives the cell's
wall-clock rate.
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np

from harness import core, data, trace, window

PR_SET_PDEATHSIG = 1        # <linux/prctl.h>


def cores_for(rank: int, world: int, cores: list[int]) -> list[int]:
    """Rank `rank`'s equal, contiguous share of the host's `cores`."""
    n = len(cores) // world
    if n == 0:
        return [cores[rank % len(cores)]]
    return cores[rank * n:(rank + 1) * n]


def rank_share(traffic: dict, items: list, truth: np.ndarray, seed: int,
               world: int, rank: int) -> data.Pool:
    """Rank `rank`'s share of the pool, dealt as the program deals a
    read file to its ranks (blocks of `deal_block` reads, round robin),
    its whole batches in an order drawn from the seed: every seed gives
    every rank the same reads."""
    from shrimp_tpu_torch.parallel import multihost
    B = int(traffic["batch_size"])
    mine = np.fromiter(multihost.host_read_blocks(
        iter(range(len(items))), world, rank,
        block=int(traffic["deal_block"])), np.int64)
    sel = mine[data.batch_order(data.rng_for(seed, 2 + rank),
                                len(mine) // B, B)]
    return data.Pool(kind="reads", items=[items[i] for i in sel],
                     truth=truth[sel])


def check_traffic(traffic: dict, chips: int) -> None:
    """A mix over ranks, one rank a card: reads dealt in whole batches,
    the same number of batches to every rank."""
    B, block = int(traffic["batch_size"]), int(traffic["deal_block"])
    if traffic["generator"] == "pairs" or block % B or (
            int(traffic["pool_batches"]) * B) % (block * chips):
        raise ValueError(
            f"a mix over ranks deals reads (not pairs) to one rank a card "
            f"({chips}) in blocks of whole batches that share the pool out "
            f"evenly (deal_block {block}, batch_size {B}, pool_batches "
            f"{traffic['pool_batches']})")


def _sum_by_key(dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def merge(recs: list[dict], t_start: float, launcher: dict) -> dict:
    """The cell's record from its ranks' records: reads, batches, stage
    seconds, counters, SAM seconds and launches summed (so a `*_ms_per
    _kread` stays host seconds of one process a thousand reads); the
    window from the first rank's opening to the last rank's last
    completion; every rank's batch intervals, the first from the common
    opening; each set-up part the slowest rank's, and the launcher's
    own; the device's busy and traced seconds averaged over the cards,
    its seconds by operation summed; and each rank's reads and window,
    for the ranks' spread."""
    t0 = min(r["t0"] for r in recs)
    done = [r["t0"] + np.cumsum(r["batch_ms"]) / 1e3 for r in recs]
    t_end = max(float(d[-1]) for d in done)
    setup_keys = sorted({k for r in recs for k in r["setup"]})
    out = {
        "reads": sum(r["reads"] for r in recs),
        "batches": sum(r["batches"] for r in recs),
        "window_s": t_end - t0,
        "batch_ms": [ms for d in done
                     for ms in window.intervals_ms(t0, d.tolist())],
        "setup_s": t0 - t_start,
        "setup": {**{k: max(r["setup"].get(k, 0.0) for r in recs)
                     for k in setup_keys},
                  "launcher": dict(launcher)},
        "stages": _sum_by_key(r["stages"] for r in recs),
        "stats": _sum_by_key(r["stats"] for r in recs),
        "sam_s": sum(r["sam_s"] for r in recs),
        "launches": {m: [x for r in recs for x in r["launches"].get(m, [])]
                     for m in {m for r in recs for m in r["launches"]}},
        "ranks": [{"rank": r["rank"], "reads": r["reads"],
                   "batches": r["batches"], "window_s": r["window_s"],
                   "cores": r["cores"]} for r in recs],
    }
    if all("device" in r for r in recs):
        n = len(recs)
        out["device"] = {
            "busy_s": sum(r["device"]["busy_s"] for r in recs) / n,
            "window_s": sum(r["device"]["window_s"] for r in recs) / n,
            "by_name": _sum_by_key(r["device"]["by_name"] for r in recs),
            "all_by_name": _sum_by_key(r["device"]["all_by_name"]
                                       for r in recs),
            "idle_by_range": _sum_by_key(r["device"]["idle_by_range"]
                                         for r in recs)}
    return out


# -- a rank ------------------------------------------------------------------

class RankRun(core.Run):
    """One rank's run: the one-card run's set-up, warm-up and window on
    this rank's card and share, opened at the ranks' barrier."""

    def __init__(self, cell, seed, seconds, trace, device, t_start,
                 rank: int, world: int, run_dir: str):
        super().__init__(cell, seed, seconds, trace, device, t_start)
        self.rank, self.world, self.run_dir = rank, world, run_dir

    def path(self, ext: str) -> str:
        return os.path.join(self.run_dir, f"rank{self.rank}.{ext}")

    def make_pool(self, seed: int) -> data.Pool:
        traffic = self.cell.traffic
        items, truth = data.pool_items(
            traffic, self.genome,
            data.pool_path(self.cell.config, traffic, self.cell.root))
        return rank_share(traffic, items, truth, seed, self.world,
                          self.rank)

    def barrier(self) -> None:
        import torch
        import torch.distributed as dist
        dist.barrier(device_ids=[torch.device(self.device).index]
                     if dist.get_backend() == "nccl" else None)

    def meet(self):
        """The window opens as the ranks leave the barrier; the marker
        tells the launcher this rank got there."""
        t = time.perf_counter()
        self.barrier()
        self.setup["barrier_s"] = time.perf_counter() - t
        open(self.path("open"), "w").close()

    def reduce_profile(self, prof):
        super().reduce_profile(prof)
        self.record["device"]["idle_by_range"] = self.idle_by_range

    def go(self, threads: dict, cores: list[int]) -> None:
        """The one-card run's set-up, warm-up and window; then the record
        and the window's SAM lines into the run's directory."""
        super().go(threads)
        rec = dict(self.record, rank=self.rank, t0=self.t0, cores=cores,
                   host=self.host, kind=self.device_name(),
                   memory_peak_bytes=self.peak)
        with open(self.path("sam"), "w") as fh:
            for text in self.texts:
                if text:
                    fh.write(text + "\n")
        with open(self.path("json"), "w") as fh:
            json.dump(rec, fh)


def die_with(launcher: int) -> None:
    """Have the kernel kill this process when its parent ends, however
    it ends (`prctl(PR_SET_PDEATHSIG, SIGKILL)`); a parent that is no
    longer `launcher` has ended already, and this process ends now."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int] + [ctypes.c_ulong] * 4
    libc.prctl.restype = ctypes.c_int
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != launcher:
        raise SystemExit("portbench rank: its launcher has ended")


def rank_main(cell, args, t_start: float, threads: dict) -> int:
    """A rank's process, from `run.py --rank r`."""
    die_with(args.launcher)
    cores = cores_for(args.rank, args.world,
                      sorted(os.sched_getaffinity(0)))
    os.sched_setaffinity(0, cores)
    core.cache_dirs(cell.root)
    import torch
    import torch.distributed as dist
    n = int(cell.config["host_threads"])
    torch.set_num_threads(n)
    torch.set_num_interop_threads(n)
    from shrimp_tpu_torch.parallel import multihost
    device = multihost.rank_device(args.rank)
    multihost.init_distributed(args.coordinator, args.world, args.rank,
                               "nccl" if device.type == "cuda" else "gloo",
                               device)
    try:
        run = RankRun(cell, args.seed, args.seconds, bool(args.trace),
                      str(device), t_start, args.rank, args.world,
                      args.run_dir)
        run.go(threads, cores)
        run.barrier()
    finally:
        dist.destroy_process_group()
    bad = core.forbidden_modules()
    if bad:
        core.log(f"portbench rank {args.rank}: forbidden modules loaded: "
                 f"{bad}")
        return 3
    return 0


# -- the launcher ------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 4000) -> str:
    with open(path, "rb") as fh:
        fh.seek(max(0, os.path.getsize(path) - n))
        return fh.read().decode(errors="replace")


def _end_on_term(signum, frame):
    raise SystemExit(128 + signum)


class Launch(core.BaseRun):
    """The launcher's run: its set-up, the ranks, their merged record,
    and the check of the window's reads of every rank."""

    open_limit_s = 600.0        # a rank's start to the window, first
                                # run of a checkout (kernel builds) too
    close_limit_s = 240.0       # past the window's length, to its end

    def __init__(self, cell, seed, seconds, trace, device, t_start):
        super().__init__(cell, seed, seconds, trace, device, t_start)
        check_traffic(cell.traffic, cell.chips)
        self.world = cell.chips
        self.procs: list = []
        self.run_dir = os.path.join(cell.root, "build", "portbench", "ranks")

    def prepare(self):
        """The genome, the program's index (built if missing) and the
        pool, before any rank starts."""
        self.setup["start_s"] = time.perf_counter() - self.t_start
        self.prepare_inputs()
        t = time.perf_counter()
        self.items, self.truth = data.pool_items(
            self.cell.traffic, self.genome,
            data.pool_path(self.cell.config, self.cell.traffic,
                           self.cell.root))
        self.setup["pool_s"] = time.perf_counter() - t

    def go(self, threads: dict):
        self.prepare()
        self.run()
        print("portbench " + json.dumps(self.host_line()), flush=True)

    def release(self):
        """The launcher holds no program state."""

    def path(self, rank: int, ext: str) -> str:
        return os.path.join(self.run_dir, f"rank{rank}.{ext}")

    def run(self):
        """Start the ranks, wait for them, read what they wrote; every
        rank is ended and waited for, whatever happens.  The run's
        directory is this checkout's, so the run holds a lock on it (the
        kernel drops the lock when the launcher ends, however it ends)."""
        os.makedirs(os.path.dirname(self.run_dir), exist_ok=True)
        with open(self.run_dir + ".lock", "w") as lock:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                raise core.RankFailed(f"another run of this checkout holds "
                                      f"{self.run_dir}") from None
            shutil.rmtree(self.run_dir, ignore_errors=True)
            os.makedirs(self.run_dir)
            old = signal.signal(signal.SIGTERM, _end_on_term)
            try:
                self.start()
                if self.device != "cpu":
                    missing = core.cards_missing(self.world)
                    if missing:
                        raise core.RankFailed(missing)
                self.wait()
                self.collect()
            finally:
                self.stop()
                signal.signal(signal.SIGTERM, old)
                shutil.rmtree(self.run_dir, ignore_errors=True)

    def start(self):
        port = free_port()
        env = dict(os.environ)
        if self.device == "cpu":
            env["SHRIMP_TPU_TORCH_DEVICE"] = "cpu"
        else:
            env.pop("SHRIMP_TPU_TORCH_DEVICE", None)
        run_py = os.path.join(self.cell.root, "portbench", "run.py")
        for r in range(self.world):
            cmd = [sys.executable, run_py, "--workload", self.cell.name,
                   "--seed", str(self.seed), "--seconds", repr(self.seconds),
                   "--trace", str(int(self.trace)), "--rank", str(r),
                   "--world", str(self.world),
                   "--coordinator", f"127.0.0.1:{port}",
                   "--run-dir", self.run_dir, "--launcher", str(os.getpid())]
            with open(self.path(r, "log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    cmd, cwd=self.cell.root, env=env,
                    stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True))
        self.setup["launch_s"] = time.perf_counter() - self.t_start

    def failure(self, rank: int, what: str) -> core.RankFailed:
        return core.RankFailed(f"rank {rank} {what}; its output ends:\n"
                               + _tail(self.path(rank, "log")))

    def wait(self):
        started, opened = time.perf_counter(), None
        while True:
            codes = [p.poll() for p in self.procs]
            for r, c in enumerate(codes):
                if c not in (None, 0):
                    raise self.failure(r, f"exited with code {c}")
            if all(c == 0 for c in codes):
                return
            now = time.perf_counter()
            if opened is None:
                late = [r for r in range(self.world)
                        if not os.path.exists(self.path(r, "open"))]
                if not late:
                    opened = now
                elif now - started > self.open_limit_s:
                    raise self.failure(late[0], "had not reached the window "
                                       f"after {self.open_limit_s:.0f} s")
            elif now - opened > self.seconds + self.close_limit_s:
                r = codes.index(None)
                raise self.failure(
                    r, f"had not ended {self.seconds + self.close_limit_s:.0f}"
                    " s after the window opened")
            time.sleep(0.05)

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        for p in self.procs:
            p.wait()

    def collect(self):
        """The ranks' records merged, their SAM lines, and their pools
        dealt again here for the check."""
        recs, self.texts = [], []
        for r in range(self.world):
            with open(self.path(r, "json")) as fh:
                recs.append(json.load(fh))
            with open(self.path(r, "sam")) as fh:
                self.texts.append(fh.read())
        self.rank_records = recs
        self.record = merge(recs, self.t_start, self.setup)
        self.setup_s = self.record["setup_s"]
        self.peak = max(r["memory_peak_bytes"] for r in recs)
        self.kind = recs[0]["kind"]
        if "device" in self.record:
            d = self.record["device"]
            self.breakdown = {"device_ops": trace.top(d["by_name"]),
                              "idle_gaps": trace.top(d["idle_by_range"])}
        traffic = self.cell.traffic
        self.window_first = (int(traffic["warmup_batches"])
                             * int(traffic["batch_size"]))
        self.pools = [rank_share(traffic, self.items, self.truth, self.seed,
                                 self.world, r) for r in range(self.world)]

    def device_name(self) -> str:
        return self.kind

    def shares(self) -> list:
        """(pool, items its window completed) of each rank."""
        B = int(self.cell.traffic["batch_size"])
        return [(pool, r["batches"] * B)
                for pool, r in zip(self.pools, self.rank_records)]

    def summary(self) -> list[str]:
        """Each rank's window and its costliest stages, and the cell's
        window, for standard error."""
        out = []
        for r in self.rank_records:
            per_k = {k: 1e6 * v / r["reads"] for k, v in
                     dict(r["stages"], sam=r["sam_s"]).items()}
            top = sorted(per_k.items(), key=lambda kv: -kv[1])[:6]
            d = r.get("device")
            idle = ("" if d is None else
                    f", idle {100 * (1 - d['busy_s'] / d['window_s']):.3f}%")
            out.append(
                f"portbench rank {r['rank']}: cores {r['cores'][0]}-"
                f"{r['cores'][-1]}, {r['batches']} batches, {r['reads']} "
                f"reads in {r['window_s']:.3f} s "
                f"({r['reads'] / r['window_s']:.1f} reads/s){idle}; "
                "ms/kread " + ", ".join(f"{k} {v:.1f}" for k, v in top))
        rec = self.record
        out.append(
            f"portbench window: {rec['batches']} batches, {rec['reads']} "
            f"reads in {rec['window_s']:.3f} s over {self.world} ranks; "
            f"set-up {rec['setup_s']:.3f} s (slowest warm-up "
            f"{rec['setup']['warmup_s']:.3f} s, barrier "
            f"{rec['setup']['barrier_s']:.3f} s); check "
            f"{self.check_s:.2f} s of {self.tally.reads} reads, "
            f"{self.tally.records} records")
        return out

    def host_line(self) -> dict:
        """The host, and each rank's cores, threads, candidate path and
        set-up; the launcher's own set-up."""
        return {"host": {"cpu": core.cpu_model(), "cpus": os.cpu_count(),
                         "loadavg": os.getloadavg()},
                "ranks": [{"rank": r["rank"], "cores": r["cores"],
                           **r["host"]} for r in self.rank_records],
                "setup": self.setup}

