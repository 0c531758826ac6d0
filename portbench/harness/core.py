"""One run of one cell: set-up, warm-up, a window of whole batches, the
check of what the window produced, and the result line.

    python3 portbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the numbers
compared to decide `correct` are the last lines of standard error.  A
cell over several cards (`chips` > 1) runs as ranks, one process a card
(`harness/ranks.py`); a cell on one card runs here, in this process.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from harness import cell as cellmod

FORBIDDEN = ("jax", "jaxlib", "flax", "shrimp_tpu")
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
               "NUMEXPR_NUM_THREADS", "VECLIB_MAXIMUM_THREADS")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pin_threads(n: int) -> dict:
    """The host's thread pools at `n` threads, before numpy and torch
    start theirs; returns the settings, for the record."""
    for v in THREAD_VARS:
        os.environ[v] = str(n)
    return {v: n for v in THREAD_VARS}


def cache_dirs(root: str) -> dict:
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(root, "build", "portbench")
    dirs = {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}
    os.environ.update(dirs)
    return dirs


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole: `shrimp_tpu_torch` is not `shrimp_tpu`."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class RankFailed(RuntimeError):
    """A rank of a cell over several cards exited nonzero, or did not
    reach or end its window in time."""


class BaseRun:
    """What every run of a cell has: its cell, seed and set-up parts,
    its inputs (`prepare_inputs`), and the check of the window's items
    of every process that mapped (`shares`: one on one card, a rank a
    card over several, `harness/ranks.py`)."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.setup = {}
        self.record = {}
        self.trace_on = False
        self.breakdown = None

    # -- set-up ----------------------------------------------------------
    def prepare_inputs(self):
        """The genome, and the program's index on disk (built if
        missing)."""
        import shrimp_tpu_torch  # noqa: F401  (fails first without it)

        from harness import data, program
        conf = self.cell.config
        t = time.perf_counter()
        self.genome = data.ensure_genome(conf, self.cell.root)
        self.setup["genome_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.index_prefix = data.index_prefix(conf, self.cell.root)
        if not os.path.exists(self.index_prefix + ".mmap.json"):
            program.build_index(conf, self.genome, self.index_prefix)
        self.setup["index_s"] = time.perf_counter() - t

    # -- the check -------------------------------------------------------
    def sample(self):
        """`sample` items drawn from the seed among the window's items of
        every share, each with the program's lines."""
        import numpy as np

        from harness import data
        from reference.judge import Item
        shares = self.shares()
        edges = np.cumsum([0] + [n for _, n in shares])
        k = min(int(self.cell.traffic["sample"]), int(edges[-1]))
        rng = data.rng_for(self.seed, 1)
        picks = np.sort(rng.choice(int(edges[-1]), size=k, replace=False))
        want = {}
        for p in picks:
            r = int(np.searchsorted(edges, p, side="right")) - 1
            pool = shares[r][0]
            g = self.window_first + int(p - edges[r])
            P = len(pool.items)
            item = pool.items[g % P]
            reads = list(item) if pool.kind == "pairs" else [item]
            name = (reads[0][0].rsplit("/", 1)[0] + f"_{g // P}"
                    if pool.kind == "pairs"
                    else f"{reads[0][0]}_{g // P}")
            want[name] = Item(reads=reads, truth=int(pool.truth[g % P]),
                              lines=[])
        for text in self.texts:
            for ln in text.split("\n"):
                q = ln.split("\t", 1)[0]
                if q in want:
                    want[q].lines.append(ln)
        return list(want.values())

    def judge_args(self) -> tuple:
        conf, traffic = self.cell.config, self.cell.traffic
        paired = traffic.get("pairing")
        if paired:
            paired = {"limits": (paired["min_insert"], paired["max_insert"]),
                      "mode": paired["mode"],
                      "insert": tuple(traffic["true_insert"])}
        return self.genome, conf["mode"], paired, int(conf["qual_delta"])

    def check(self) -> dict:
        from reference import judge
        t = time.perf_counter()
        self.tally = judge.judge(*self.judge_args(), self.sample())
        self.check_s = time.perf_counter() - t
        return self.tally.numbers()

    def judge_numbers(self) -> dict:
        """The numbers compared, for the window just driven."""
        from reference import judge
        return judge.judge(*self.judge_args(), self.sample()).numbers()

    def readings(self) -> dict:
        """The numbers of the program and of the controls (the reference
        in its place at lower precision) on the same sampled items."""
        from reference import judge
        items = self.sample()
        out = {"program": judge.judge(*self.judge_args(), items).numbers()}
        for tag, prec in (("control", judge.LOW),
                          ("control_float32", judge.LOW_FLOAT)):
            out[tag] = judge.control(*self.judge_args(), items,
                                     prec).numbers()
        return out


class Run(BaseRun):
    """The state of one run, filled as it goes: this process maps the
    reads on its card."""

    # -- set-up ----------------------------------------------------------
    def prepare(self):
        # the interpreter, torch and the card's start, before the cell's
        # own set-up
        self.setup["start_s"] = time.perf_counter() - self.t_start
        self.prepare_program()
        self.prepare_pool(self.seed)

    def prepare_program(self):
        """The inputs, the program's index attached, and its mapper."""
        from harness import program
        self.prepare_inputs()
        t = time.perf_counter()
        self.idx = program.load_index(self.index_prefix)
        self.setup["index_s"] += time.perf_counter() - t
        t = time.perf_counter()
        self.mapper = program.make_mapper(self.cell.config,
                                          self.cell.traffic, self.idx,
                                          device=self.device)
        self.setup["mapper_s"] = time.perf_counter() - t

    def prepare_pool(self, seed: int):
        """The seed's reads, kept out of the program's garbage
        collections: the pool lives for the whole run."""
        self.seed = seed
        t = time.perf_counter()
        gc.unfreeze()
        self.pool = None
        gc.collect()
        self.pool = self.make_pool(seed)
        self.setup["pool_s"] = time.perf_counter() - t
        gc.collect()
        gc.freeze()

    def make_pool(self, seed: int):
        from harness import data
        return data.make_pool(
            self.cell.traffic, self.genome, seed,
            data.pool_path(self.cell.config, self.cell.traffic,
                           self.cell.root))

    # -- the run ---------------------------------------------------------
    def go(self, threads: dict):
        """Set-up, the host line, warm-up and window, and the card's
        peak memory."""
        import torch
        on_card = self.device != "cpu"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        self.prepare()
        self.host = host_line(self, threads)
        print("portbench " + json.dumps(self.host), flush=True)
        self.drive()
        self.peak = torch.cuda.max_memory_allocated() if on_card else 0

    def release(self):
        """The program's state goes before the reference runs."""
        import torch
        del self.mapper, self.idx
        gc.unfreeze()
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def summary(self) -> list[str]:
        """The window's details, for standard error."""
        rec, ms = self.record, sorted(self.record["batch_ms"])
        return [f"portbench window: {rec['batches']} batches, "
                f"{rec['reads']} reads in {rec['window_s']:.3f} s "
                f"(batch ms min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} "
                f"max {ms[-1]:.1f}; process CPU "
                f"{self.host_window['process_cpu_s']:.2f} s, stolen "
                f"{self.host_window['steal_s']:.2f} s); set-up "
                f"{self.setup_s:.3f} s (warm-up {self.setup['warmup_s']:.3f}"
                f" s); check {self.check_s:.2f} s of {self.tally.reads} "
                f"reads, {self.tally.records} records"]

    # -- batches ---------------------------------------------------------
    def batches(self, stream, n_items: int):
        """One batch at a time: its results taken from the stream, its
        SAM lines made; yields (lines as one text, seconds formatting,
        completion time)."""
        import itertools

        from harness import program
        traffic = self.cell.traffic
        while True:
            results = list(itertools.islice(stream, n_items))
            t = time.perf_counter()
            with self.span("bench.sam"):
                lines = [ln for r in results
                         for ln in program.sam_lines(self.mapper, traffic,
                                                     r)]
            done = time.perf_counter()
            yield "\n".join(lines), done - t, done

    def span(self, name: str):
        """A profiler range in the traced run; nothing otherwise."""
        import contextlib

        import torch
        return (torch.profiler.record_function(name) if self.trace_on
                else contextlib.nullcontext())

    def drive(self):
        """Warm-up, then the window; the window's SAM text is kept."""
        import torch

        from harness import program, trace, window
        traffic = self.cell.traffic
        B = int(traffic["batch_size"])
        per_batch = B * (2 if traffic["generator"] == "pairs" else 1)
        stream = program.stream(self.mapper, traffic, self.pool.cycled())
        steps = self.batches(stream, B)
        t = time.perf_counter()
        for _ in range(int(traffic["warmup_batches"])):
            next(steps)
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.setup["warmup_s"] = time.perf_counter() - t
        stages0 = program.stage_seconds(self.mapper)
        stats0 = dict(self.mapper.stats)
        launches: dict = {}
        prof = None
        if self.trace:
            hooks = {}
            for m in self.cell.per_layer:
                mod = cellmod.load_metric(m["name"], self.cell.root)
                if getattr(mod, "HOOKS", None):
                    hooks[m["name"]] = mod.HOOKS
            prof = self.profiler()
            prof.__enter__()
            hooked = trace.launch_hooks(hooks, launches)
            hooked.__enter__()
        self.meet()
        if self.trace:
            span = torch.profiler.record_function("bench.window")
            span.__enter__()
        self.window_first = int(traffic["warmup_batches"]) * B
        host0 = host_times()
        t0 = self.t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        texts, done_at, sam_s = [], [], 0.0
        self.trace_on = self.trace
        while True:
            with self.span("bench.batch"):
                text, fmt, t = next(steps)
            texts.append(text)
            done_at.append(t)
            sam_s += fmt
            if window.closes(t0, t, self.seconds):
                break
        self.trace_on = False
        if self.trace:
            span.__exit__(None, None, None)
            hooked.__exit__(None, None, None)
            if self.device != "cpu":
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        stream.close()
        if self.device != "cpu":
            torch.cuda.synchronize()
        n_batches, t_end = len(done_at), done_at[-1]
        host1 = host_times()
        self.host_window = {k: host1[k] - host0[k] for k in host0}
        stages1 = program.stage_seconds(self.mapper)
        self.texts = texts
        self.record = {
            "reads": n_batches * per_batch,
            "batches": n_batches,
            "window_s": t_end - t0,
            "batch_ms": window.intervals_ms(t0, done_at),
            "setup_s": self.setup_s,
            "setup": dict(self.setup),
            "stages": {k: stages1[k] - stages0.get(k, 0.0) for k in stages1},
            "stats": {k: self.mapper.stats[k] - stats0.get(k, 0)
                      for k in self.mapper.stats},
            "sam_s": sam_s,
            "launches": trace.resolve(launches),
        }
        if prof is not None:
            self.reduce_profile(prof)

    def device_name(self) -> str:
        import torch
        return (torch.cuda.get_device_name(torch.device(self.device))
                if self.device != "cpu" else "cpu")

    def meet(self):
        """Where the window opens; one process meets no one."""

    def profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def reduce_profile(self, prof):
        from harness import trace
        events = prof.events()
        win = [e for e in events if e.name == "bench.window"]
        lo, hi = win[0].time_range.start, win[0].time_range.end
        red = trace.reduce_events(events, lo, hi)
        self.record["device"] = {
            "busy_s": red["busy_s"], "window_s": (hi - lo) / 1e6,
            "by_name": red["by_name"], "all_by_name": red["all_by_name"]}
        self.idle_by_range = red["idle_by_range"]
        self.breakdown = {"device_ops": trace.top(red["by_name"]),
                          "idle_gaps": trace.top(red["idle_by_range"])}

    def shares(self) -> list:
        """(pool, items its window completed) of each process that
        mapped: this one."""
        return [(self.pool, len(self.texts) * int(self.cell.traffic[
            "batch_size"]))]


def host_times() -> dict:
    """This process's CPU seconds and the machine's CPU seconds stolen
    by its hypervisor (/proc/stat), to read a noisy run by."""
    out = {"process_cpu_s": time.process_time(), "steal_s": 0.0}
    try:
        with open("/proc/stat") as fh:
            f = fh.readline().split()
        out["steal_s"] = int(f[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when none is over."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), out


def read_metrics(cell, trace: bool, record: dict) -> dict:
    """The cell's end-to-end metrics, or with trace its per-layer ones,
    read from the record; metrics whose reader finds nothing are left
    out."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cellmod.load_metric(m["name"], cell.root).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def result_line(run: BaseRun, correct: bool, checks: dict, peak: int) -> dict:
    """The last line: the cell's metrics (`read_metrics`), its device,
    and last the numbers compared."""
    metrics = read_metrics(run.cell, run.trace, run.record)
    device = {"platform": "gpu" if run.device != "cpu" else "cpu",
              "kind": run.device_name(),
              "count": run.cell.chips, "memory_peak_bytes": int(peak)}
    if run.trace and "device" in run.record:
        device["busy_s"] = run.record["device"]["busy_s"]
        device["window_s"] = run.record["device"]["window_s"]
    line = {"correct": bool(correct), "attempted": run.record["reads"],
            "failed": int(run.tally.bad_items), "metrics": metrics,
            "device": device}
    if run.breakdown is not None:
        line["breakdown"] = run.breakdown
    line["checks"] = checks
    return line


def cpu_model() -> dict:
    """The host CPU's model and its cores' mean clock now (/proc/cpuinfo):
    hosts of other models run the host-paced cells at other speeds."""
    names, mhz = set(), []
    try:
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                k, _, v = ln.partition(":")
                if k.strip() == "model name":
                    names.add(v.strip())
                elif k.strip() == "cpu MHz":
                    mhz.append(float(v))
    except (OSError, ValueError):
        pass
    return {"model": sorted(names),
            "mhz": sum(mhz) / len(mhz) if mhz else None}


def host_line(run: Run, threads: dict) -> dict:
    """What a noisy check needs to be read later: the host's CPU and
    cores, its load, the thread settings and the candidate path
    taken."""
    import torch

    from harness import program
    return {"host": {"cpu": cpu_model(), "cpus": os.cpu_count(),
                     "affinity": len(os.sched_getaffinity(0)),
                     "loadavg": os.getloadavg(),
                     "threads": {**threads,
                                 "torch": torch.get_num_threads(),
                                 "torch_interop":
                                     torch.get_num_interop_threads()}},
            "candidates": program.candidate_path(run.mapper),
            "setup": run.setup}


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, threads: dict) -> tuple[dict, dict]:
    """Everything after the look for a card: the run (in this process on
    one card; as ranks, `harness/ranks.py`, over several), the check,
    and the result line and the numbers compared."""
    if cell.chips > 1:
        from harness import ranks
        run = ranks.Launch(cell, seed, seconds, trace, device, t_start)
    else:
        run = Run(cell, seed, seconds, trace, device, t_start)
    run.go(threads)
    run.release()
    numbers = run.check()
    correct, checks = verdict(numbers, cell.limits)
    for msg in run.summary():
        log(msg)
    for msg in run.tally.notes:
        log(f"portbench note: {msg}")
    return result_line(run, correct, checks, run.peak), checks


def cards_missing(chips: int) -> str | None:
    """What is missing when the host has fewer CUDA devices than the
    cell asks for."""
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        return (f"portbench: the cell needs {chips} CUDA device(s); "
                f"found {found}")
    return None


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell over several cards (harness/ranks.py starts them)
    for flag, kind in (("--rank", int), ("--world", int),
                       ("--coordinator", str), ("--run-dir", str),
                       ("--launcher", int)):
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cell = cellmod.load_cell(args.workload)
    threads = pin_threads(int(cell.config["host_threads"]))
    if args.rank is not None:
        from harness import ranks
        return ranks.rank_main(cell, args, t_start, threads)
    cache_dirs(cell.root)
    if cell.chips == 1:
        # over several cards the launcher looks for them while its ranks
        # start (harness/ranks.py)
        import torch
        torch.set_num_threads(int(cell.config["host_threads"]))
        torch.set_num_interop_threads(int(cell.config["host_threads"]))
        missing = cards_missing(cell.chips)
        if missing:
            log(missing)
            return 2
    try:
        line, checks = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda", t_start, threads)
    except RankFailed as exc:
        log(f"portbench: {exc}")
        return 4
    bad = forbidden_modules()
    if bad:
        log(f"portbench: forbidden modules loaded: {bad}")
        return 3
    for k, v in checks.items():
        log(f"portbench check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(line), flush=True)
    return 0
