"""A cell and its files, found by the names in BENCHMARK.json.

A configuration is `configs/<config>.json`, a traffic mix
`traffic/<traffic>.json`, a metric `metrics/<metric>.py`, and the limits
of the numbers that decide a cell's `correct` `checks/<workload>.json`.
Nothing here imports numpy or torch: the harness reads the cell before
it fixes the host's thread pools.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)            # portbench/
ROOT = os.path.dirname(BENCH_DIR)            # the checkout


@dataclass
class Cell:
    root: str
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    chips: int
    limits: dict


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def metric_applies(metric: dict, workload: str) -> bool:
    """A metric without `workloads` is reported in every cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None,
              root: str = ROOT) -> Cell:
    """The workload `name` with its configuration, traffic and the
    metrics it reports; raises KeyError for a name not in the manifest."""
    manifest = manifest or load_manifest(root)
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    conf_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, conf_entry["file"]))
    bench = os.path.join(root, "portbench")
    traffic = _read_json(os.path.join(bench, "traffic",
                                      f"{w['traffic']}.json"))
    return Cell(
        root=root, name=name, workload=w, config=config, traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"]
                    if metric_applies(m, name)],
        per_layer=[m for m in manifest["per_layer"]
                   if metric_applies(m, name)],
        chips=int(w["chips"]),
        limits=_read_json(os.path.join(bench, "checks", f"{name}.json")))


def load_metric(name: str, root: str = ROOT):
    """The reader module of metric `name` (`metrics/<name>.py`)."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
