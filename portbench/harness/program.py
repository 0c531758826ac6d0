"""What the benchmark takes from the program (`shrimp_tpu_torch`): its
index build and attach, its mapper as the CLI configures it, its
streaming entry and its SAM records.  Imported only after the harness
has fixed the host's thread pools."""

from __future__ import annotations

import os

from harness import data


def build_index(conf: dict, genome: data.Genome, prefix: str) -> None:
    """The index as `gmapper` builds it for mapping (default seeds,
    automatic list trimming), saved with `GenomeIndex.save_mmap`."""
    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch import seeds as seedmod
    from shrimp_tpu_torch.io import fastx
    contigs = [fastx.Contig(name=n, codes=genome.contig(i))
               for i, n in enumerate(genome.names)]
    idx = gindex.build_index(contigs, seedmod.make_seed_set(None),
                             colour_space=conf["mode"] == "cs")
    max_w = max(s.weight for s in idx.seed_set.seeds)
    idx.trim(max(1000, (100 * idx.total_len) // (4 ** max_w)))
    d = os.path.dirname(prefix)
    tmp = d + ".partial"
    data.clear_partial(tmp)
    os.makedirs(tmp)
    idx.save_mmap(os.path.join(tmp, os.path.basename(prefix)))
    os.makedirs(os.path.dirname(d), exist_ok=True)
    os.replace(tmp, d)


def load_index(prefix: str):
    from shrimp_tpu_torch.index import GenomeIndex
    return GenomeIndex.load_mmap(prefix)


def mapper_config(conf: dict, traffic: dict, idx):
    """`gmapper` / `gmapper-cs` at their defaults (the CLI's own
    MapperConfig), with the candidate path the configuration pins."""
    from shrimp_tpu_torch.ops.params import SWParams
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    cs = conf["mode"] == "cs"
    cfg = MapperConfig(colour_space=cs,
                       params=(SWParams.colour_space() if cs
                               else SWParams.letter_space()),
                       qual_delta=int(conf["qual_delta"]))
    cfg.sam_unaligned = False
    cfg.list_cutoff = int(idx.list_cutoff)
    cfg.device_candidates = bool(conf["device_candidates"])
    if traffic["generator"] == "pairs":
        cfg.match_mode_unpaired = 4      # DEF_MATCH_MODE_PAIRED
    return cfg


def make_mapper(conf: dict, traffic: dict, idx, device: str = "cuda"):
    """The mapper of the cell, with every kernel of the path loaded."""
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    cfg = mapper_config(conf, traffic, idx)
    if traffic["generator"] == "pairs":
        from shrimp_tpu_torch.pipeline.paired import (PAIR_MODE_NAMES,
                                                      PairedConfig,
                                                      PairedMapper)
        p = traffic["pairing"]
        mode = PAIR_MODE_NAMES.index(p["mode"])
        pcfg = PairedConfig(pair_mode=mode, min_insert_size=p["min_insert"],
                            max_insert_size=p["max_insert"],
                            match_mode=cfg.match_mode_unpaired)
        mapper = PairedMapper(idx, cfg, pcfg, device=device)
    else:
        mapper = Mapper(idx, cfg, device=device)
    if device != "cpu":
        load_kernels(kernels_of(conf, traffic))
    return mapper


def kernels_of(conf: dict, traffic: dict) -> list[str]:
    """The kernel sources the cell's path launches."""
    names = ["sw_vector", "sw_full_cs" if conf["mode"] == "cs" else "sw_full"]
    if conf["device_candidates"] and traffic["generator"] != "pairs":
        names.append("candidates_device")
    return names


def load_kernels(names: list[str]) -> None:
    """Build (on a checkout's first run) and load the kernels."""
    import importlib

    from shrimp_tpu_torch import _build
    _build.load_all(names)
    for n in names:
        importlib.import_module(f"shrimp_tpu_torch.ops.{n}")._lib()


def stream(mapper, traffic: dict, items):
    """The program's streaming entry over an endless item iterator: one
    result per read (per pair in paired traffic), in input order."""
    if traffic["generator"] == "pairs":
        return mapper.map_pair_stream(items,
                                      batch_size=int(traffic["batch_size"]))
    return mapper.map_stream(items, batch_size=int(traffic["batch_size"]),
                             n_workers=int(traffic["workers"]))


def sam_lines(mapper, traffic: dict, result) -> list[str]:
    if traffic["generator"] == "pairs":
        return [r.line() for r in mapper.sam_records_pair(result)]
    re_e, hits = result
    return [r.line() for r in mapper.sam_records(re_e, hits)]


def stage_seconds(mapper) -> dict:
    return {k: v.secs for k, v in mapper.tel.stages.items()}


def candidate_path(mapper) -> str:
    cfg = mapper.cfg
    if not hasattr(mapper, "pcfg") and cfg.device_candidates is True:
        return "device (K10)"
    return "host (native C)"
