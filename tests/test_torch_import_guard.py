"""The PyTorch port stands alone: it maps the golden reads in a process
where jax cannot be imported (letter and colour space), importing its
entry points loads neither jax nor any module of the JAX package, and no
module of the port (nor chip_smoke.py) imports jax, the JAX package or
its benchmark scripts."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = r"""
import sys
sys.modules["jax"] = None          # any "import jax" now raises
import os
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.pipeline.options import MapperConfig
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch import gmapper  # noqa: F401
g = os.path.join("tests", "golden")
idx = gindex.build_index(list(fastx.iter_contigs(
    os.path.join(g, "golden_genome.fa"))))
m = Mapper(idx, MapperConfig(qual_delta=64), device="cpu")
reads = [(r.name, r.seq, r.qual)
         for r in fastx.iter_reads(os.path.join(g, "golden_reads.fq"))]
lines = [rec.line() for e, hits in m.map_batch(reads)
         for rec in m.sam_records(e, hits)]
with open(os.path.join(g, "golden_unpaired.sam")) as fh:
    want = [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]
assert lines == want, "SAM differs"
loaded = sorted(k for k, v in sys.modules.items()
                if (k == "jax" or k.startswith("jax.")) and v is not None)
assert not loaded, loaded
print("mapped", len(lines))
"""


def test_maps_goldens_without_jax():
    r = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "mapped 193"


_PROGRAM_CS = r"""
import sys
sys.modules["jax"] = None          # any "import jax" now raises
import os
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline.options import MapperConfig
from shrimp_tpu_torch.pipeline.mapper import Mapper
g = os.path.join("tests", "golden")
idx = gindex.build_index(list(fastx.iter_contigs(
    os.path.join(g, "golden_genome.fa"))), colour_space=True)
m = Mapper(idx, MapperConfig(colour_space=True,
                             params=SWParams.colour_space(), qual_delta=33),
           device="cpu")
reads = [(r.name, r.seq, r.qual)
         for r in fastx.iter_reads(os.path.join(g, "golden_reads_cs.fq"))]
lines = [rec.line() for e, hits in m.map_batch(reads)
         for rec in m.sam_records(e, hits)]
with open(os.path.join(g, "golden_cs.sam")) as fh:
    want = [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]
assert lines == want, "SAM differs"
loaded = sorted(k for k, v in sys.modules.items()
                if (k == "jax" or k.startswith("jax.")) and v is not None)
assert not loaded, loaded
print("mapped", len(lines))
"""


def test_maps_cs_golden_without_jax():
    """Colour space too: post_sw, the CS SAM records and the 4-layer DP
    need no jax."""
    r = subprocess.run([sys.executable, "-c", _PROGRAM_CS], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "mapped 181"


_PROGRAM_IMPORTS = r"""
import sys
import shrimp_tpu_torch.gmapper
import shrimp_tpu_torch.ops.candidates_device
import shrimp_tpu_torch.pipeline.mapper
import shrimp_tpu_torch.pipeline.paired
import shrimp_tpu_torch.utils.golden_cli
import shrimp_tpu_torch.utils.synth
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "shrimp_tpu", "bench",
                                    "bench_grid"))
assert not bad, bad
print("clean")
"""


def test_entry_points_load_no_jax_package():
    """In a fresh process where jax is installed and importable, the
    port's entry points load no jax module and no module of the JAX
    package (whose `__init__` imports jax)."""
    import jax  # noqa: F401  (the check means something only with jax here)
    r = subprocess.run([sys.executable, "-c", _PROGRAM_IMPORTS], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "clean"


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "shrimp_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 25
    assert os.path.join(REPO, "shrimp_tpu_torch", "pipeline",
                        "paired.py") in files
    return files


def _offenders(pat):
    out = []
    for path in _port_sources():
        with open(path) as fh:
            if pat.search(fh.read()):
                out.append(os.path.relpath(path, REPO))
    return out


def test_no_jax_import_in_the_port():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)|__import__\(\s*['\"]jax",
                     re.MULTILINE)
    assert not _offenders(pat)


def test_no_jax_package_or_bench_import_in_the_port():
    """No `shrimp_tpu` import that is not `shrimp_tpu_torch`, and no
    import of the benchmark scripts `bench` / `bench_grid`."""
    pat = re.compile(
        r"^\s*(import|from)\s+(shrimp_tpu(?!_torch)\b|bench\b|bench_grid\b)"
        r"|__import__\(\s*['\"](shrimp_tpu['\".]|bench)", re.MULTILINE)
    assert not _offenders(pat)
