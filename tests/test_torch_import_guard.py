"""The PyTorch port never imports jax: it maps the golden reads in a
process where jax cannot be imported (letter and colour space), and no
module of the package (nor chip_smoke.py) has a jax import."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = r"""
import sys
sys.modules["jax"] = None          # any "import jax" now raises
import os
from shrimp_tpu import index as gindex
from shrimp_tpu.io import fastx
from shrimp_tpu.pipeline.options import MapperConfig
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch import gmapper  # noqa: F401
g = os.path.join("tests", "golden")
idx = gindex.build_index(list(fastx.iter_contigs(
    os.path.join(g, "golden_genome.fa"))))
m = Mapper(idx, MapperConfig(qual_delta=64))
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
from shrimp_tpu import index as gindex
from shrimp_tpu.io import fastx
from shrimp_tpu.ops.params import SWParams
from shrimp_tpu.pipeline.options import MapperConfig
from shrimp_tpu_torch.pipeline.mapper import Mapper
g = os.path.join("tests", "golden")
idx = gindex.build_index(list(fastx.iter_contigs(
    os.path.join(g, "golden_genome.fa"))), colour_space=True)
m = Mapper(idx, MapperConfig(colour_space=True,
                             params=SWParams.colour_space(), qual_delta=33))
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


def test_no_jax_import_in_the_port():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)|__import__\(\s*['\"]jax",
                     re.MULTILINE)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "shrimp_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 8
    offenders = []
    for path in files:
        with open(path) as fh:
            if pat.search(fh.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders
