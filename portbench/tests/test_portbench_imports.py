"""No module a run loads has the top-level name of JAX or of the JAX
package (compared whole: `shrimp_tpu_torch` is not `shrimp_tpu`), and
the reference loads nothing of the program."""

import os
import subprocess
import sys

from conftest import BENCH, ROOT

PRELUDE = f"""
import sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
"""


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    got = _fresh("""
from harness import core as harness, program, data, trace, window
import reference.judge, gen.synth
program.mapper_config  # the program's modules load on use:
from shrimp_tpu_torch.pipeline import mapper, paired
from shrimp_tpu_torch import index, _build
from shrimp_tpu_torch.ops import sw_vector, sw_full, sw_full_cs
from shrimp_tpu_torch.ops import candidates_device
from shrimp_tpu_torch.utils import telemetry
print(",".join(harness.forbidden_modules()))
""")
    assert got == ""


def test_forbidden_names_are_compared_whole():
    got = _fresh("""
from harness import core as harness
import types
sys.modules["shrimp_tpu_torch_x"] = types.ModuleType("shrimp_tpu_torch_x")
sys.modules["jaxlike"] = types.ModuleType("jaxlike")
a = harness.forbidden_modules()
sys.modules["shrimp_tpu.ops"] = types.ModuleType("shrimp_tpu.ops")
b = harness.forbidden_modules()
print(a, b)
""")
    assert got == "[] ['shrimp_tpu']"


def test_the_reference_loads_nothing_of_the_program():
    got = _fresh("""
import reference.judge, reference.posterior, reference.dp, gen.synth
print(sorted({m.split('.')[0] for m in sys.modules}
             & {'shrimp_tpu_torch', 'shrimp_tpu', 'jax', 'jaxlib',
                'flax', 'torch'}))
""")
    assert got == "[]"


def test_no_source_of_the_benchmark_imports_the_jax_package():
    import ast
    bad = []
    for d, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "shrimp_tpu"):
                        bad.append((path, n))
                    if "reference" in path.split(os.sep)[-2:][0] and \
                            n.split(".")[0] == "shrimp_tpu_torch":
                        bad.append((path, n))
    assert bad == []
