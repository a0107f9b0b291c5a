"""The harness loads neither JAX nor the JAX package, whose top-level
name ``pcgnn_tpu`` the port's begins with, so names are compared whole;
the reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from portbench.tests.helpers import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pcgnn_tpu", "benchmarks"}


def imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_no_source_of_the_harness_names_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    # plain libraries, and the reference's own modules
    plain = {"__future__", "dataclasses", "math", "numpy", "torch"}
    for path in (HERE / "reference").rglob("*.py"):
        other = {m for m in imports(path) if m.split(".")[0] not in plain
                 and not m.startswith("portbench.reference")}
        assert not other, (path, other)


def test_a_run_loads_no_jax_module():
    code = (
        "import json, sys, time, torch\n"
        "from portbench.reference import plain\n"
        "from portbench.tests.helpers import run_small\n"
        "plain.BIAS_CORRECTION_DTYPE = torch.float64\n"
        "line, _ = run_small('pcgnn-yelpchi.hubs', 'skew-tiny', 64, seed=4,"
        " traced=True)\n"
        "assert line['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "pcgnn_tpu_torch" in tops
    assert not tops & FORBIDDEN
