"""Nothing the benchmark runs imports JAX or the JAX package; the plain
files (the generator, the yardstick and every ``reference*.py``) import
nothing of the program; nothing reads the JAX package's benchmarks."""

import ast
import json
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "bench"
SOURCES = sorted(p for p in BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the plain files: the generator, the yardstick and every reference
PLAIN = sorted({"generator.py", "yardstick.py"} |
               {p.name for p in BENCH.glob("reference*.py")})
JAX_HARNESS = "benchmarks" + "/"       # the JAX package's benchmark folder


def top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "benchmarks" not in names
    assert JAX_HARNESS not in path.read_text()


@pytest.mark.parametrize("name", PLAIN)
def test_plain_files_import_nothing_of_the_program(name):
    names = top_level_imports(BENCH / name)
    assert names <= {"__future__", "numpy", "torch", "typing"}, names


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, io, json; sys.path[:0] = ['bench/tests', '.', 'src']\n"
        "import conftest\n"
        "from bench import harness\n"
        "for name in [w['name'] for w in harness.load_benchmark()['workloads']]:\n"
        "    conftest.execute(conftest.tiny(name), seconds=0.2)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN
