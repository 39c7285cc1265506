"""What the benchmark may import and read: no JAX and not the JAX package
anywhere it runs, nothing of the code under test in the reference, and
nothing under `benchmarks/`."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vcf_tpu"}


def _modules(sub=""):
    return [p for p in sorted((BENCH / sub).rglob("*.py"))
            if "tests" not in p.relative_to(BENCH).parts]


def _imports(path: Path) -> set:
    """Top-level names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_names_are_compared_whole():
    assert "vcf_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "vcf_tpu.io".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in _modules("reference"):
        assert "vcf_tpu_torch" not in _imports(path), path
        assert not _imports(path) & FORBIDDEN, path


def test_nothing_reads_under_benchmarks():
    for path in _modules():
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert "benchmarks" not in node.value, (path, node.value)


def test_a_run_loads_no_jax():
    """A whole run in a fresh process (on the CPU, at the small size)
    leaves no forbidden module in sys.modules."""
    code = (
        "import sys, time, pathlib, tempfile, torch\n"
        "torch.set_num_threads(2)\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from portbench.tests import _small\n"
        "from portbench.core import harness\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'run', {str(BENCH / 'run.py')!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    root = _small.checkout(pathlib.Path(d))\n"
        "    for cell in ('iii_wire_32f',):\n"
        "        rec = harness.run(cell, 7, 0.1, True, torch.device('cpu'),\n"
        "                          time.perf_counter(), root=root)\n"
        "        assert rec['correct'], rec['checks']\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
