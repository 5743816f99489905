"""Nothing the benchmark loads is JAX or the JAX package (top-level module
names compared whole: ``havatar_tpu_torch`` begins with ``havatar_tpu``),
and the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from h100bench import harness

HERE = harness.HERE


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        names = set(_top_level_imports(path))
        assert not names & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        names = set(_top_level_imports(path))
        assert names <= {"__future__", "contextlib", "copy", "math",
                         "typing", "numpy", "torch"}, (path, names)


def test_whole_name_comparison():
    before = dict(sys.modules)
    try:
        sys.modules.setdefault("havatar_tpu_torch_probe", object())
        assert harness.forbidden_modules() == []
        sys.modules["havatar_tpu.probe"] = object()
        assert harness.forbidden_modules() == ["havatar_tpu"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_a_run_loads_no_jax():
    """Every module a run imports (harness, drivers, metrics, reference and
    the program's modules they use), in a fresh process."""
    code = (
        "import sys, importlib\n"
        "from h100bench import harness, run, calibrate, flops, checks\n"
        "for k in ('stage1', 'stage2'):\n"
        "    importlib.import_module('h100bench.drivers.' + k)\n"
        "import havatar_tpu_torch.train.stage2, "
        "havatar_tpu_torch.train.stage1\n"
        "for p in (harness.HERE / 'metrics').glob('*.py'):\n"
        "    harness.reader(p.stem)\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
