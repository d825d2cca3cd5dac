"""What the benchmark may import: never JAX or the JAX package (the
top-level name compared whole: ``implicitbvh_tpu_torch`` is not
``implicitbvh_tpu``), never ``bench.py``, ``chip_smoke.py`` or
``benchmarks/``; and the reference nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BANNED = {"jax", "jaxlib", "flax", "implicitbvh_tpu", "bench", "chip_smoke",
          "benchmarks"}


def imported_names(path: Path) -> set:
    """Top-level names of the modules a source file imports (absolute
    imports; a relative import stays inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_banned_import_in_source(path):
    assert not imported_names(path) & BANNED


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")) + \
            [HERE / "check.py"]:
        names = imported_names(path)
        assert "implicitbvh_tpu_torch" not in names, path


def loaded_after(code: str) -> list:
    """Top-level names of ``sys.modules`` after ``code`` runs in a fresh
    interpreter."""
    prog = f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n" \
        "import json; print(json.dumps(sorted({m.split('.')[0] " \
        "for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("from portbench.tests.small import small_cell, cells\n"
            "from portbench import harness\n"
            "import time\n"
            "for name in cells():\n"
            "    harness.run_cell(small_cell(name, leaves=600), 7, 0.05,"
            " True, 'cpu', time.time(), check_at=[])\n"
            "assert not harness.forbidden_modules()\n")
    names = loaded_after(code)
    assert "implicitbvh_tpu_torch" in names
    assert not set(names) & {"jax", "jaxlib", "flax", "implicitbvh_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("import portbench.check, portbench.control")
    assert "implicitbvh_tpu_torch" not in names


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "implicitbvh_tpu_torchx", sys)
    assert "implicitbvh_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "implicitbvh_tpu.volumes", sys)
    assert "implicitbvh_tpu" in harness.forbidden_modules()
