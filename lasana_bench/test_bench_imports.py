"""No module of the benchmark imports JAX or the JAX package, by top-level
name compared whole (``repro_torch`` begins with ``repro``); the plain
reference imports nothing of the program either; nothing reads the JAX
package's ``benchmarks/`` folder."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
FILES = sorted(p for p in BENCH.rglob("*.py") if "out" not in p.parts)
NEVER = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path):
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    assert not imported_tops(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported_tops(path)


def test_nothing_reads_the_jax_benchmarks_folder():
    for path in FILES:
        if path.name.startswith("test_bench_"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "benchmarks/" not in node.value, path
                assert "BENCH_" not in node.value, path


def test_the_check_catches_a_jax_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import repro.core\nfrom jax import numpy\n"
                 "import repro_torch\n")
    assert imported_tops(p) & NEVER == {"repro", "jax"}
