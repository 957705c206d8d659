"""Nothing of the benchmark imports JAX or the JAX package (``repro``),
and its reference imports nothing of the program either.  Top-level
module names are compared whole: ``repro_torch`` is not ``repro``."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH))
)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"repro_torch", "portbench"}), names
    text = path.read_text()
    assert "repro_torch" not in "".join(
        line for line in text.splitlines() if line.lstrip().startswith(("import", "from"))
    )


def test_the_guard_sees_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.models\nfrom jax import numpy\nimport repro.core as rc\n")
    names = top_level_imports(src)
    assert names == {"repro_torch", "jax", "repro"}
    assert names & FORBIDDEN == {"jax", "repro"}
