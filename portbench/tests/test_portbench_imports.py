"""Nothing of the benchmark imports JAX or the JAX package (``repro``),
and neither its reference nor its model families import anything of the
program, directly or through another module of the benchmark.  Top-level
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
PROGRAM_FREE = sorted((BENCH / "reference").rglob("*.py")) + sorted((BENCH / "families").rglob("*.py"))


def benchmark_imports(path: pathlib.Path) -> set:
    """The modules of the benchmark that ``path`` imports, by dotted name,
    relative imports resolved."""
    rel = path.relative_to(BENCH.parent).with_suffix("")
    package = list(rel.parts[:-1])
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names if a.name.split(".")[0] == BENCH.name)
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            if mod.split(".")[0] != BENCH.name:
                continue
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def module_file(name: str):
    """The file of a module of the benchmark, or None where the name is a
    function or class inside one."""
    base = BENCH.parent.joinpath(*name.split("."))
    for path in (base.with_suffix(".py"), base / "__init__.py"):
        if path.is_file():
            return path
    return None


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", PROGRAM_FREE, ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    seen, todo = set(), [path]
    while todo:
        here = todo.pop()
        if here in seen:
            continue
        seen.add(here)
        names = top_level_imports(here)
        assert not names & (FORBIDDEN | {"repro_torch"}), (here, names)
        text = here.read_text()
        assert "repro_torch" not in "".join(
            line for line in text.splitlines() if line.lstrip().startswith(("import", "from"))
        ), here
        todo.extend(f for f in map(module_file, benchmark_imports(here)) if f is not None)
    assert BENCH / "program.py" not in seen


def test_the_guard_follows_the_benchmarks_own_modules():
    seen = benchmark_imports(BENCH / "families" / "dense.py")
    assert "portbench.reference.model" in seen and "portbench.arith.flops" in seen
    assert "portbench.catalog" in benchmark_imports(BENCH / "reference" / "model.py")
    assert module_file("portbench.program") == BENCH / "program.py"
    assert "repro_torch" in top_level_imports(BENCH / "program.py")


def test_the_guard_sees_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.models\nfrom jax import numpy\nimport repro.core as rc\n")
    names = top_level_imports(src)
    assert names == {"repro_torch", "jax", "repro"}
    assert names & FORBIDDEN == {"jax", "repro"}
