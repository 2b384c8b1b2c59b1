"""What the benchmark runs imports neither JAX nor the JAX package nor any
``chip_*.py`` script, and its reference imports nothing of the port.
Top-level module names are compared whole: the port's name begins with
the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
RUN_FORBIDDEN = {"jax", "jaxlib", "flax", "gangealing_tpu", "bench",
                 "benchmarks"}


def imports(path):
    """The top-level names a module imports, relative imports left out."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


RUN_SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", RUN_SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in RUN_SOURCES])
def test_benchmark_imports_no_jax(path):
    names = imports(path)
    assert not names & RUN_FORBIDDEN
    assert not any(n.startswith("chip_") for n in names)


REFERENCE = sorted((BENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_port(path):
    assert "gangealing_torch" not in imports(path)


def test_whole_names(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import gangealing_torch\nimport jaxlib_x\n")
    assert imports(src) == {"gangealing_torch", "jaxlib_x"}
    assert not imports(src) & RUN_FORBIDDEN
