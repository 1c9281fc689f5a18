"""Nothing of the benchmark imports JAX or the JAX package, compared by whole
top-level name (``dpu_olap_tpu_torch`` is the program; ``dpu_olap_tpu`` is
not), and the plain reference and the generator import nothing of the
program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "dpu_olap_tpu"}
PROGRAM = "dpu_olap_tpu_torch"
MODULES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("part", ["reference", "data"])
def test_reference_and_data_import_nothing_of_the_program(part):
    for path in (HERE / part).rglob("*.py"):
        assert PROGRAM not in top_level_imports(path), path


def test_whole_name_comparison():
    assert "dpu_olap_tpu_torch" not in JAX_SIDE
    from olapbench.harness import BANNED

    assert set(BANNED) == JAX_SIDE


def test_a_run_loads_nothing_of_the_jax_side():
    from olapbench.harness import banned_modules
    from olapbench.tests.cells import line_of

    line_of("bm_join_sf128-join_sum")
    assert banned_modules() == []
