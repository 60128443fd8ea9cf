"""Nothing under bgvbench imports JAX, jaxlib, flax or the JAX package
``repro`` (top-level module names compared whole: ``repro_torch`` is
another name), and the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax_or_reference_package(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & FORBIDDEN, f"{path} imports {sorted(tops & FORBIDDEN)}"


def test_the_rule_compares_whole_names():
    tops = {n.split(".")[0] for n in ("repro_torch.core", "reprox", "repro.core")}
    assert tops & FORBIDDEN == {"repro"}


REF = sorted((BENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REF, ids=[p.name for p in REF])
def test_reference_imports_nothing_of_the_program(path):
    for name in imported(path):
        assert name.split(".")[0] != "repro_torch", f"{path} imports {name}"
        assert not name.startswith(("bgvbench.program", "bgvbench.load",
                                    "bgvbench.harness")), f"{path} imports {name}"
