"""What runs on the card imports neither JAX nor the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the port),
and the plain reference imports nothing of the program either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


def imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    assert {top(n) for n in imports(path)} & FORBIDDEN == set()


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    for name in imports(path):
        assert top(name) not in FORBIDDEN | {"repro_torch"}, name
        if top(name) == "bench":
            assert name.startswith("bench.reference"), name


def test_the_whole_word_rule():
    assert top("repro_torch.train") not in FORBIDDEN
    assert top("repro.train") in FORBIDDEN
    assert top("jaxlib.xla") in FORBIDDEN
