"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under benchmark/ (top-level names compared whole: the port's name
begins with the JAX package's), and nothing of the program under
benchmark/reference/."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dmel_codec_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert "dmel_codec_tpu_torch" not in imported(path)


def test_the_check_compares_whole_names():
    assert "dmel_codec_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "dmel_codec_tpu.models".split(".")[0] in FORBIDDEN
