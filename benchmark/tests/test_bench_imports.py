"""What the benchmark's files import, by top-level module name compared
whole: no JAX and no JAX package anywhere under benchmark/, and nothing of
the measured program in the plain reference or the inputs it shares."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "waterlily_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH))
                                             for p in FILES])
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "kinds"])
def test_reference_imports_nothing_of_the_program(sub):
    for path in sorted((BENCH / sub).glob("*.py")):
        assert "waterlily_tpu_torch" not in _imports(path), path


def test_checker_sees_the_forbidden_names(tmp_path):
    """The scan compares whole top-level names: the port's name begins
    with the JAX package's and is not caught."""
    probe = tmp_path / "probe.py"
    probe.write_text("import waterlily_tpu_torch.flow\nfrom jax import numpy\n"
                     "import waterlily_tpu.flow as f\n")
    assert _imports(probe) & FORBIDDEN == {"jax", "waterlily_tpu"}
