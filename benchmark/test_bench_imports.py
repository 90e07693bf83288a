"""The import check: JAX and the JAX package are caught by top-level name
compared whole, the port (whose name begins with the JAX package's) is
not; no file of the benchmark imports them, and the references import
nothing of the program."""

import ast

import pytest

from benchmark import harness

BENCH = harness.BENCH


def test_forbidden_by_whole_top_level_name():
    mods = {"jax": 0, "jax.numpy": 0, "jaxlib.xla_client": 0, "flax": 0,
            "speakerguard_tpu": 0, "speakerguard_tpu.models.gmm": 0,
            "speakerguard_tpu_torch": 0, "speakerguard_tpu_torch.ops": 0,
            "jaxtyping": 0, "torch": 0}
    assert harness.forbidden_modules(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla_client", "speakerguard_tpu",
        "speakerguard_tpu.models.gmm"]


def test_this_process_is_checked_too():
    assert all(m.split(".")[0] not in harness.FORBIDDEN
               for m in harness.forbidden_modules())


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in harness.FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    program = harness.FORBIDDEN + ("speakerguard_tpu_torch",)
    bad = [m for m in _imports(path) if m.split(".")[0] in program]
    assert not bad, bad
