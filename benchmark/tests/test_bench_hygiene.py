"""Nothing under benchmark/ imports JAX or the JAX package, the top-level
module names compared whole (the port's name begins with the JAX
package's), and nothing under benchmark/reference/ imports the port."""

import ast
import subprocess
import sys

import pytest

from benchmark.tests.conftest import REPO

BENCH = REPO / "benchmark"
NEVER = {"jax", "jaxlib", "flax", "video_restore_tpu"}


def imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                yield node.args[0].value.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not set(imported_tops(path)) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "video_restore_tpu_torch" not in set(imported_tops(path))


def test_the_run_compares_whole_top_level_names():
    from benchmark.harness.spec import load_module

    run = load_module(BENCH / "run.py")
    assert run.loaded_forbidden(["video_restore_tpu_torch", "video_restore_tpu_torch.ops.tail", "numpy"]) == []
    assert run.loaded_forbidden(["video_restore_tpu.cli", "jaxlib", "flax.linen"]) == ["flax", "jaxlib", "video_restore_tpu"]


def test_reference_loads_no_program_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness.check, benchmark.reference.rrdbnet, benchmark.reference.srvgg\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'video_restore_tpu', "
        "'video_restore_tpu_torch'}))" % str(REPO)
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
