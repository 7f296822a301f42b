"""Nothing the benchmark runs loads JAX or the JAX package, compared by
each module's whole top-level name; the reference and the generators load
nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from vbs_bench import guard

ROOT = Path(__file__).resolve().parents[2]
PORT = "vision_basedsensor_tpu_torch"


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("vision_basedsensor_tpu", True),
    ("vision_basedsensor_tpu.pipeline", True),
    (PORT, False), (f"{PORT}.pipeline", False), ("jaxtyping", False),
    ("vision_basedsensor_tpu_torchx", False), ("torch", False)])
def test_names_are_compared_whole(name, bad):
    assert guard.forbidden_modules([name]) == ([name] if bad else [])


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    (ROOT / "vbs_bench").rglob("*.py")), ids=lambda p: str(
        p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & guard.FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "gen"])
def test_reference_and_generators_import_nothing_of_the_port(sub):
    for path in (ROOT / "vbs_bench" / sub).glob("*.py"):
        assert PORT not in _imports(path), path


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_reference_loads_no_port_module():
    out = _fresh(
        "import sys\n"
        "import vbs_bench.reference.pipeline, vbs_bench.reference.jpeg\n"
        "import vbs_bench.gen.scene, vbs_bench.gen.jpeg\n"
        f"print(sorted(n for n in sys.modules if n.split('.')[0] in "
        f"('{PORT}', 'jax', 'vision_basedsensor_tpu')))\n")
    assert out.strip() == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = _fresh(
        "import torch\n"
        "from vbs_bench.run import run_cell\n"
        "from vbs_bench import guard\n"
        "r = run_cell('vga_batch1024', 7, 0.01, False, torch.device('cpu'),"
        " traffic_overrides={'batch': 2})\n"
        "print(r['correct'], guard.forbidden_modules())\n")
    assert out.split("\n")[-2] == "True []"
