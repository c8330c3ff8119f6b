"""The benchmark loads neither JAX nor the JAX package, its reference
imports nothing of the port, and its command refuses to run without a
card."""
import ast
import os
import subprocess
import sys

from portbench.lib import bench
from portbench.lib.runctx import FORBIDDEN, forbidden_modules
from portbench.tests import tiny


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_forbidden_module_after_a_rehearsal():
    tiny.run(tiny.cell("qwen3-8b.serve-decode", tiny.QWEN, tiny.CLOSED), seconds=0.5)
    assert forbidden_modules() == []


def test_the_whole_name_is_compared():
    sys.modules.setdefault("tgq_torch", __import__("tgq_torch"))
    assert "tgq" in FORBIDDEN and "tgq_torch" not in forbidden_modules()


def test_reference_imports_nothing_of_the_port():
    for path in [*(bench.PKG / "reference").glob("*.py"), *(bench.PKG / "families").glob("*.py")]:
        names = set(_imports(path))
        assert not names & {"tgq_torch", "tgq", "jax", "jaxlib", "flax"}, path


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in bench.PKG.rglob("*.py"):
        assert not set(_imports(path)) & {"tgq", "jax", "jaxlib", "flax"}, path


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(bench.PKG / "run.py"), "--workload",
                        "qwen3-8b.quantize", "--seed", str(2**31 + 3), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env,
                       cwd=bench.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
