"""Nothing of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``endoscopy_tpu_torch`` is not ``endoscopy_tpu``),
the reference imports nothing of the port, and the run-time guard and the
refusal without a card hold."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "endoscopy_tpu"}
FILES = sorted(spec.BENCH_DIR.rglob("*.py"))


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.BENCH_DIR)))
def test_no_jax_side_import(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        assert "endoscopy_tpu_torch" not in _top_level_imports(path), path


def test_guard_compares_whole_top_level_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "endoscopy_tpu_torch.fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "endoscopy_tpu.models", object())
    assert run.forbidden_modules() == ["endoscopy_tpu"]


def test_refuses_to_run_without_a_card():
    out = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         "r50_fixmatch.cached", "--seed", "3", "--seconds", "1",
         "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(spec.ROOT)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
