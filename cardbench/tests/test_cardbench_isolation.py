"""What the benchmark may load and read: no module under cardbench/
imports JAX or flac_tpu (top-level names compared whole: flac_tpu_torch
is not flac_tpu), the reference imports nothing of the program, and a run
neither imports nor opens the repository's older benchmark scripts."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
OLD_SCRIPTS = ("bench.py", "bench_torch.py", "chip_smoke.py", "same_card.py")


def _imports(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _strings(path: Path) -> list[str]:
    """String constants of the file that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_module_imports_jax_or_flac_tpu():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) >= 20
    bad = {str(p.relative_to(REPO)): sorted(_imports(p) & {"jax", "jaxlib", "flax", "flac_tpu"})
           for p in files}
    assert not {k: v for k, v in bad.items() if v}
    assert "flac_tpu_torch" != "flac_tpu"  # the port's name begins with the JAX package's


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for p in files:
        assert "flac_tpu_torch" not in _imports(p), p


def test_no_module_names_the_old_benchmark_scripts():
    for p in sorted(BENCH.rglob("*.py")):
        if p.parent.name == "tests":
            continue
        for s in _strings(p):
            assert not any(name in s for name in OLD_SCRIPTS), (p, s)
        assert not _imports(p) & {n[:-3] for n in OLD_SCRIPTS}, p


_AUDITED_RUN = """
import os, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import conftest
conftest.write_root({root!r})
from cardbench import harness
cell = harness.load_cell({root!r}, "tiny_album_encode")
r = harness.run({root!r}, cell, 7, 0.5, False, "cpu")
assert r["correct"], r
old = [p for p in opened if os.path.basename(p) in {old!r}]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "flac_tpu"))
print("OLD", old, "LOADED", loaded)
assert not old and not loaded
"""


def test_a_run_loads_no_jax_and_opens_no_old_script(tmp_path):
    code = _AUDITED_RUN.format(repo=str(REPO), tests=str(BENCH / "tests"),
                               root=str(tmp_path / "root"), old=set(OLD_SCRIPTS))
    (tmp_path / "root").mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "OLD [] LOADED []" in r.stdout
