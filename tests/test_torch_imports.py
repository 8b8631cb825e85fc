"""The port stands alone: nothing in dpot_tpu_torch/ or chip_smoke.py imports
JAX, its libraries (ml_dtypes among them) or the JAX package, even the
JAX package's numpy-only modules and its native library (the port keeps
its own copies); the port imports with jax blocked; h5py is imported
only inside the functions that read or write HDF5, and matplotlib only
inside the functions that draw (the card's host may lack it)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "dpot_tpu"}
SOURCES = sorted((ROOT / "dpot_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    roots.add(a.value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


# the port's own copies of the JAX package's modules that import no JAX
OWN_COPIES = ["native/build.py", "native/preprocess.py", "native/preprocess.cc",
              "utils/normalizer.py", "data/generation.py", "data/converters.py",
              "data/raw_hdf5.py", "data/resize.py", "data/registry.py", "utils/viz.py"]


@pytest.mark.parametrize("rel", OWN_COPIES)
def test_own_copies_exist_and_are_checked(rel):
    path = ROOT / "dpot_tpu_torch" / rel
    assert path.is_file()
    if path.suffix == ".py":
        assert path in SOURCES
    else:  # the C++ source is the port's, never the JAX package's native/
        assert "dpot_tpu/" not in path.read_text().replace("dpot_tpu_torch/", "")


def module_level_imports(path: Path) -> set[str]:
    """Roots imported by statements that run at import time (outside any
    function or class body)."""
    roots, todo = set(), list(ast.parse(path.read_text(), str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            todo.extend(ast.iter_child_nodes(node))
        elif isinstance(node, ast.ExceptHandler):
            todo.extend(node.body)
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_h5py_is_imported_only_inside_functions(path):
    assert "h5py" not in module_level_imports(path)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_matplotlib_is_imported_only_inside_functions(path):
    assert "matplotlib" not in module_level_imports(path)


def test_viz_imports_and_skips_without_matplotlib(tmp_path):
    """In a fresh interpreter where `import matplotlib` fails, the viz
    module, the loop and the evaluator import, and save_eval_viz writes
    nothing and returns []."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "import dpot_tpu_torch.train.loop, dpot_tpu_torch.train.evaluator\n"
        "from dpot_tpu_torch.utils import viz\n"
        "assert viz._plt() is None\n"
        f"out = viz.save_eval_viz(np.zeros((4, 4, 2, 1)), np.zeros((4, 4, 2, 1)), {str(tmp_path)!r}, 'a')\n"
        "assert out == [], out\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
    assert list(tmp_path.iterdir()) == []


def test_guard_sees_every_form_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy\nfrom dpot_tpu.ops import x\n"
                 "import importlib\nimportlib.import_module('flax.linen')\n")
    assert imported_roots(f) & FORBIDDEN == {"jax", "dpot_tpu", "flax"}


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter in which
    `import jax` (and the JAX package) would fail."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
            for p in SOURCES if p.name != "chip_smoke.py"]
    blocked = sorted(FORBIDDEN)
    code = (
        "import sys, importlib\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax') and v is not None\n"
        "               for k, v in sys.modules.items())\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
