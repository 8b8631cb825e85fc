"""The port stands alone: nothing in dpot_tpu_torch/ or chip_smoke.py imports
JAX, its libraries or the JAX package, and the port imports with jax
blocked."""

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
