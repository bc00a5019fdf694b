"""Static guard: the PyTorch port and its card scripts (chip_smoke.py,
chip_k3_variants.py, chip_k1k2_variants.py, chip_k4_variants.py) import no JAX, no Flax, nothing
of the JAX package, and no PIL at module level.

The machine with the card has none of JAX, Flax or PIL, so any such import
there ends the run before a kernel is built.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("chip_smoke", "chip_k3_variants", "chip_k1k2_variants", "chip_k4_variants")
FILES = sorted((ROOT / "vit_reranking_tpu_torch").rglob("*.py")) + [
    ROOT / f"{name}.py" for name in SCRIPTS]
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "vit_reranking_tpu", "pandas", "sklearn")


def _imports(tree):
    """(module name, inside a function?) for every import statement."""
    found = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                found.extend((a.name, fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module or "", fn))
            visit(child, fn)

    visit(tree, False)
    return found


def test_port_files_found():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(FILES) > 20
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for module in ("ops/attention", "engine/train", "losses/margin", "miners/distance",
                   "data/samplers", "core/checkpoint", "core/logger", "cli/train_baseline",
                   "models/swin", "ops/swin_attention", "models/vit", "cli/test_diml_vit",
                   "data/transforms", "data/datasets", "core/convert", "cli/test_diml_swin",
                   "data/device_cache", "models/resnet", "losses/diml_ot", "losses/margin_diml",
                   "cli/train_diml", "cli/test_diml_base", "data/msls", "engine/msls_val",
                   "losses/msls", "utils/visual", "cli/train_msls_baseline",
                   "cli/test_msls_baseline"):
        assert f"vit_reranking_tpu_torch/{module}.py" in names


def test_every_port_module_imports_without_jax():
    """Import every module of the port and the card scripts in a fresh process
    where JAX, Flax, PIL and the JAX package cannot be imported, as on the
    machine with the card."""
    code = f"""
import importlib, pkgutil, sys
for name in {BANNED + ("PIL",)!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
import vit_reranking_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
for m in {SCRIPTS!r}:
    importlib.import_module(m)
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_module_level_pil(path):
    for name, in_fn in _imports(ast.parse(path.read_text(), str(path))):
        top = name.split(".")[0]
        assert top not in BANNED, f"{path.name} imports {name}"
        assert not (top == "PIL" and not in_fn), f"{path.name} imports PIL at module level"


def test_guard_catches_banned_imports():
    bad = ast.parse(
        "import jax.numpy\nfrom vit_reranking_tpu.ops import x\nfrom PIL import Image\n"
        "def f():\n    from PIL import Image\n    import pandas as pd\n"
        "    from sklearn.neighbors import NearestNeighbors\n"
    )
    assert _imports(bad) == [
        ("jax.numpy", False), ("vit_reranking_tpu.ops", False), ("PIL", False), ("PIL", True),
        ("pandas", True), ("sklearn.neighbors", True),
    ]
    assert {"pandas", "sklearn"} <= set(BANNED)
