"""The port stands alone: no module of ``downgan_tpu_torch/``, not
``chip_smoke.py`` and no script of ``tools/`` imports JAX, its libraries or
the JAX package."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

from _torch_parity import one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "downgan_tpu")
FILES = (sorted((ROOT / "downgan_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("*.py")))


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def forbidden(name):
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_what_it_forbids(tmp_path):
    src = ("import jax.numpy\nfrom flax import linen\nfrom downgan_tpu.config import Config\n"
           "import downgan_tpu_torch.serving\nimport importlib\nimportlib.import_module('optax')\n")
    probe = tmp_path / "probe.py"
    probe.write_text(src)
    found = [m for m in imported_modules(probe) if forbidden(m)]
    assert found == ["jax.numpy", "flax", "downgan_tpu.config", "optax"]
    assert len(FILES) >= 12
