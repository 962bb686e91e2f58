"""The port's boundary rules.

- ``jumbo_mae_tpu_tpu_torch/`` and ``chip_smoke.py`` never import JAX, its
  libraries or the JAX package (an AST scan of every import statement);
- every module of the port imports in a fresh interpreter where importing
  any of those raises;
- the entry points default to the GPU and raise when there is none,
  instead of carrying on on the CPU;
- no kernel is built at import time.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jumbo_mae_tpu_tpu_torch.cli import predict
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
from jumbo_mae_tpu_tpu_torch.models import JumboViT, preset
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "jumbo_mae_tpu_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "jumbo_mae_tpu_tpu")
TINY = preset("vit_t16", image_size=32, patch_size=4)


def port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None  # any import of it now raises\n"
        f"for mod in {port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "from jumbo_mae_tpu_tpu_torch.ops import _build\n"
        "assert _build._LIBS == {}, 'a kernel library was loaded at import'\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_module_list_covers_the_slice():
    mods = set(port_modules())
    for m in (
        "jumbo_mae_tpu_tpu_torch.ops.posemb",
        "jumbo_mae_tpu_tpu_torch.ops.preprocess",
        "jumbo_mae_tpu_tpu_torch.ops.flash.attention",
        "jumbo_mae_tpu_tpu_torch.ops.flash_attention",
        "jumbo_mae_tpu_tpu_torch.models.config",
        "jumbo_mae_tpu_tpu_torch.models.layers",
        "jumbo_mae_tpu_tpu_torch.models.vit",
        "jumbo_mae_tpu_tpu_torch.interop.from_jax",
        "jumbo_mae_tpu_tpu_torch.infer.bucketing",
        "jumbo_mae_tpu_tpu_torch.infer.engine",
        "jumbo_mae_tpu_tpu_torch.cli.predict",
    ):
        assert m in mods
    assert (PORT / "csrc" / "flash_fwd.cu").exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(TINY)
    # the explicit CPU request works
    assert InferenceEngine(TINY, device="cpu", max_batch=2).device.type == "cpu"


def test_model_and_cli_default_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        JumboViT(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.main(["--preset", "vit_t16", "--set", "image_size=32", "patch_size=4", "--synthetic", "1"])
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Run without a card, chip_smoke.py exits non-zero and prints no
    result line — here and in a directory holding nothing but itself."""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        res = subprocess.run(
            [sys.executable, str(script)], cwd=str(cwd), env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
