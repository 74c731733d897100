"""The port stands alone: no file of `kubernetes_tpu_torch/`, nor
`chip_smoke.py`, imports `jax` or the JAX package `kubernetes_tpu`; and
its backend runs on the card by default, refusing to start without one."""

import ast
from pathlib import Path

import pytest
import torch

from kubernetes_tpu_torch.ops.backend import TorchBackend

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "kubernetes_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_files():
    files = sorted((ROOT / "kubernetes_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_nothing_of_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    assert ROOT / "kubernetes_tpu_torch" / "parallel" / "sharded.py" in files
    bad = []
    for f in files:
        for mod in _imported_modules(ast.parse(f.read_text(), str(f))):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_backend_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    assert TorchBackend(device="cpu").device == torch.device("cpu")
