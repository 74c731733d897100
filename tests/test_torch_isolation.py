"""The port stands alone: no file of `kubernetes_tpu_torch/`, nor
`chip_smoke.py`, imports `jax` or the JAX package `kubernetes_tpu`; and
its backend runs on the card by default, refusing to start without one.
The control plane's process modules (the entry points, durability, leader
election, extenders, `build_scheduler`) are named one by one, and
importing all of them in a fresh interpreter loads neither package."""

import ast
import subprocess
import sys
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


#: The modules the control-plane slice added or changed.
CONTROL_PLANE_MODULES = (
    "agent/__init__.py", "agent/__main__.py", "agent/agent.py",
    "agent/config.py", "agent/server.py", "apiserver/__init__.py",
    "apiserver/__main__.py", "apiserver/server.py", "client/__init__.py",
    "client/leaderelection.py", "config/scheduler.py",
    "controllers/base.py", "metrics/registry.py", "scheduler/__main__.py",
    "scheduler/extender.py", "scheduler/scheduler.py", "store/__init__.py",
    "store/durable.py", "utils/flags.py",
)


@pytest.mark.parametrize("rel", CONTROL_PLANE_MODULES)
def test_control_plane_module_imports_nothing_of_the_reference(rel):
    f = ROOT / "kubernetes_tpu_torch" / rel
    assert f in _port_files()
    mods = list(_imported_modules(ast.parse(f.read_text(), str(f))))
    assert mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_control_plane_modules_load_neither_package():
    names = [f"kubernetes_tpu_torch.{rel[:-3].replace('/', '.')}"
             for rel in CONTROL_PLANE_MODULES]
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
