"""The port stands alone: no file of `kubernetes_tpu_torch/`, nor
`chip_smoke.py`, imports `jax` or the JAX package `kubernetes_tpu`; and
its backend runs on the card by default, refusing to start without one.
The control plane's process modules (the entry points, durability, leader
election, extenders, `build_scheduler`) are named one by one, and
importing all of them in a fresh interpreter loads neither package. So are
the sharded control plane's and the multi-process control plane's modules,
and a shard apiserver process (`multiproc.shardproc` with the store, the
wire and the WAL it serves) loads no torch either; nor does the
controller manager (`controllers/`, every module of the reference's).
The last slice's modules (the gRPC service, the CLI, ktpu-lint) are named
too: the CLI and the lint load neither torch nor either JAX package, the
gRPC service loads no torch, and the port's generated `ktpu_pb2` is its
own file even after the reference's has been loaded."""

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


#: The modules the sharded and multi-process control plane added or changed.
SHARDED_MODULES = (
    "client/__init__.py", "client/informer.py", "multiproc/__init__.py",
    "multiproc/client.py", "multiproc/controlplane.py", "multiproc/rv.py",
    "multiproc/schedproc.py", "multiproc/shardproc.py", "ops/backend.py",
    "ops/tensorize.py", "perf/churn/faults.py", "perf/scheduler_perf.py",
    "scheduler/scheduler.py", "store/__init__.py", "store/mvcc.py",
    "store/sharded.py", "utils/flags.py",
)


def _loaded(names, prefixes) -> list:
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{prefixes!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip())


@pytest.mark.parametrize("rel", SHARDED_MODULES)
def test_sharded_module_imports_nothing_of_the_reference(rel):
    f = ROOT / "kubernetes_tpu_torch" / rel
    assert f in _port_files()
    mods = list(_imported_modules(ast.parse(f.read_text(), str(f))))
    assert mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_sharded_modules_load_neither_package():
    names = [f"kubernetes_tpu_torch.{rel[:-3].replace('/', '.')}"
             for rel in SHARDED_MODULES]
    assert _loaded(names, FORBIDDEN) == []


def test_shard_process_loads_no_torch():
    names = ["kubernetes_tpu_torch.multiproc.shardproc",
             "kubernetes_tpu_torch.multiproc.rv",
             "kubernetes_tpu_torch.multiproc.client",
             "kubernetes_tpu_torch.apiserver.wire",
             "kubernetes_tpu_torch.metrics.registry",
             "kubernetes_tpu_torch.store",
             "kubernetes_tpu_torch.store.durable",
             "kubernetes_tpu_torch.store.sharded"]
    assert _loaded(names, ("torch", "numpy") + FORBIDDEN) == []


#: The controller manager's modules: `controllers/` whole, as the
#: controller-manager slice left it.
CONTROLLER_MODULES = tuple(sorted(
    f"controllers/{f.name}"
    for f in (ROOT / "kubernetes_tpu_torch" / "controllers").glob("*.py")))


def test_controllers_mirror_the_reference_modules():
    ref = sorted(f"controllers/{f.name}" for f in (
        ROOT / "kubernetes_tpu" / "controllers").glob("*.py"))
    assert list(CONTROLLER_MODULES) == ref and len(ref) == 21


@pytest.mark.parametrize("rel", CONTROLLER_MODULES)
def test_controller_module_imports_nothing_of_the_reference(rel):
    f = ROOT / "kubernetes_tpu_torch" / rel
    assert f in _port_files()
    mods = list(_imported_modules(ast.parse(f.read_text(), str(f))))
    assert mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_controller_manager_loads_no_torch():
    """`python -m kubernetes_tpu_torch.controllers` imports every
    controller module, the wire and HTTP clients and the elector: none of
    them loads torch or numpy (the descheduler imports them where it
    scores)."""
    names = ["kubernetes_tpu_torch.controllers.__main__",
             "kubernetes_tpu_torch.apiserver.wire",
             "kubernetes_tpu_torch.apiserver.client",
             "kubernetes_tpu_torch.client.leaderelection"]
    names += [f"kubernetes_tpu_torch.{rel[:-3].replace('/', '.')}"
              for rel in CONTROLLER_MODULES]
    assert _loaded(names, ("torch", "numpy") + FORBIDDEN) == []


#: The modules the last slice added or changed: the gRPC service and its
#: generated schema, the protobuf negotiation, the CLI and ktpu-lint.
LAST_SLICE_MODULES = tuple(sorted(
    f"{d}/{f.name}" for d in ("apiserver/proto", "cli", "analysis")
    for f in (ROOT / "kubernetes_tpu_torch" / d).glob("*.py"))) + (
    "apiserver/__init__.py", "apiserver/client.py",
    "apiserver/grpc_server.py", "apiserver/server.py", "utils/flags.py")


def test_last_slice_mirrors_the_reference_modules():
    ref = sorted(f"{d}/{f.name}" for d in ("apiserver/proto", "cli",
                                            "analysis")
                 for f in (ROOT / "kubernetes_tpu" / d).glob("*.py"))
    port = sorted(m for m in LAST_SLICE_MODULES
                  if m.startswith(("apiserver/proto/", "cli/", "analysis/")))
    assert sorted(set(port) - set(ref)) == ["apiserver/proto/__init__.py"]
    assert set(ref) <= set(port) and len(ref) == 11
    # the schema and its generated module are the reference's, byte for byte
    for name in ("ktpu.proto", "ktpu_pb2.py"):
        assert (ROOT / "kubernetes_tpu_torch" / "apiserver" / "proto" /
                name).read_bytes() == (ROOT / "kubernetes_tpu" / "apiserver"
                                       / "proto" / name).read_bytes()


@pytest.mark.parametrize("rel", LAST_SLICE_MODULES)
def test_last_slice_module_imports_nothing_of_the_reference(rel):
    f = ROOT / "kubernetes_tpu_torch" / rel
    assert f in _port_files()
    mods = list(_imported_modules(ast.parse(f.read_text(), str(f))))
    assert mods or rel.endswith("proto/__init__.py")
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_cli_and_lint_load_neither_torch_nor_jax():
    names = ["kubernetes_tpu_torch.cli", "kubernetes_tpu_torch.cli.kubectl",
             "kubernetes_tpu_torch.analysis"]
    names += [f"kubernetes_tpu_torch.analysis.{f.stem}" for f in sorted(
        (ROOT / "kubernetes_tpu_torch" / "analysis").glob("*.py"))
        if f.stem not in ("__init__", "__main__")]
    assert _loaded(names, ("torch",) + FORBIDDEN) == []


def test_grpc_service_loads_no_torch():
    names = ["kubernetes_tpu_torch.apiserver.grpc_server",
             "kubernetes_tpu_torch.apiserver.proto.ktpu_pb2",
             "kubernetes_tpu_torch.apiserver"]
    assert _loaded(names, ("torch",) + FORBIDDEN) == []


def test_port_ktpu_pb2_is_its_own_file_after_the_reference():
    """The reference puts its proto directory on sys.path and imports a
    top-level `ktpu_pb2`; the port's import is package-qualified, so it
    gets its own file whichever package loads first."""
    code = ("import sys\n"
            "import kubernetes_tpu.apiserver.grpc_server as ref\n"
            "import kubernetes_tpu_torch.apiserver.grpc_server as port\n"
            "from kubernetes_tpu_torch.apiserver.proto import ktpu_pb2\n"
            "print(port.ktpu_pb2.__file__)\n"
            "print(ktpu_pb2.__name__)\n"
            "print(ref.ktpu_pb2.__file__)\n"
            "print(sys.modules['ktpu_pb2'].__file__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    port_file, port_name, ref_file, top_file = out.stdout.split("\n")[:4]
    proto = ROOT / "kubernetes_tpu_torch" / "apiserver" / "proto"
    assert Path(port_file) == proto / "ktpu_pb2.py"
    assert port_name == "kubernetes_tpu_torch.apiserver.proto.ktpu_pb2"
    ref_proto = ROOT / "kubernetes_tpu" / "apiserver" / "proto"
    assert Path(ref_file) == Path(top_file) == ref_proto / "ktpu_pb2.py"
