"""What a run and the reference may import, and the command's refusals."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from schedbench import run

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


def test_forbidden_names_compare_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["kubernetes_tpu_torch_fake.x"] = object()
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & run.FORBIDDEN)
        sys.modules["kubernetes_tpu.fake"] = object()
        assert "kubernetes_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_numpy_and_the_standard_library_only():
    allowed = {"numpy", "fractions", "dataclasses", "__future__",
               "schedbench"}
    for path in (ROOT / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
                if n.startswith("schedbench"):
                    assert n.startswith("schedbench.reference"), (path, n)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import schedbench.reference.placement, "
            "schedbench.reference.quantity; print(sorted({m.split('.')[0] "
            "for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.replace("'", '"')))
    assert not tops & {"kubernetes_tpu_torch", "kubernetes_tpu", "jax",
                       "torch"}


def test_a_run_loads_no_jax_module():
    code = """
import sys
from schedbench import run
from schedbench.tests.small import basic_spec
out, rows = run.execute(basic_spec(), 2 ** 31 + 11, 1.5, False,
                        device="cpu")
assert out is not None and out["correct"], out
print("FOUND", run.forbidden_modules(),
      "kubernetes_tpu_torch" in {m.split(".")[0] for m in sys.modules})
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND [] True" in out.stdout


def test_command_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "basic-5000n-burst", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_command_fails_in_a_bare_checkout(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT, tmp_path / "schedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "schedbench.run", "--workload",
         "basic-5000n-burst", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
