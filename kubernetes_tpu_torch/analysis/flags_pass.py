"""Pass 3 — the KTPU_* flag registry is the ONLY read path.

`utils/flags.py` is the single source of truth for environment flags:
name, default, parser, doc line, kill-switch bool. This pass keeps the
contract honest:

- FL301 unrouted read: `os.environ.get("KTPU_…")`, `os.environ[…]` or
  `os.getenv(…)` anywhere in the package or chip_smoke.py outside
  utils/flags.py itself. WRITES stay legal — chip_smoke.py and PerfRunner
  export overrides for child code to read through the registry (and
  `flags.scoped_set` is the save/restore idiom) — only reads bypass
  the contract.
- FL302 unknown flag: a `KTPU_*` string referenced in the tree that the
  registry doesn't know. Catches typos before they become silent
  no-op kill switches.
- FL303 undocumented flag: a registry entry with an empty doc line.
- FL304 untested flag: a registry flag named nowhere under tests/ —
  every knob needs at least one test that mentions it (the flags
  round-trip test names them all explicitly, so adding a flag without
  touching tests fails here).
- FL305 README drift: the README's generated flag table no longer
  matches `flags.render_markdown_table()` (regenerate with
  `python -m kubernetes_tpu_torch.analysis --write-readme-flags`).

Tests are exempt from FL301: they monkeypatch env wholesale.

Copy of `kubernetes_tpu/analysis/flags_pass.py` over this package's
registry. Its README table has markers of its own (`ktpu-torch-flags`), so
`--write-readme-flags` touches only this package's table and the JAX
package's table keeps its own pair.
"""

from __future__ import annotations

import ast
import os
import re

from kubernetes_tpu_torch.analysis.engine import Finding, Module, dotted
from kubernetes_tpu_torch.utils import flags as flags_registry

PASS_ID = "flag-registry"

#: the one module allowed to read KTPU_* env directly.
ALLOWED_READERS = ("kubernetes_tpu_torch/utils/flags.py",)

README_BEGIN = "<!-- ktpu-torch-flags:begin (generated: python -m kubernetes_tpu_torch.analysis --write-readme-flags) -->"
README_END = "<!-- ktpu-torch-flags:end -->"


def _env_reads(mod: Module):
    """(flag name, line) for every KTPU_* environ READ in the module."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            n = dotted(node.func)
            if n and (n.endswith("environ.get") or n.endswith(".getenv")
                      or n == "getenv" or n.endswith("environ.setdefault")):
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str) \
                        and node.args[0].value.startswith("KTPU_"):
                    yield node.args[0].value, node.lineno
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load):
            n = dotted(node.value)
            if n and n.endswith("environ") \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str) \
                    and node.slice.value.startswith("KTPU_"):
                yield node.slice.value, node.lineno


def _referenced_flags(mod: Module) -> set[str]:
    """Every KTPU_* identifier in string literals (typo guard input)."""
    return set(re.findall(r"\bKTPU_[A-Z0-9_]+\b", mod.source))


def run(modules: list[Module], root: str | None = None) -> list[Finding]:
    from kubernetes_tpu_torch.analysis.engine import repo_root
    root = root or repo_root()
    findings: list[Finding] = []
    registry = flags_registry.FLAGS

    referenced: set[str] = set()
    for mod in modules:
        referenced |= _referenced_flags(mod)
        if mod.rel in ALLOWED_READERS:
            continue
        for name, line in _env_reads(mod):
            findings.append(Finding(
                pass_id=PASS_ID, code="FL301", path=mod.rel, line=line,
                symbol=name,
                message=f"environ read of {name} bypasses the flag "
                        "registry — use kubernetes_tpu_torch.utils.flags.get"
                        f"({name!r})"))

    for name in sorted(referenced - set(registry)):
        # find one referencing module for the report location
        where = next((m for m in modules if name in m.source), None)
        line = 0
        if where is not None:
            for i, ln in enumerate(where.source.splitlines(), 1):
                if name in ln:
                    line = i
                    break
        findings.append(Finding(
            pass_id=PASS_ID, code="FL302",
            path=where.rel if where else "kubernetes_tpu_torch/utils/flags.py",
            line=line, symbol=name,
            message=f"{name} is referenced but not registered in "
                    "utils/flags.py — register it (or fix the typo)"))

    # registry hygiene: docs + tests
    tests_text = ""
    tests_dir = os.path.join(root, "tests")
    if os.path.isdir(tests_dir):
        for fn in sorted(os.listdir(tests_dir)):
            if fn.endswith(".py"):
                with open(os.path.join(tests_dir, fn),
                          encoding="utf-8") as f:
                    tests_text += f.read()
    for name, flag in registry.items():
        if not flag.doc.strip():
            findings.append(Finding(
                pass_id=PASS_ID, code="FL303",
                path="kubernetes_tpu_torch/utils/flags.py", line=0,
                symbol=name,
                message=f"registry flag {name} has no doc line"))
        if tests_text and name not in tests_text:
            findings.append(Finding(
                pass_id=PASS_ID, code="FL304",
                path="kubernetes_tpu_torch/utils/flags.py", line=0,
                symbol=name,
                message=f"registry flag {name} is exercised by no test "
                        "under tests/ — name it in at least one"))

    # README table sync
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        with open(readme, encoding="utf-8") as f:
            text = f.read()
        current = _readme_table(text)
        want = flags_registry.render_markdown_table()
        if current is None:
            findings.append(Finding(
                pass_id=PASS_ID, code="FL305", path="README.md", line=0,
                symbol="flag-table",
                message="README has no generated flag table (markers "
                        f"{README_BEGIN!r} … {README_END!r}); add one "
                        "with --write-readme-flags"))
        elif current.strip() != want.strip():
            findings.append(Finding(
                pass_id=PASS_ID, code="FL305", path="README.md", line=0,
                symbol="flag-table",
                message="README flag table drifted from the registry — "
                        "regenerate with python -m kubernetes_tpu_torch."
                        "analysis --write-readme-flags"))
    return findings


def _readme_table(text: str) -> str | None:
    b = text.find(README_BEGIN)
    e = text.find(README_END)
    if b < 0 or e < 0 or e < b:
        return None
    return text[b + len(README_BEGIN):e]


def write_readme_table(root: str | None = None) -> bool:
    """Regenerate the README's flag table in place (returns True when
    the file changed)."""
    from kubernetes_tpu_torch.analysis.engine import repo_root
    root = root or repo_root()
    readme = os.path.join(root, "README.md")
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    b = text.find(README_BEGIN)
    e = text.find(README_END)
    if b < 0 or e < 0:
        return False
    new = (text[: b + len(README_BEGIN)] + "\n"
           + flags_registry.render_markdown_table() + "\n"
           + text[e:])
    if new != text:
        with open(readme, "w", encoding="utf-8") as f:
            f.write(new)
        return True
    return False
