"""ktpu-lint: repo-invariant static analysis, enforced in tier-1.

Five load-bearing contracts in this tree existed only as prose and
runtime differential tests: solve-path bit-identity, structural
kill-switch degradation, jit-purity of everything the fused programs
close over, lock discipline across the apiserver/informer/serving
threads, and a sprawl of `KTPU_*` env reads. This package turns them
into machine-checked invariants — the analog of the reference shipping
`go vet` + race-detector gates on the scheduling cycle — so a rewrite of
the hottest path has its regressions caught at analysis time.

Four passes (each a module, each with its own finding codes):

- `jit_purity` (JP1xx) — host syncs, wall-clock/randomness, and Python
  branching on traced values, in everything reachable from the
  jitted/scan entry points.
- `locks` (LK2xx) — static lock-order graph (cycles), locks held
  across await/device-fetch/wire-send, guarded state iterated without
  its lock. Cross-validated at runtime by `utils/locking.py`
  (`KTPU_LOCK_CHECK=1`).
- `flags_pass` (FL3xx) — every `KTPU_*` env read routes through
  `utils/flags.py`; registry entries carry docs and tests; the README
  flag table is generated, not hand-maintained.
- `metrics_lint` (MT4xx) — Prometheus naming/unit/label-cardinality
  conventions over `metrics/registry.py`.

Findings resolve against `analysis/baseline.json` — a triaged
suppression list keyed by (pass, code, path, symbol), no line numbers,
each entry carrying a reason string. The tier-1 gate
(tests/test_torch_analysis.py) asserts zero UNSUPPRESSED findings.

CLI (`python -m kubernetes_tpu_torch.analysis`):
exit 0 = clean, 1 = findings, 2 = internal error (ruff-style, so the
gate is scriptable). `--json` emits machine-readable findings.

Copy of `kubernetes_tpu/analysis/` over this package's tree
(`kubernetes_tpu_torch/` and `chip_smoke.py`) with its own baseline and
README flag table. This package imports no `jax`, so `jit_purity` finds
no entry point in it; the pass is kept so that one would be checked.
It loads neither `torch` nor `jax`.
"""

from __future__ import annotations

import json
import sys
import traceback

from kubernetes_tpu_torch.analysis.engine import (
    Finding,
    apply_baseline,
    load_baseline,
    load_modules,
)

__all__ = ["Finding", "run_all", "main"]

#: pass registry: id -> runner(modules) -> [Finding]
def _passes():
    from kubernetes_tpu_torch.analysis import (
        flags_pass,
        jit_purity,
        locks,
        metrics_lint,
    )
    return (
        (jit_purity.PASS_ID, jit_purity.run),
        (locks.PASS_ID, locks.run),
        (flags_pass.PASS_ID, flags_pass.run),
        (metrics_lint.PASS_ID, metrics_lint.run),
    )


def run_all(root: str | None = None,
            baseline: dict[str, str] | None = None):
    """Run every pass over the tree. Returns
    (unsuppressed, suppressed, stale_keys, per_pass_counts)."""
    modules = load_modules(root)
    findings: list[Finding] = []
    per_pass: dict[str, int] = {}
    for pass_id, runner in _passes():
        got = runner(modules)
        per_pass[pass_id] = len(got)
        findings.extend(got)
    if baseline is None:
        baseline = load_baseline()
    unsup, sup, stale = apply_baseline(findings, baseline)
    return unsup, sup, stale, per_pass


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, suppressed or not")
    ap.add_argument("--baseline", default=None,
                    help="alternate baseline file")
    ap.add_argument("--write-readme-flags", action="store_true",
                    help="regenerate the README's generated flag table "
                         "from utils/flags.py and exit")
    args = ap.parse_args(argv)

    try:
        if args.write_readme_flags:
            from kubernetes_tpu_torch.analysis.flags_pass import (
                write_readme_table,
            )
            changed = write_readme_table()
            print("README flag table "
                  + ("updated" if changed else "already current"))
            return 0
        baseline = {} if args.no_baseline \
            else load_baseline(args.baseline)
        unsup, sup, stale, per_pass = run_all(baseline=baseline)
    except Exception:
        traceback.print_exc()
        return 2

    if args.json:
        print(json.dumps({
            "findings": [f.as_dict() for f in unsup],
            "suppressed": [f.as_dict() for f in sup],
            "stale_suppressions": stale,
            "per_pass": per_pass,
        }, indent=2))
    else:
        for f in unsup:
            print(f"{f.path}:{f.line}: {f.code} [{f.pass_id}] "
                  f"{f.message}")
        print(f"ktpu-lint: {sum(per_pass.values())} finding(s) across "
              f"{len(per_pass)} passes "
              f"({', '.join(f'{k}={v}' for k, v in per_pass.items())}); "
              f"{len(sup)} suppressed by baseline, "
              f"{len(unsup)} unsuppressed")
        if stale:
            print(f"warning: {len(stale)} stale baseline suppression(s) "
                  "match nothing — prune analysis/baseline.json:")
            for k in stale:
                print(f"  - {k}")
    return 1 if unsup else 0
