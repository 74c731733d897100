"""Sandboxed admission-expression evaluator — the CEL analog.

Parity target: the expression language ValidatingAdmissionPolicy uses
(`staging/src/k8s.io/apiserver/pkg/admission/plugin/cel`): expressions
over `object`, `oldObject`, `request`, `params` that must be (a) unable
to reach anything outside those values and (b) bounded in cost (the
reference compiles CEL with a per-expression cost limit and interrupts
evaluation when the runtime budget is exhausted).

This is NOT Python `eval` of user text. Compilation has two stages:

1. **Whitelist validation**: the source parses with `ast.parse` and
   every node must belong to a small allowed grammar — no calls beyond
   a fixed function set, no underscored identifiers, no lambdas,
   f-strings, starred/keyword args, `**`, or non-scalar literals.
2. **Safe-rewrite + bytecode compile** (the admission hot path runs
   ~10 policy evaluations per request, so evaluation must be native
   speed, not a tree walk): the validated AST is REWRITTEN so that
   every attribute access, subscript, method call, concatenation, and
   comprehension iteration routes through a budget-ticking helper, then
   compiled once with `compile()`. Evaluation `eval()`s the code object
   under a globals dict containing ONLY the helpers, the safe function
   set, and the declared variables — `__builtins__` is empty.

The sandbox invariants:

- **No attribute escape**: `a.b` compiles to `_get(a, "b", budget)` — a
  *mapping lookup*; `getattr` is never reached, so `object.__class__`
  has no meaning (and underscored names are rejected at stage 1
  anyway). Values are only ever the JSON-shaped data handed in.
- **No names beyond the declared variables** (+ comprehension-bound
  locals): the globals dict is closed, builtins are empty.
- **Bounded cost**: helpers decrement a budget; exhaustion raises
  `BudgetExceeded` (comprehension bombs die in `_iter`). `+` results
  are size-capped; `**` and sequence repetition (`"x" * 10**9`) are
  rejected — `*` compiles to a numbers-only helper.

Functions mirror CEL's small standard library: `has()`, `size()`,
`string()`, `int()`, `double()`, `bool()`, `min`/`max`/`sum`,
`all`/`any` (with generator comprehensions standing in for CEL's
`.all()`/`.exists()` macros), and `startsWith`/`endsWith`/`contains`/
`matches`/`lowerAscii`/`upperAscii` string methods.

Copy of `kubernetes_tpu/policy/expr.py`.
"""

from __future__ import annotations

import ast
import re
# collections.abc, not typing: the runtime isinstance checks in the
# budget helpers are the hottest lines of the admission chain, and
# typing.Mapping's __instancecheck__ costs ~20x the abc-cached check.
from collections.abc import Mapping
from typing import Any

#: default per-evaluation step budget (the reference's runtime cost
#: limit analog). A typical policy expression uses < 100 steps.
DEFAULT_BUDGET = 10_000

#: max nodes in one compiled expression (compile-time cost limit).
MAX_NODES = 1_000

#: cap on sequence results built by `+` (string/list concat bombs).
MAX_RESULT_LEN = 1 << 16

#: cap on source length for `matches()` regexes and their haystacks.
MAX_REGEX_LEN = 256


class ExpressionError(Exception):
    """Compile- or eval-time failure of a policy expression."""


class BudgetExceeded(ExpressionError):
    """Evaluation ran past its cost budget."""


_MISSING = object()  # has()-tolerated absent-key sentinel

_ALLOWED_NODES = (
    ast.Expression,
    # logic
    ast.BoolOp, ast.And, ast.Or, ast.UnaryOp, ast.Not, ast.USub,
    ast.IfExp,
    # arithmetic (no Pow, no bit ops, no MatMult)
    ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
    # comparison
    ast.Compare, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.In, ast.NotIn,
    # data access + literals
    ast.Constant, ast.Name, ast.Load, ast.Attribute, ast.Subscript,
    ast.List, ast.Tuple, ast.Dict,
    # calls + comprehensions (CEL macro analogs)
    ast.Call, ast.GeneratorExp, ast.ListComp, ast.comprehension,
    ast.Store,
)

#: global functions callable by bare name (safe impls in _BASE_ENV).
_FUNCS = ("has", "size", "string", "int", "double", "bool",
          "min", "max", "sum", "all", "any")

#: whitelisted string "methods" (CEL's string functions).
_STR_METHODS = ("startsWith", "endsWith", "contains", "matches",
                "lowerAscii", "upperAscii")


def compile_expression(source: str) -> "CompiledExpression":
    """Whitelist-validate, safe-rewrite, and bytecode-compile one
    expression. Raises ExpressionError for anything outside the
    sandboxed grammar."""
    if not isinstance(source, str) or not source.strip():
        raise ExpressionError("empty expression")
    try:
        tree = ast.parse(source, mode="eval")
    except (SyntaxError, ValueError, MemoryError, RecursionError) as e:
        raise ExpressionError(f"cannot parse expression: {e}") from e
    count = 0
    for node in ast.walk(tree):
        count += 1
        if count > MAX_NODES:
            raise ExpressionError("expression too large")
        if not isinstance(node, _ALLOWED_NODES):
            raise ExpressionError(
                f"forbidden syntax: {type(node).__name__}")
        if isinstance(node, ast.Constant) and not isinstance(
                node.value, (str, int, float, bool, type(None))):
            raise ExpressionError(
                f"forbidden literal: {type(node.value).__name__}")
        if isinstance(node, ast.Dict) and None in node.keys:
            raise ExpressionError("dict unpacking is forbidden")
        if isinstance(node, (ast.Name, ast.Attribute)):
            ident = node.id if isinstance(node, ast.Name) else node.attr
            if ident.startswith("_"):
                raise ExpressionError(f"forbidden identifier {ident!r}")
        if isinstance(node, ast.comprehension):
            if node.is_async:
                raise ExpressionError("async comprehension forbidden")
            if not isinstance(node.target, ast.Name):
                raise ExpressionError(
                    "comprehension target must be a simple name")
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name):
                if fn.id not in _FUNCS:
                    raise ExpressionError(f"unknown function {fn.id!r}")
                if fn.id == "has" and (
                        len(node.args) != 1 or not isinstance(
                            node.args[0],
                            (ast.Attribute, ast.Subscript))):
                    raise ExpressionError("has() takes one field path")
            elif isinstance(fn, ast.Attribute):
                if fn.attr not in _STR_METHODS:
                    raise ExpressionError(f"unknown method {fn.attr!r}")
            else:
                raise ExpressionError("computed calls are forbidden")
            if node.keywords:
                raise ExpressionError("keyword arguments are forbidden")
    rewritten = ast.fix_missing_locations(_Rewriter().visit(tree))
    try:
        code = compile(rewritten, "<policy-expression>", "eval")
    except (SyntaxError, ValueError, RecursionError) as e:
        raise ExpressionError(f"cannot compile expression: {e}") from e
    return CompiledExpression(source, code)


class _Rewriter(ast.NodeTransformer):
    """Rewrite the VALIDATED tree so every operation that could escape
    the data model or run unbounded routes through a helper. After this
    pass no raw Attribute/Subscript nodes remain."""

    def _b(self) -> ast.Name:
        return ast.Name(id="_b", ctx=ast.Load())

    def _call(self, helper: str, args: list) -> ast.Call:
        return ast.Call(func=ast.Name(id=helper, ctx=ast.Load()),
                        args=args, keywords=[])

    def visit_Attribute(self, node: ast.Attribute) -> ast.Call:
        return self._call("_get", [self.visit(node.value),
                                   ast.Constant(node.attr), self._b()])

    def visit_Subscript(self, node: ast.Subscript) -> ast.Call:
        return self._call("_idx", [self.visit(node.value),
                                   self.visit(node.slice), self._b()])

    def _tolerant(self, node) -> ast.expr:
        """has()'s field path: absent keys yield _MISSING instead of
        raising, through the whole chain."""
        if isinstance(node, ast.Attribute):
            return self._call("_get_t", [self._tolerant(node.value),
                                         ast.Constant(node.attr),
                                         self._b()])
        if isinstance(node, ast.Subscript):
            return self._call("_idx_t", [self._tolerant(node.value),
                                         self.visit(node.slice),
                                         self._b()])
        return self.visit(node)

    def visit_Call(self, node: ast.Call) -> ast.Call:
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "has":
            return self._call("_has", [self._tolerant(node.args[0])])
        if isinstance(fn, ast.Attribute):
            # whitelisted string method → _meth(recv, name, args, _b)
            return self._call("_meth", [
                self.visit(fn.value), ast.Constant(fn.attr),
                ast.Tuple(elts=[self.visit(a) for a in node.args],
                          ctx=ast.Load()),
                self._b()])
        return self._call(fn.id, [self.visit(a) for a in node.args])

    def visit_BinOp(self, node: ast.BinOp) -> ast.expr:
        left, right = self.visit(node.left), self.visit(node.right)
        if isinstance(node.op, ast.Add):
            return self._call("_add", [left, right])
        if isinstance(node.op, ast.Mult):
            return self._call("_mul", [left, right])
        if isinstance(node.op, ast.Mod):
            # native % on a str left operand is printf formatting — a
            # "%09999999d" constant would be a memory bomb.
            return self._call("_mod", [left, right])
        return ast.BinOp(left=left, op=node.op, right=right)

    def _wrap_comp(self, node):
        self.generic_visit(node)
        for gen in node.generators:
            gen.iter = self._call("_iter", [gen.iter, self._b()])
        return node

    def visit_GeneratorExp(self, node):
        return self._wrap_comp(node)

    def visit_ListComp(self, node):
        return self._wrap_comp(node)


# ---------------------------------------------------------------------------
# runtime helpers (the only callables reachable from compiled code)
# ---------------------------------------------------------------------------

_BUDGET_MSG = "expression cost budget exceeded"


def _get(base: Any, attr: str, b: list) -> Any:
    # budget tick inlined (this is the hottest helper: one call per
    # field access, ~10 policy evaluations per admitted request); the
    # `type is dict` check short-circuits the abc isinstance — nearly
    # every value here is a plain JSON dict.
    b[0] -= 1
    if b[0] < 0:
        raise BudgetExceeded(_BUDGET_MSG)
    if type(base) is not dict and not isinstance(base, Mapping):
        raise ExpressionError(
            f"field access {attr!r} on non-object "
            f"{type(base).__name__}")
    if attr in base:
        return base[attr]
    raise ExpressionError(f"no such field {attr!r}")


def _get_t(base: Any, attr: str, b: list) -> Any:
    b[0] -= 1
    if b[0] < 0:
        raise BudgetExceeded(_BUDGET_MSG)
    if type(base) is not dict and (
            base is _MISSING or not isinstance(base, Mapping)):
        return _MISSING
    return base[attr] if attr in base else _MISSING


def _idx(base: Any, idx: Any, b: list) -> Any:
    b[0] -= 1
    if b[0] < 0:
        raise BudgetExceeded(_BUDGET_MSG)
    if type(base) is dict or isinstance(base, Mapping):
        if idx in base:
            return base[idx]
        raise ExpressionError(f"no such key {idx!r}")
    if isinstance(base, (list, tuple, str)) and \
            isinstance(idx, int) and not isinstance(idx, bool):
        try:
            return base[idx]
        except IndexError:
            raise ExpressionError(f"index {idx!r} out of range") \
                from None
    raise ExpressionError(
        f"cannot index {type(base).__name__} with {idx!r}")


def _idx_t(base: Any, idx: Any, b: list) -> Any:
    if base is _MISSING:
        return _MISSING
    try:
        return _idx(base, idx, b)
    except BudgetExceeded:
        raise
    except ExpressionError:
        return _MISSING


def _has(v: Any) -> bool:
    return v is not _MISSING


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _add(lhs: Any, rhs: Any) -> Any:
    if isinstance(lhs, str) and isinstance(rhs, str):
        if len(lhs) + len(rhs) > MAX_RESULT_LEN:
            raise BudgetExceeded("string result too large")
        return lhs + rhs
    if isinstance(lhs, list) and isinstance(rhs, list):
        if len(lhs) + len(rhs) > MAX_RESULT_LEN:
            raise BudgetExceeded("list result too large")
        return lhs + rhs
    if _is_num(lhs) and _is_num(rhs):
        return lhs + rhs
    raise ExpressionError(
        f"cannot add {type(lhs).__name__} and {type(rhs).__name__}")


def _mul(lhs: Any, rhs: Any) -> Any:
    # Numbers only: sequence repetition is a memory bomb, and CEL has
    # no such operator either.
    if _is_num(lhs) and _is_num(rhs):
        return lhs * rhs
    raise ExpressionError("operator needs numbers, got "
                          f"{type(lhs).__name__} and "
                          f"{type(rhs).__name__}")


def _mod(lhs: Any, rhs: Any) -> Any:
    if _is_num(lhs) and _is_num(rhs):
        try:
            return lhs % rhs
        except ZeroDivisionError:
            raise ExpressionError("division by zero") from None
    raise ExpressionError("operator needs numbers, got "
                          f"{type(lhs).__name__} and "
                          f"{type(rhs).__name__}")


def _iter(src: Any, b: list):
    if not isinstance(src, (list, tuple)):
        raise ExpressionError("comprehension needs a list")
    for item in src:
        b[0] -= 1
        if b[0] < 0:
            raise BudgetExceeded(_BUDGET_MSG)
        yield item


def _meth(recv: Any, name: str, args: tuple, b: list) -> Any:
    b[0] -= 1
    if b[0] < 0:
        raise BudgetExceeded(_BUDGET_MSG)
    if not isinstance(recv, str):
        raise ExpressionError(
            f"{name}() needs a string receiver, got "
            f"{type(recv).__name__}")
    if name in ("lowerAscii", "upperAscii"):
        _arity(name, args, 0)
        return recv.lower() if name == "lowerAscii" else recv.upper()
    (arg,) = _arity(name, args, 1)
    if not isinstance(arg, str):
        raise ExpressionError(f"{name}() needs a string argument")
    if name == "startsWith":
        return recv.startswith(arg)
    if name == "endsWith":
        return recv.endswith(arg)
    if name == "contains":
        return arg in recv
    # matches: bounded regex — cap pattern + haystack size so
    # catastrophic backtracking can't stall the apiserver.
    if len(arg) > MAX_REGEX_LEN or len(recv) > MAX_REGEX_LEN * 16:
        raise BudgetExceeded("matches() input too large")
    try:
        return re.search(arg, recv) is not None
    except re.error as e:
        raise ExpressionError(f"bad regex: {e}") from None


def _arity(name: str, args, n: int):
    if len(args) != n:
        raise ExpressionError(f"{name}() takes {n} argument(s), "
                              f"got {len(args)}")
    return args


def _fn_size(v: Any) -> int:
    if isinstance(v, (str, list, tuple, dict)):
        return len(v)
    raise ExpressionError("size() needs a string/list/map")


def _fn_string(v: Any) -> str:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return "" if v is None else str(v)
    raise ExpressionError("string() needs a scalar")


def _fn_int(v: Any) -> int:
    try:
        return int(v)
    except (TypeError, ValueError) as e:
        raise ExpressionError(f"int(): {e}") from None


def _fn_double(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError) as e:
        raise ExpressionError(f"double(): {e}") from None


def _agg(name: str, native):
    def fn(*args):
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            args = tuple(args[0])
        if not args:
            raise ExpressionError(f"{name}() of empty sequence")
        if not all(_is_num(a) for a in args):
            raise ExpressionError(f"{name}() needs numbers")
        return native(args)
    return fn


def _pred(name: str, native):
    def fn(v):
        if isinstance(v, (str, Mapping)) or not hasattr(v, "__iter__"):
            raise ExpressionError(f"{name}() needs a list")
        return native(bool(x) for x in v)
    return fn


#: the closed globals every compiled expression runs under. Helpers are
#: underscore-named — unreachable from source (stage-1 rejects
#: underscored identifiers) but emitted by the rewriter.
_BASE_ENV = {
    "__builtins__": {},
    "_get": _get, "_get_t": _get_t, "_idx": _idx, "_idx_t": _idx_t,
    "_has": _has, "_add": _add, "_mul": _mul, "_mod": _mod,
    "_iter": _iter, "_meth": _meth,
    "size": _fn_size, "string": _fn_string, "int": _fn_int,
    "double": _fn_double, "bool": bool,
    "min": _agg("min", min), "max": _agg("max", max),
    "sum": _agg("sum", sum),
    "all": _pred("all", all), "any": _pred("any", any),
}


def make_env(variables: Mapping[str, Any]) -> dict:
    """Build an evaluation environment once and reuse it across many
    `CompiledExpression.evaluate_env` calls (the admission hot path
    evaluates every bound policy against one request — rebuilding the
    helper dict per expression was measurable). Mutate the returned
    dict's variable entries (e.g. `env["params"] = ...`) between calls."""
    env = dict(_BASE_ENV)
    env.update(variables)
    return env


class CompiledExpression:
    """One validated, safe-rewritten, bytecode-compiled expression,
    reusable across evaluations (policies compile once per
    resourceVersion)."""

    __slots__ = ("source", "_code")

    def __init__(self, source: str, code):
        self.source = source
        self._code = code

    def evaluate_env(self, env: dict,
                     budget: int = DEFAULT_BUDGET) -> Any:
        """Evaluate inside a `make_env` dict (shared across expressions;
        a fresh budget is installed per call). Raises ExpressionError on
        any type/lookup failure, BudgetExceeded past the step budget.

        Everything lives in the GLOBALS dict (not locals) so names
        resolve inside comprehension frames too."""
        env["_b"] = [budget]
        try:
            return eval(self._code, env)  # noqa: S307 — sandboxed code
        except ExpressionError:
            raise
        except NameError as e:
            raise ExpressionError(f"unknown variable: {e}") from None
        except (TypeError, ValueError, KeyError, IndexError,
                ZeroDivisionError, AttributeError, OverflowError,
                RecursionError) as e:
            raise ExpressionError(f"evaluation failed: {e}") from None

    def evaluate_shared(self, env: dict) -> Any:
        """Evaluate inside an ALREADY-BUDGETED env (no fresh budget
        installed): the `variables.<name>` composition path, where a
        lazily-evaluated variable must tick the enclosing expression's
        budget instead of minting its own — a chain of variables cannot
        multiply the per-expression cost limit."""
        try:
            return eval(self._code, env)  # noqa: S307 — sandboxed code
        except ExpressionError:
            raise
        except NameError as e:
            raise ExpressionError(f"unknown variable: {e}") from None
        except (TypeError, ValueError, KeyError, IndexError,
                ZeroDivisionError, AttributeError, OverflowError,
                RecursionError) as e:
            raise ExpressionError(f"evaluation failed: {e}") from None

    def evaluate(self, variables: Mapping[str, Any],
                 budget: int = DEFAULT_BUDGET) -> Any:
        """One-shot convenience over evaluate_env."""
        return self.evaluate_env(make_env(variables), budget)
