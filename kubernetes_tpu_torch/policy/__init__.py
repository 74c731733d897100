"""Policy engine subsystem (SURVEY §3.2 admission + §5.5 audit).

Three layers:

- `expr.py` — the sandboxed expression evaluator (the CEL analog): a
  restricted AST-walk interpreter over `object` / `oldObject` /
  `request` / `params` with a hard cost budget and no path to Python
  attributes, imports, or builtins.
- `vap.py` — ValidatingAdmissionPolicy + ValidatingAdmissionPolicyBinding
  evaluation (`admissionregistration.k8s.io` shapes as stored resources),
  consumed by `apiserver/admission.py` before validating webhooks.
- `audit.py` — the policy-driven audit pipeline (levels
  None|Metadata|Request|RequestResponse, RequestReceived →
  ResponseComplete stage events, bounded async JSON sink), registered on
  both wires plus the gRPC interceptor chain.

Copy of `kubernetes_tpu/policy/__init__.py`.
"""

from kubernetes_tpu_torch.policy.audit import (  # noqa: F401
    AuditPipeline,
    AuditPolicy,
    AuditSink,
    LEVEL_METADATA,
    LEVEL_NONE,
    LEVEL_REQUEST,
    LEVEL_REQUEST_RESPONSE,
)
from kubernetes_tpu_torch.policy.expr import (  # noqa: F401
    BudgetExceeded,
    CompiledExpression,
    ExpressionError,
    compile_expression,
)
from kubernetes_tpu_torch.policy.vap import (  # noqa: F401
    PolicyDenied,
    PolicyEngine,
)
