"""Policy-envelope checks of the device action.

The device solve (torch_allocate's fused and sharded rungs) hardwires the
reference's *default* conf semantics: priority/gang ordering,
drf/proportion shares, the built-in predicate chain
(predicates.go:57-203) and the nodeorder score formulas
(nodeorder.go:155-222). A conf that registers anything else — an unknown
plugin contributing predicate or node-order fns, or a non-default enable
flag — would make the solve silently diverge from the serial oracle, so
the action checks its envelope here and routes the cycle to the serial
action when outside it.

The JAX package's set also holds ``tensorscore`` (nodeorder's scores as
vectors); this port has no such plugin yet, so a conf naming it is
outside the envelope here.
"""

from __future__ import annotations

from kube_batch_tpu_torch.framework.session import Session

# Plugins whose session hooks the solve models exactly (priority/gang
# ordering + barrier, drf/proportion shares, predicates masks, nodeorder
# score) or that register nothing the allocate loop consults
# (conformance: victim vetting only).
SUPPORTED_PLUGINS = {
    "priority",
    "gang",
    "conformance",
    "drf",
    "predicates",
    "proportion",
    "nodeorder",
}

# The per-plugin enable flags the conf schema knows (conf/__init__.py);
# the solve models the all-defaults (True) configuration of each.
ENABLE_FLAGS = (
    "enabled_job_order",
    "enabled_job_ready",
    "enabled_job_pipelined",
    "enabled_task_order",
    "enabled_preemptable",
    "enabled_reclaimable",
    "enabled_queue_order",
    "enabled_predicate",
    "enabled_node_order",
)


def scan_supported(ssn: Session) -> bool:
    """True when every configured plugin's predicate/score contribution is
    one the solve's node sweep models (the built-in predicate set and the
    nodeorder score formulas), with default enable flags. The predicates
    plugin must be *present*: without it the serial chain treats every
    node as feasible while the solve would still apply its masks."""
    names = []
    for tier in ssn.tiers:
        for option in tier.plugins:
            if option.name not in SUPPORTED_PLUGINS:
                return False
            if not all(getattr(option, flag, True) for flag in ENABLE_FLAGS):
                return False
            names.append(option.name)
    return "predicates" in names


def kernel_supported(ssn: Session) -> bool:
    """True when the tiers describe exactly the policy the allocate kernel
    models: every plugin in the supported set with default enable flags
    (`scan_supported`), plus the job-order chain reading
    priority -> gang -> (drf) and predicates present for the masks. The
    reference's default conf (util.go:31-42) passes. Anything else would
    make the kernel silently diverge from the serial oracle, so the
    action falls back."""
    if not scan_supported(ssn):
        return False
    order = [o.name for tier in ssn.tiers for o in tier.plugins]
    if "priority" not in order or "gang" not in order or "predicates" not in order:
        return False
    if order.index("priority") > order.index("gang"):
        return False
    # drf's job-order key sits after priority and gang in the kernel's
    # selection tuple; a conf ordering drf earlier would chain differently.
    if "drf" in order and order.index("drf") < order.index("gang"):
        return False
    return True
