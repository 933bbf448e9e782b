"""The metric-name catalog: every key the port emits, in one place.

The port's copy of the JAX package's ``obs/names.py``.  Every
metric/counter/gauge/phase/event key emitted anywhere in
``spark_gp_tpu_torch`` must (a) be dot-separated lowercase
(``[a-z0-9_]+(\\.[a-z0-9_]+)*``) and (b) appear in :data:`CATALOG`;
:func:`check_package` walks the package's AST and reports every emission
that breaks either rule.  A key shared with the JAX package keeps its
name, kind and help text there; the ``kernel.*`` keys are the card's
counterparts of the JAX package's compile counting (a CUDA kernel is
built once by ``nvcc`` and launched by its wrapper).

Dynamic keys register as ``*`` patterns (``restart_*_nll``,
``kernel.launches.*``); the wildcard part is runtime data and exempt
from the lowercase grammar.  A pattern may name the exposition ``label``
the wildcard maps to (``kernel.launches.spd_inv_logdet`` renders as
``gp_kernel_launches_total{kernel="spd_inv_logdet"}``).
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

#: concrete-key grammar: lowercase [a-z0-9_] components, dot-separated
KEY_GRAMMAR = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)*$")
#: pattern grammar: same, plus ``*`` wildcards for runtime-data parts
PATTERN_GRAMMAR = re.compile(r"^[a-z0-9_*]+(\.[a-z0-9_*]+)*$")


@dataclass(frozen=True)
class MetricName:
    """One registered key (or ``*`` pattern) and how to expose it."""

    key: str
    #: counter | gauge | metric (fit scalar) | phase (timing) | event
    #: (span/recorder event name) | info (label-only identity)
    kind: str
    help: str
    #: for patterns: the exposition label the wildcard part becomes
    label: Optional[str] = None


CATALOG: Tuple[MetricName, ...] = (
    # -- fit metrics (model.metrics / Instrumentation.log_metric) ----------
    MetricName("num_experts", "metric", "experts in the grouped stack"),
    MetricName("expert_size", "metric", "rows per expert"),
    MetricName("num_classes", "metric", "classes inferred from training labels"),
    MetricName("final_nll", "metric", "optimizer's final objective value"),
    MetricName("final_nll_renormalized", "metric", "final_nll * bcm_renorm (full-stack comparable)"),
    MetricName("lbfgs_iters", "metric", "L-BFGS iterations"),
    MetricName("lbfgs_nfev", "metric", "objective evaluations"),
    MetricName("num_restarts", "metric", "multi-start restarts configured"),
    MetricName("best_restart", "metric", "winning restart index"),
    MetricName("restart_*_nll", "metric", "per-restart final NLL", label="restart"),
    MetricName("restarts_nfev", "metric", "objective evaluations summed over every host restart"),
    MetricName("objective", "metric", "regression training objective (marginal/loo/elbo)"),
    MetricName("likelihood", "metric", "count-regression likelihood (PoissonLikelihood/NegativeBinomialLikelihood)"),
    MetricName("newton_iterations", "metric", "Laplace Newton iterations over the fit"),
    MetricName("objective_calls", "metric", "latent-objective evaluations over the fit"),
    MetricName("ep_sweeps", "metric", "EP site sweeps over the fit"),
    MetricName("group_seconds", "metric", "host seconds of the group_experts phase"),
    MetricName("optimize_seconds", "metric", "host seconds of the optimize_hypers phase"),
    MetricName("ppa_seconds", "metric", "host seconds of the active_set, kmn_stats and magic_solve phases"),
    MetricName("experts_active_initial", "metric", "active experts before any quarantine"),
    MetricName("experts_quarantined", "metric", "experts dropped by screen/recovery"),
    MetricName("experts_jittered", "metric", "experts repaired by adaptive jitter"),
    MetricName("fit_retries", "metric", "recovery re-dispatches of the fit"),
    MetricName("bcm_renorm", "metric", "E_active / E_kept BCM renormalization factor"),
    MetricName("solver_lane", "metric", "solver lane the fit engaged (exact/iterative/matfree — ops/iterative.py, auto resolved)"),
    MetricName("solver.cg_iters", "metric", "iterative lane: max live CG iterations on the post-fit convergence probe"),
    MetricName("solver.precond_rank", "metric", "iterative lane: pivoted-Cholesky preconditioner rank k"),
    MetricName("solver.probes", "metric", "iterative lane: Hutchinson/SLQ probe vectors per log-det estimate"),
    MetricName("solver.residual", "metric", "iterative lane: max relative CG residual at the fitted theta (matfree fits probe through the same injected streamed matvec the fit ran)"),
    MetricName("solver.matfree_engaged", "metric", "1 when the matrix-free streamed-matvec lane executed the fit (0: matfree requested but the kernel carries no matvec — materialized fallback ran)"),
    MetricName("solver.matvec_tiles", "metric", "matfree lane: row panels per streamed gram.vector pass (ceil(s / GP_MATVEC_TILE))"),
    MetricName("gram_cache_engaged", "metric", "1 when the theta-invariant gram cache served the fit hot loop"),
    MetricName("agg.policy", "metric", "expert aggregation policy the fit engaged (poe/gpoe/rbcm/healed — models/aggregation.py)"),
    MetricName("agg.effective_experts", "metric", "participation ratio (sum w)^2 / sum w^2 of the per-expert weights"),
    MetricName("agg.selection_dropped", "metric", "experts masked out by fit-time redundancy selection"),
    MetricName("agg.renorm", "metric", "E_active / sum(w) weighted renormalization factor (quarantine.renorm_factor generalized)"),
    MetricName("*.failed", "metric", "a phase of this name raised", label="phase"),
    # -- memory planning (resilience/memplan.py) ---------------------------
    MetricName("plan.hit", "counter", "plan decisions whose chosen configuration was predicted-safe"),
    MetricName("plan.miss", "counter", "reactive recovery engaged despite (or no config fit) a plan decision"),
    MetricName("plan.margin_breach", "counter", "measured peaks that exceeded the margined prediction"),
    # -- degradation ladder (resilience/fallback.py) -----------------------
    MetricName("fallback.engaged", "metric", "1 when the fit completed through at least one degradation rung"),
    MetricName("fallback.transitions", "counter", "degradation-ladder rung transitions executed"),
    MetricName("fallback.exhausted", "counter", "ladders that ran out of applicable rungs (classified error raised)"),
    MetricName("fallback.rung.*", "counter", "transitions into this rung", label="rung"),
    MetricName("fallback.failures.*", "counter", "classified execution failures observed (closed taxonomy)", label="failure_class"),
    # -- phases (Instrumentation.phase -> timings) -------------------------
    MetricName("group_experts", "phase", "host grouping + pre-fit data screen"),
    MetricName("optimize_hypers", "phase", "hyperparameter optimization"),
    MetricName("active_set", "phase", "active-set provider selection"),
    MetricName("kmn_stats", "phase", "distributed (U1, u2) accumulation"),
    MetricName("magic_solve", "phase", "host f64 PPA magic solve"),
    # -- runtime telemetry (obs/runtime.py) --------------------------------
    MetricName("kernel.builds.*", "counter", "nvcc builds of a hand-written CUDA kernel source", label="kernel"),
    MetricName("kernel.launches.*", "counter", "launches of a hand-written CUDA kernel by its wrapper", label="kernel"),
    MetricName("memory.bytes_in_use", "gauge", "device HBM bytes in use at the last sample"),
    MetricName("memory.peak_bytes_in_use", "gauge", "peak device HBM bytes in use"),
    MetricName("memory.bytes_reserved", "gauge", "device bytes held by the CUDA caching allocator at the last sample"),
    MetricName("memory.host_peak_rss_bytes", "gauge", "host process peak RSS (CPU fallback proxy)"),
    # -- forensics plane (obs/recorder.py) ---------------------------------
    MetricName("incident.bundles", "counter", "incident bundles assembled on terminal classified failures"),
    MetricName("incident.bundle_failures", "counter", "incident bundles that could not be persisted"),
    MetricName("build", "info", "build/runtime identity (package, torch, CUDA, backend, lane, process count)"),
    # -- span/recorder event names (trace.add_event / RECORDER.record) -----
    MetricName("error", "event", "span closed with an escaping exception"),
    MetricName("experts.quarantined", "event", "experts dropped by screen/recovery"),
    MetricName("experts.jittered", "event", "experts repaired by adaptive jitter"),
    MetricName("experts.deselected", "event", "redundant experts dropped/down-weighted by aggregation selection"),
    MetricName("fit.retry", "event", "recovery re-dispatch of a fit attempt"),
    MetricName("fallback.failure", "event", "classified execution failure observed"),
    MetricName("plan.decision", "event", "memory-plan admission decision (chosen config, predicted bytes, budget)"),
    MetricName("kernel.build", "event", "nvcc build of a kernel source on the current span"),
    MetricName("incident.bundle", "event", "incident bundle dumped"),
)

_EXACT = {spec.key: spec for spec in CATALOG if "*" not in spec.key}
_PATTERNS = tuple(spec for spec in CATALOG if "*" in spec.key)


def lookup(key: str) -> Optional[MetricName]:
    """Catalog entry for a CONCRETE emitted key (exact match first, then
    ``*`` patterns), or None when unregistered."""
    spec = _EXACT.get(key)
    if spec is not None:
        return spec
    for spec in _PATTERNS:
        if fnmatch.fnmatchcase(key, spec.key):
            return spec
    return None


def is_registered(key_or_pattern: str) -> bool:
    """True when an emission is covered by the catalog.  An emitted
    PATTERN (an f-string whose dynamic parts the linter wildcards) must
    equal a registered pattern verbatim."""
    if "*" in key_or_pattern:
        return any(spec.key == key_or_pattern for spec in _PATTERNS)
    return lookup(key_or_pattern) is not None


def grammar_ok(key_or_pattern: str) -> bool:
    """The naming grammar: dot-separated lowercase components, ``*``
    allowed only in patterns (runtime-data parts)."""
    grammar = PATTERN_GRAMMAR if "*" in key_or_pattern else KEY_GRAMMAR
    return bool(grammar.match(key_or_pattern))


# -- the lint (the JAX package's tools/check_metric_names.py) ---------------

#: calls whose first argument is an emitted key
_EMITTERS = {
    "inc", "set_gauge", "observe", "log_metric", "phase", "add_event", "record",
}
#: attribute dicts whose subscript writes are emissions
_METRIC_DICTS = {"metrics", "counters", "gauges", "timings"}
#: a trailing comment that exempts one line, greppable
ALLOW = "metric-name-ok"

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key_expr(node: ast.expr) -> Optional[str]:
    """Constant string -> the key; f-string -> a ``*``-wildcarded pattern;
    anything else -> None (not statically checkable)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        return "".join(
            v.value if isinstance(v, ast.Constant) and isinstance(v.value, str) else "*"
            for v in node.values
        )
    return None


def _emissions(tree: ast.AST) -> List[Tuple[int, str]]:
    """``(lineno, key_or_pattern)`` for every statically-visible emission."""
    found: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _EMITTERS and node.args:
                key = _key_expr(node.args[0])
                if key is not None:
                    found.append((node.lineno, key))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                if (
                    isinstance(target, ast.Subscript)
                    and isinstance(target.value, ast.Attribute)
                    and target.value.attr in _METRIC_DICTS
                ):
                    key = _key_expr(target.slice)
                    if key is not None:
                        found.append((target.lineno, key))
    return found


def check_source(source: str, path: str = "<source>") -> List[Tuple[str, int, str, str]]:
    """``(path, line, key, why)`` for every ill-formed or unregistered
    emission in one module's source."""
    lines = source.splitlines()
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [(path, exc.lineno or 0, "<unparseable>", str(exc))]
    violations = []
    for lineno, key in _emissions(tree):
        if ALLOW in (lines[lineno - 1] if 0 < lineno <= len(lines) else ""):
            continue
        if not grammar_ok(key):
            violations.append((path, lineno, key,
                               "not dot-separated lowercase ([a-z0-9_]+, '.'-joined)"))
        elif not is_registered(key):
            violations.append((path, lineno, key,
                               "not registered in spark_gp_tpu_torch/obs/names.py"))
    return violations


def check_package(root: Optional[str] = None) -> List[Tuple[str, int, str, str]]:
    """Every violation under ``root`` (default: this package): an empty
    list means every emitted key is well-formed and catalogued."""
    violations = []
    for dirpath, dirnames, filenames in os.walk(os.path.abspath(root or PACKAGE_ROOT)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as fh:
                    violations.extend(check_source(fh.read(), path))
    return violations
