"""The wire error-code catalog: every ``code`` a serve surface emits (the
port's copy of the JAX package's ``serve/codes.py``, the same codes).

Clients branch on these codes (retry on the shed classes, fail over on
the infrastructure classes), so a renamed or uncatalogued code breaks the
protocol.  Every ``code`` that can reach a client -- an exception class's
``code`` attribute or a literal ``"code"`` field of a reply -- satisfies
the dot-separated-lowercase grammar and is registered here
(``tests/test_torch_serve.py`` walks the package for them).  The router
and integrity codes are the multi-replica fleet's, kept so both packages
speak one vocabulary.
"""

from __future__ import annotations

import re
from typing import Dict

#: same grammar as metric keys: lowercase [a-z0-9_] components, dot-joined
CODE_GRAMMAR = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)*$")

#: code -> operator/client-facing meaning.  Grouped by the surface that
#: emits it; docs/SERVING.md and docs/RESILIENCE.md describe the client
#: contract per class.
ERROR_CODES: Dict[str, str] = {
    # -- single-replica shed / failure classes (serve/queue.py, lifecycle)
    "queue.shed.deadline": (
        "request deadline expired while queued — the server is saturated"
    ),
    "queue.shed.backpressure": (
        "submit rejected on a full queue — retry with backoff or add capacity"
    ),
    "queue.shed.draining": (
        "server draining for shutdown — retry against another replica"
    ),
    "queue.shed.memory": (
        "submit shed by the memory admission gate (low priority or "
        "predicted bytes over headroom)"
    ),
    "exec.hung": (
        "dispatch exceeded its hang deadline; the model's breaker tripped"
    ),
    "shed.breaker": (
        "the model's circuit breaker is open — retry after its cooldown"
    ),
    # -- observe verb / quality plane (server.observe, obs/quality.py) -----
    "observe.unknown_request": (
        "observation names a request_id with no pending prediction "
        "(never served with an id here, or evicted from the bounded "
        "pending ring)"
    ),
    "observe.disabled": (
        "observation reached a server whose statistical quality plane "
        "is disabled (GP_SERVE_QUALITY=0 / --quality 0)"
    ),
    # -- router failover codes (serve/router.py) ---------------------------
    "router.no_replicas": (
        "no live serving replica owns the request's ring key"
    ),
    "router.replica_unreachable": (
        "the owning replica's transport is down (killed or partitioned)"
    ),
    "router.failover_exhausted": (
        "every eligible ring replica failed within the failover budget"
    ),
    "router.deadline": (
        "the request's overall deadline lapsed across failover attempts"
    ),
    # -- serve CLI connection hygiene (serve/__main__.py TCP mode) ---------
    "serve.conn_limit": (
        "connection rejected: the TCP server is at --max-connections"
    ),
    "serve.conn_idle": (
        "connection closed: no line arrived within --conn-read-timeout-s"
    ),
    # -- numerical integrity verdicts (resilience/integrity.py) ------------
    # the ``IntegrityError.code`` vocabulary: carried by ``integrity.*``
    # events and ``sdc``-classed incident bundles (fit plane), and by the
    # registry's bind-time refusal of a corrupted artifact (serve plane) —
    # operators and supervisors branch on these exactly like wire codes
    "header_corrupt": (
        "an attested collective payload's seal header failed to parse"
    ),
    "identity_mismatch": (
        "an attested payload claims a different publishing pid than its slot"
    ),
    "stale_replay": (
        "an attested payload carries a previous round's collective name "
        "(a stuck link re-delivering old bytes)"
    ),
    "digest_mismatch": (
        "an attested payload's bytes do not match its sealed sha256"
    ),
    "bounds": (
        "a finite collective contribution breached GP_INTEGRITY_MAX_ABS"
    ),
    "spot_check_claim": (
        "a duplicate-dispatch recompute disproved the target host's "
        "published (NLL, |grad|) claim — definitive quarantine"
    ),
    "spot_check_verifier": (
        "a verifying host's recomputed probe values sat in the minority "
        "across spot-check rounds — strikes exhausted"
    ),
    "panel_divergence": (
        "a replicated Cholesky diagonal panel diverged across devices"
    ),
    "model_sidecar_digest_mismatch": (
        "a model artifact's bytes do not match its sha256 sidecar — "
        "refused at load/registry-bind time"
    ),
}


def is_registered(code: str) -> bool:
    return code in ERROR_CODES


def grammar_ok(code: str) -> bool:
    return bool(CODE_GRAMMAR.match(code))
