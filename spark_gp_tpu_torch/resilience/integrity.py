"""The numerical integrity plane of the port (the JAX package's
``resilience/integrity.py``): content digests of written artifacts, the
sharded Cholesky's panel tripwire, and the attested collectives of the
key-value-store fit mode.

**Artifacts.**  A saved model is stamped with ``<path>.sha256``, the hex sha256 of its
bytes; :func:`verify_sidecar` refuses a file whose bytes no longer match
with ``CheckpointCorruptError`` carrying ``code =``
:data:`ARTIFACT_DIGEST_CODE`, so a flipped bit fails at load time with
its sidecar named instead of deserializing into a wrong model.  The file
format is the JAX package's: either package verifies the other's
sidecars.

**Panel tripwire.**  The row-sharded blocked Cholesky
(``ops/dist_linalg.py``) factors every diagonal panel ``L_kk``
redundantly on every rank; for a sample of the panels
(:func:`panel_checked`, at :func:`panel_sample_rate`) the ranks compare
their copies, and a copy that differs raises :class:`PanelMismatchError`
naming the rank (``pid``) on every rank.  The sample is a hash of the
panel index, the JAX package's, so both packages check the same panels.
``GP_INTEGRITY=0`` turns the tripwire off.

**Attested collectives.**  Every payload the store mode publishes
(``parallel/coord.kv_allgather``) is sealed (:func:`seal`) with a content
digest, its publisher's rank and the round-qualified collective name, and
every reader checks it (:func:`unseal`) before the rank-ordered sum, so a
flipped bit, a payload under another rank's name or a stale replayed
round raises :class:`AttestationError` naming its PUBLISHER on every rank.
Array payloads also pass a magnitude bar (:func:`bounds_violation`,
``GP_INTEGRITY_MAX_ABS``); non-finite values pass on purpose (the store
mode exchanges them so the per-expert recovery stays in lockstep).  The
wire format is the JAX package's byte for byte: a payload sealed by one
package unseals in the other.

**Spot checks.**  With probability ``GP_INTEGRITY_DUPCHECK_P`` an
objective evaluation of a store-mode regression fit (a pure hash of the
round, :func:`should_spot_check`, so every rank agrees) is audited by
duplicate dispatch (:func:`run_spot_check`): one rank republishes one
expert block and its claimed (NLL, |grad|_1); every rank recomputes the
claim from the published bytes with the same objective (on the card's
exact lane one K1 launch on a ``[1, s, s]`` stack) and the verdict falls
out of the :data:`TOLERANCE_LADDER`.  A contradicted claim is definitive
against the publisher; a verifier whose recompute disagrees earns a
strike.  :class:`TrustLedger` escalates trusted -> suspect ->
quarantined, and a quarantine raises :class:`HostQuarantinedError` on
every rank alike.  ``GP_INTEGRITY=0`` turns all of it off: the payloads
go raw.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


def enabled() -> bool:
    """The kill switch: ``GP_INTEGRITY=0`` (or ``false`` / ``off``) turns
    the panel tripwire off."""
    return os.environ.get("GP_INTEGRITY", "").strip().lower() not in ("0", "false", "off")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def max_abs_bound() -> float:
    """``GP_INTEGRITY_MAX_ABS``: the magnitude attestation bar.  Finite
    values past it in a published array payload are attributed to the
    publisher as corruption (default 1e18: far above any honest NLL,
    gradient or U1 entry, far below where a high-exponent bit flip lands)."""
    return _env_float("GP_INTEGRITY_MAX_ABS", 1e18)


def spot_check_p() -> float:
    """``GP_INTEGRITY_DUPCHECK_P``: the probability that an objective
    evaluation of a store-mode fit is audited by duplicate dispatch
    (default 0.05)."""
    return _env_float("GP_INTEGRITY_DUPCHECK_P", 0.05)


def quarantine_after() -> int:
    """``GP_INTEGRITY_QUARANTINE_AFTER``: non-definitive disagreement
    strikes before the trust ledger quarantines a rank (default 2)."""
    return max(1, int(_env_float("GP_INTEGRITY_QUARANTINE_AFTER", 2)))


def panel_sample_rate() -> float:
    """``GP_INTEGRITY_PANEL_SAMPLE``: the fraction of diagonal panels the
    sharded Cholesky's tripwire compares across ranks (default 0.25)."""
    return _env_float("GP_INTEGRITY_PANEL_SAMPLE", 0.25)


def _hash01(tag: str) -> float:
    h = hashlib.sha256(tag.encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


def panel_checked(k: int, rate: Optional[float] = None) -> bool:
    """Whether diagonal panel ``k`` is in a solve's tripwire sample: a pure
    hash of ``k``, so every rank takes the same branch."""
    rate = panel_sample_rate() if rate is None else rate
    return rate > 0.0 and _hash01(f"panel/{k}") < rate


class IntegrityError(RuntimeError):
    """Numerical evidence that attributes a wrong value to one publisher:
    ``pid`` is the implicated identity (a rank), ``code`` the verdict's
    kind.  ``resilience/fallback.classify_failure`` maps it to ``sdc``."""

    def __init__(self, message: str, *, pid=None, code: str = "integrity"):
        super().__init__(message)
        self.pid = pid
        self.code = code


class PanelMismatchError(IntegrityError):
    """Redundantly computed diagonal Cholesky panels differ across the
    ranks: silent corruption on one rank inside a sharded solve."""


class AttestationError(IntegrityError):
    """A published payload failed its attestation: content digest
    mismatch, wrong claimed identity, a stale replayed round, or an
    absurd-magnitude contribution."""


class HostQuarantinedError(IntegrityError):
    """The trust ledger quarantined a rank on duplicate-dispatch
    disagreement: the fit stops alike on every rank; resume elastically
    without the named one."""


# --- the attestation seal: MAGIC + len(header) + JSON header + payload --------

_MAGIC = b"GPIA1\n"


def _digest(payload: bytes) -> str:
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


def seal(name: str, pid: int, payload: bytes) -> bytes:
    """``payload`` behind its attestation header: the content digest, the
    publisher and the round-qualified collective name (binding the name
    refuses a stale round's sealed blob republished under a new round)."""
    header = json.dumps({"d": _digest(payload), "p": int(pid), "n": name}).encode()
    return _MAGIC + len(header).to_bytes(4, "big") + header + payload


def unseal(name: str, pid: int, blob: bytes, verify: bool = True) -> bytes:
    """Strip (and, when ``verify``, check) a sealed payload.  An unsealed
    blob passes untouched (a peer running with ``GP_INTEGRITY=0``).  A
    failure raises :class:`AttestationError` attributed to ``pid``, the
    rank whose key the blob arrived under."""
    if not blob.startswith(_MAGIC):
        return blob
    hlen = int.from_bytes(blob[len(_MAGIC):len(_MAGIC) + 4], "big")
    body_at = len(_MAGIC) + 4 + hlen
    try:
        header = json.loads(blob[len(_MAGIC) + 4:body_at])
    except ValueError:
        header = None
    payload = blob[body_at:]
    if not verify:
        return payload
    if not isinstance(header, dict):
        raise AttestationError(
            f"collective {name!r}: pid {pid} published an unparseable attestation header "
            "(corrupt in transit)", pid=pid, code="header_corrupt")
    if int(header.get("p", -1)) != int(pid):
        raise AttestationError(
            f"collective {name!r}: payload read from pid {pid}'s slot claims pid "
            f"{header.get('p')}", pid=pid, code="identity_mismatch")
    if header.get("n") != name:
        raise AttestationError(
            f"collective {name!r}: pid {pid} republished a stale payload sealed for "
            f"{header.get('n')!r} (stuck/replayed round)", pid=pid, code="stale_replay")
    if _digest(payload) != header.get("d"):
        raise AttestationError(
            f"collective {name!r}: pid {pid}'s payload fails its content digest -- "
            "corrupted after sealing", pid=pid, code="digest_mismatch")
    return payload


def bounds_violation(arrays) -> bool:
    """True when any *finite* element's magnitude exceeds
    :func:`max_abs_bound`.  Non-finite values pass (the store mode
    exchanges them on purpose; the non-finite lane owns them)."""
    bound = max_abs_bound()
    for a in arrays:
        a = np.asarray(a)
        if a.size == 0 or not np.issubdtype(a.dtype, np.number):
            continue
        finite = np.isfinite(a)
        if finite.any() and float(np.abs(np.where(finite, a, 0.0)).max()) > bound:
            return True
    return False


# --- deterministic sampling: every rank takes the same branch ---------------


def should_spot_check(round_index: int, p: Optional[float] = None) -> bool:
    """Whether objective round ``round_index`` is audited: a pure hash."""
    p = spot_check_p() if p is None else p
    return p > 0.0 and _hash01(f"dup/{round_index}") < p


def spot_check_target(round_index: int, num_processes: int) -> int:
    """The rank whose work round ``round_index``'s spot check audits."""
    h = hashlib.sha256(f"dup-target/{round_index}".encode()).digest()
    return int.from_bytes(h[:8], "big") % max(1, int(num_processes))


#: (rung, relative bar): a comparison passes at the first rung whose bar it
#: meets, and meeting none is a disagreement.  The honest case is
#: ``exact``: claim and recompute run the same program on the same bytes.
TOLERANCE_LADDER = (("exact", 1e-12), ("tight", 1e-9), ("loose", 1e-5))


def ladder_rung(a, b) -> Optional[str]:
    """The first :data:`TOLERANCE_LADDER` rung ``a`` and ``b`` agree at, or
    None for a disagreement.  Matching non-finite patterns agree at
    ``exact``."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return None
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb):
        return None
    if not fa.all():
        na, nb = a[~fa], b[~fb]
        if not np.array_equal(np.isnan(na), np.isnan(nb)):
            return None
        if not (np.isnan(na) | (na == nb)).all():
            return None
    if fa.any():
        scale = max(float(np.abs(a[fa]).max()), float(np.abs(b[fb]).max()), 1e-30)
        rel = float(np.abs(a[fa] - b[fb]).max()) / scale
    else:
        rel = 0.0
    for rung, bar in TOLERANCE_LADDER:
        if rel <= bar:
            return rung
    return None


# --- the trust ledger: trusted -> suspect -> quarantined --------------------

TRUSTED = "trusted"
SUSPECT = "suspect"
QUARANTINED = "quarantined"


class TrustLedger:
    """trusted -> suspect -> quarantined escalation a rank.  A *definitive*
    disagreement (failed digest, magnitude bar, a claim every recompute
    contradicts) quarantines at once; non-definitive ones accumulate
    strikes and quarantine at :func:`quarantine_after`; a clean observation
    repays one strike.  Callbacks fire OUTSIDE the lock."""

    def __init__(self, quarantine_after_strikes: Optional[int] = None,
                 on_suspect: Optional[Callable[[object, str], None]] = None,
                 on_quarantined: Optional[Callable[[object, str], None]] = None):
        self._threshold = quarantine_after_strikes
        self._on_suspect = on_suspect
        self._on_quarantined = on_quarantined
        self._lock = threading.Lock()
        self._strikes: Dict[object, int] = {}
        self._state: Dict[object, str] = {}

    def _bar(self) -> int:
        return quarantine_after() if self._threshold is None else max(1, int(self._threshold))

    def record_disagreement(self, ident, definitive: bool = False, reason: str = "") -> str:
        """Register evidence against ``ident``; returns the new state."""
        fire = []
        with self._lock:
            if self._state.get(ident) == QUARANTINED:
                return QUARANTINED
            strikes = self._strikes.get(ident, 0) + 1
            self._strikes[ident] = strikes
            state = QUARANTINED if definitive or strikes >= self._bar() else SUSPECT
            prev = self._state.get(ident, TRUSTED)
            self._state[ident] = state
            if state == SUSPECT and prev != SUSPECT and self._on_suspect:
                fire.append((self._on_suspect, ident, reason))
            if state == QUARANTINED and self._on_quarantined:
                fire.append((self._on_quarantined, ident, reason))
        for cb, ident_, reason_ in fire:
            cb(ident_, reason_)
        return state

    def record_clean(self, ident) -> str:
        """One agreeing observation repays one strike (a quarantine stays
        until :meth:`forget`)."""
        with self._lock:
            if self._state.get(ident) == QUARANTINED:
                return QUARANTINED
            strikes = max(0, self._strikes.get(ident, 0) - 1)
            self._strikes[ident] = strikes
            state = TRUSTED if strikes == 0 else SUSPECT
            self._state[ident] = state
            return state

    def state(self, ident) -> str:
        with self._lock:
            return self._state.get(ident, TRUSTED)

    def strikes(self, ident) -> int:
        with self._lock:
            return self._strikes.get(ident, 0)

    def suspects(self) -> List[object]:
        with self._lock:
            return sorted(i for i, s in self._state.items() if s == SUSPECT)

    def quarantined(self) -> List[object]:
        with self._lock:
            return sorted(i for i, s in self._state.items() if s == QUARANTINED)

    def forget(self, ident) -> None:
        """Drop an identity (a replaced rank re-enters trusted)."""
        with self._lock:
            self._strikes.pop(ident, None)
            self._state.pop(ident, None)

    def snapshot(self) -> dict:
        with self._lock:
            return {"strikes": dict(self._strikes),
                    "suspects": sorted(i for i, s in self._state.items() if s == SUSPECT),
                    "quarantined": sorted(i for i, s in self._state.items()
                                          if s == QUARANTINED)}


def _emit(kind: str, **fields) -> None:
    """Counter, span event and flight record of one verdict; never raises
    (the trust plane must not replace the corruption it names with an
    observability failure)."""
    try:
        from spark_gp_tpu_torch.obs import trace as obs_trace
        from spark_gp_tpu_torch.obs.recorder import RECORDER
        from spark_gp_tpu_torch.obs.runtime import telemetry

        telemetry.inc(f"integrity.{kind}")  # metric-name-ok (integrity.* verdicts)
        obs_trace.add_event(f"integrity.{kind}", **fields)  # metric-name-ok
        RECORDER.record(f"integrity.{kind}", **fields)  # metric-name-ok
    except Exception:  # noqa: BLE001 -- see docstring
        pass


def make_trust_ledger() -> TrustLedger:
    """The fit's ledger: its transitions stamp ``integrity.*`` counters,
    span events and the flight recorder."""
    return TrustLedger(
        on_suspect=lambda ident, reason: _emit("host_suspect", pid=ident, reason=reason),
        on_quarantined=lambda ident, reason: _emit("host_quarantined", pid=ident,
                                                   reason=reason))


# --- duplicate-dispatch spot checks (store-mode fits) -----------------------


@dataclass(frozen=True)
class DupCheckSpec:
    """What a spot check audits: the kernel and objective the claim is
    computed under, and this rank's expert stack (tensors on its device,
    in its dtype) whose blocks a target republishes."""

    kernel: object
    objective: str
    x: object     # [E, s, p]
    y: object     # [E, s]
    mask: object  # [E, s]


def stage_spot_check(ctx, kernel, data, objective: str) -> None:
    """Arm spot checks on a store-mode context for the fit about to run.
    Only the stateless marginal objective is auditable (the claim must be
    a pure function of the published block); latent objectives keep the
    attestation and magnitude checks alone."""
    spec = None
    if (enabled() and spot_check_p() > 0.0 and objective == "marginal"
            and getattr(ctx, "num_processes", 1) >= 2):
        spec = DupCheckSpec(kernel=kernel, objective=objective, x=data.x, y=data.y,
                            mask=data.mask)
    ctx.dup_check = spec


def expert_claim(kernel, theta, x_e, y_e, mask_e, objective, like=None) -> np.ndarray:
    """``[nll, |grad|_1]`` (float64) of ONE expert block: the probe the
    target and every verifier run (``quarantine.expert_health`` on a
    one-expert stack, on ``like``'s device in its dtype -- one K1 launch
    on a ``[1, s, s]`` stack on the card's exact lane)."""
    import torch

    from spark_gp_tpu_torch.parallel.experts import ExpertData
    from spark_gp_tpu_torch.resilience.quarantine import expert_health

    dtype = like.dtype if like is not None else torch.float64
    device = like.device if like is not None else torch.device("cpu")

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)[None]

    data = ExpertData(x=put(x_e), y=put(y_e), mask=put(mask_e))
    nll, gnorm = expert_health(kernel, theta, data, objective)
    return np.asarray([float(nll[0]), float(gnorm[0])], dtype=np.float64)


_SKIP = np.zeros(0, dtype=np.float64)  # a non-target's gather marker


def run_spot_check(ctx, theta, round_index: int) -> Optional[str]:
    """One duplicate-dispatch audit round, in lockstep on every rank; the
    rung the claim met, or None when the round had nothing to audit.

    Two gathers, so the payloads ride the attested channel: ``dupc`` -- the
    target (:func:`spot_check_target`) republishes one expert block and
    its claim, every other rank an empty marker; ``dupv`` -- every rank
    recomputes the claim from the *published* block and publishes its
    recompute.  The verdicts are pure functions of published values, so
    they are the same on every rank: a claim that disagrees with the
    recompute is definitive against the target; a verifier's recompute
    that disagrees earns it a strike.  Raises
    :class:`HostQuarantinedError` when the ledger quarantines."""
    spec = getattr(ctx, "dup_check", None)
    if spec is None:
        return None
    target = spot_check_target(round_index, ctx.num_processes)
    theta = np.asarray(theta, dtype=np.float64)
    if ctx.process_id == target:
        active = np.flatnonzero(spec.mask.sum(dim=1).cpu().numpy() > 0)
        if active.size == 0:
            payload = [_SKIP]
        else:
            e = int(active[round_index % active.size])
            x_e, y_e, m_e = (t[e].detach().cpu().numpy() for t in (spec.x, spec.y, spec.mask))
            claim = expert_claim(spec.kernel, theta, x_e, y_e, m_e, spec.objective, spec.x)
            payload = [x_e, y_e, m_e, claim]
    else:
        payload = [_SKIP]
    parts = ctx.allgather_arrays("dupc", *payload)
    published = parts[target]
    if len(published) != 4:
        return None  # nothing auditable: every rank skips the round together
    x_e, y_e, mask_e, claim = published
    local = expert_claim(spec.kernel, theta, x_e, y_e, mask_e, spec.objective, spec.x)
    votes = ctx.allgather_arrays("dupv", local)
    rung = ladder_rung(claim, local)
    _emit("spot_checks", round=round_index, target=target, rung=rung or "disagree")
    ledger = getattr(ctx, "trust", None)
    if ledger is None:
        ledger = ctx.trust = make_trust_ledger()
    if rung is None:
        _emit("spot_check_disagreements", pid=target, via="claim", round=round_index)
        ledger.record_disagreement(target, definitive=True, reason="spot_check_claim")
        raise HostQuarantinedError(
            f"duplicate-dispatch spot check (round {round_index}): pid {target}'s claimed "
            "(NLL, |grad|) for its republished expert block disagrees with every recompute "
            "of the same bytes -- host quarantined; resume elastically without it",
            pid=target, code="spot_check_claim")
    ledger.record_clean(target)
    for pid in range(ctx.num_processes):
        if pid == target:
            continue
        vote = votes[pid][0] if votes[pid] else _SKIP
        if ladder_rung(vote, local) is None:
            _emit("spot_check_disagreements", pid=pid, via="verifier", round=round_index)
            if ledger.record_disagreement(pid, reason="spot_check_verifier") == QUARANTINED:
                raise HostQuarantinedError(
                    f"duplicate-dispatch spot checks: pid {pid}'s recomputed probe values "
                    "repeatedly disagree with every other host's -- host quarantined; resume "
                    "elastically without it", pid=pid, code="spot_check_verifier")
        else:
            ledger.record_clean(pid)
    return rung

SIDECAR_SUFFIX = ".sha256"

#: the ``code`` a ``CheckpointCorruptError`` carries for a failed model
#: sidecar (the serve wire catalog, ``serve/codes.py``)
ARTIFACT_DIGEST_CODE = "model_sidecar_digest_mismatch"


def file_digest(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def write_sidecar(path: str) -> str:
    """Stamp ``<path>.sha256`` next to a written artifact; returns the hex
    digest."""
    hexd = file_digest(path)
    with open(path + SIDECAR_SUFFIX, "w") as fh:
        fh.write(hexd + "\n")
    return hexd


def verify_sidecar(path: str) -> Optional[bool]:
    """Check an artifact against its sidecar: ``None`` when there is no
    sidecar (nothing to verify against), ``True`` when it matches; raises
    ``CheckpointCorruptError`` (``code`` = :data:`ARTIFACT_DIGEST_CODE`)
    when it does not."""
    sidecar = path + SIDECAR_SUFFIX
    if not os.path.exists(sidecar):
        return None
    with open(sidecar) as fh:
        expected = fh.read().strip()
    actual = file_digest(path)
    from spark_gp_tpu_torch.obs import trace as obs_trace
    from spark_gp_tpu_torch.obs.runtime import telemetry

    if actual != expected:
        from spark_gp_tpu_torch.utils.checkpoint import CheckpointCorruptError

        telemetry.inc("integrity.artifact_corrupt")
        obs_trace.add_event("integrity.artifact_corrupt", path=path)
        err = CheckpointCorruptError(
            f"{path} fails its content checksum (sidecar {expected[:12]}..., "
            f"file {actual[:12]}...): the model artifact was corrupted after it "
            f"was written; refusing to load it [code={ARTIFACT_DIGEST_CODE}]"
        )
        err.code = ARTIFACT_DIGEST_CODE
        raise err
    telemetry.inc("integrity.artifact_verified")
    obs_trace.add_event("integrity.artifact_verified", path=path)
    return True
