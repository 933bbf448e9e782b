"""The numerical integrity plane of the port (the JAX package's
``resilience/integrity.py``): content digests of written artifacts, and
the sharded Cholesky's panel tripwire.

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
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional


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
