"""Content digests of written artifacts (the sidecar half of the JAX
package's ``resilience/integrity.py``).

A saved model is stamped with ``<path>.sha256``, the hex sha256 of its
bytes; :func:`verify_sidecar` refuses a file whose bytes no longer match
with ``CheckpointCorruptError`` carrying ``code =``
:data:`ARTIFACT_DIGEST_CODE`, so a flipped bit fails at load time with
its sidecar named instead of deserializing into a wrong model.  The file
format is the JAX package's: either package verifies the other's
sidecars.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

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
