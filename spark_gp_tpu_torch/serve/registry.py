"""Model registry: named, versioned, hot-swappable servable models (the
port's copy of the JAX package's ``serve/registry.py``).

Loads ``.npz`` models of either package through
:mod:`spark_gp_tpu_torch.utils.serialization` onto the registry's device,
wraps each in a warmed
:class:`~spark_gp_tpu_torch.serve.batcher.BucketedPredictor` (every
bucket's CUDA graph captured before the version serves), and keys the
result by ``name`` and integer ``version``.  ``reload`` builds and warms
the new version completely before the latest pointer moves: in-flight
requests keep scoring against the old graphs.  Versions past
``max_versions`` are trimmed, and their graphs and pool released.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_gp_tpu_torch.serve.batcher import BucketedPredictor
from spark_gp_tpu_torch.serve.metrics import ServingMetrics


class ServableModel:
    """One immutable registry entry: a loaded model + its warm predictor."""

    def __init__(
        self,
        name: str,
        version: int,
        path: str,
        model,
        predictor: BucketedPredictor,
        kind: str,
    ):
        self.name = name
        self.version = int(version)
        self.path = path
        self.model = model
        self.predictor = predictor
        self.kind = kind
        self.loaded_at = time.time()
        # the aggregation plane's per-version binding (models/
        # aggregation.py): the policy the model was FITTED under rides
        # its provenance_json, and every predict through this entry is
        # scoped to it — a process-wide policy switch (or two co-served
        # versions fitted under different policies) can never silently
        # change a published version's aggregation semantics
        prov = getattr(model, "provenance", None)
        agg = prov.get("aggregation", {}) if isinstance(prov, dict) else {}
        self.agg_policy = self._validated_policy(agg.get("agg.policy"))
        self.effective_experts = agg.get("agg.effective_experts")

    @staticmethod
    def _validated_policy(policy):
        if policy is None:
            return None
        from spark_gp_tpu_torch.models.aggregation import AGG_POLICIES

        return policy if policy in AGG_POLICIES else None

    def predict(self, x: np.ndarray):
        """``(mean [t], var [t] | None)`` through the bucketed path,
        under this version's bound aggregation policy (when it carries
        one)."""
        if self.agg_policy is None:
            return self.predictor.predict(x)
        from spark_gp_tpu_torch.models.aggregation import agg_policy_scope

        with agg_policy_scope(self.agg_policy):
            return self.predictor.predict(x)

    def describe(self) -> dict:
        return {
            "name": self.name,
            "version": self.version,
            "path": self.path,
            "kind": self.kind,
            "n_features": self.predictor.n_features,
            "buckets": list(self.predictor.buckets),
            "mean_only": self.predictor.mean_only,
            "compiles": dict(self.predictor.compile_counts),
            "agg_policy": self.agg_policy,
            "effective_experts": self.effective_experts,
        }


class ModelRegistry:
    """name -> {version -> ServableModel}, with a latest-version pointer.

    ``warmup=True`` (default) builds every (model, bucket) pair at load
    (a CUDA graph capture on the card), inside a metrics phase, so the
    server's ready signal means "no build happens on the hot path".
    """

    def __init__(
        self,
        max_batch: int = 256,
        min_bucket: int = 8,
        buckets: Optional[Sequence[int]] = None,
        mean_only: bool = False,
        metrics: Optional[ServingMetrics] = None,
        max_versions: int = 2,
        device=None,
    ):
        if max_versions < 1:
            raise ValueError("max_versions must be >= 1")
        from spark_gp_tpu_torch.utils.device import resolve_device

        #: where every model is loaded and served (``None`` means ``cuda``)
        self.device = resolve_device(device)
        self._max_batch = max_batch
        self._min_bucket = min_bucket
        self._buckets = tuple(buckets) if buckets is not None else None
        self._mean_only = mean_only
        # versions retained per name: each entry pins host arrays, device
        # buffers AND a ladder of warm graphs, so unbounded
        # retention would leak a full warmed model per reload.  The
        # default keeps latest + one predecessor (in-flight requests
        # pinned at the previous latest survive a single hot swap); raise
        # it when clients pin explicit versions across longer windows.
        self._max_versions = max_versions
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._lock = threading.Lock()
        self._models: Dict[str, Dict[int, ServableModel]] = {}
        self._latest: Dict[str, int] = {}
        # highest version ever ALLOCATED per name (>= latest): auto
        # versions are reserved here under the lock BEFORE the slow
        # build, so two concurrent register/reload calls can never be
        # handed the same number and silently overwrite each other
        self._allocated: Dict[str, int] = {}

    def _build(self, name: str, version: int, path: str, warmup: bool) -> ServableModel:
        from spark_gp_tpu_torch.utils.serialization import load_model

        with self.metrics.phase(f"load.{name}"):
            model = load_model(path, device=self.device)
        kind = type(model).__name__
        predictor = BucketedPredictor(
            model.raw_predictor,
            max_batch=self._max_batch,
            min_bucket=self._min_bucket,
            buckets=self._buckets,
            mean_only=self._mean_only,
        )
        if warmup:
            with self.metrics.phase(f"warmup.{name}"):
                counts = predictor.warmup()
            self.metrics.inc("compiles", sum(counts.values()))
        return ServableModel(name, version, path, model, predictor, kind)

    def register(
        self,
        name: str,
        path: str,
        version: Optional[int] = None,
        warmup: bool = True,
        make_latest: bool = True,
    ) -> ServableModel:
        """Load ``path`` and publish it as ``name`` at ``version``
        (default: one past the current latest; 1 for a new name).  The
        entry is fully built (loaded, captured, warmed) before it
        becomes visible.

        ``make_latest=False`` publishes the version addressable-but-not-
        default (the canary shape, ``serve/lifecycle.py``): default
        traffic keeps resolving the incumbent until an explicit
        :meth:`promote` moves the pointer — and retention is NOT trimmed,
        so a pending candidate can never evict the incumbent it is being
        judged against."""
        with self._lock:
            if version is None:
                version = self._allocated.get(name, 0) + 1
            elif version in self._models.get(name, {}):
                raise ValueError(
                    f"model {name!r} version {version} is already registered"
                )
            self._allocated[name] = max(self._allocated.get(name, 0), version)
        entry = self._build(name, version, path, warmup)
        with self._lock:
            versions = self._models.setdefault(name, {})
            if entry.version in versions:
                # two explicit-version registrations raced past the check
                # above: refuse rather than replace a published entry
                raise ValueError(
                    f"model {name!r} version {entry.version} was registered "
                    "concurrently"
                )
            versions[entry.version] = entry
            if name not in self._latest or (
                make_latest and entry.version >= self._latest[name]
            ):
                self._latest[name] = entry.version
            evicted = (
                self._trim_locked(name, keep=entry.version)
                if make_latest else []
            )
        self._release_evicted(evicted)
        self.metrics.inc("models_loaded")
        return entry

    def _trim_locked(self, name: str, keep: int) -> List[ServableModel]:
        """Drop the oldest versions past ``max_versions`` (caller holds
        the lock).  Never trims ``keep`` (the entry the caller just
        published or promoted) or the latest pointer's target; returns
        the evicted entries for the caller to release OUTSIDE the lock."""
        versions = self._models.get(name, {})
        evicted: List[ServableModel] = []
        for old in sorted(versions)[: -self._max_versions]:
            if old != keep and old != self._latest.get(name):
                evicted.append(versions.pop(old))
        return evicted

    def _release_evicted(self, entries: List[ServableModel]) -> None:
        """Account + actually unload evicted entries: each one pins host
        arrays, device buffers AND a ladder of warm graphs —
        eviction that only drops the dict slot would leak a full warmed
        model per reload until GC happened to notice."""
        for entry in entries:
            self.metrics.inc("registry.evictions")
            release = getattr(entry.predictor, "release", None)
            if release is not None:
                release()

    def retire(self, name: str, version: int) -> bool:
        """Remove ONE version (rolled-back canary, manual unload) and free
        its bucket graphs.  Retiring the latest repoints the
        default to the newest survivor; retiring the only version removes
        the name.  Returns False when the version was not registered."""
        version = int(version)
        with self._lock:
            versions = self._models.get(name)
            entry = versions.pop(version, None) if versions else None
            if entry is None:
                return False
            if not versions:
                del self._models[name]
                self._latest.pop(name, None)
            elif self._latest.get(name) == version:
                self._latest[name] = max(versions)
        self._release_evicted([entry])
        return True

    def promote(self, name: str, version: int) -> ServableModel:
        """Move the latest pointer to an already-registered version (the
        canary's clean-promotion step) and trim retention — the retired
        predecessors beyond ``max_versions`` are evicted and released."""
        version = int(version)
        with self._lock:
            versions = self._models.get(name, {})
            entry = versions.get(version)
            if entry is None:
                raise KeyError(
                    f"model {name!r} has no version {version} to promote; "
                    f"available: {sorted(versions)}"
                )
            self._latest[name] = version
            evicted = self._trim_locked(name, keep=version)
        self._release_evicted(evicted)
        return entry

    def reload(self, name: str, path: Optional[str] = None) -> ServableModel:
        """Hot-swap: re-load ``name`` (from its current path unless a new
        one is given) as the next version and move the latest pointer.
        Prior versions stay addressable for pinned clients."""
        with self._lock:
            current = self._latest.get(name)
            if current is None:
                raise KeyError(f"no model named {name!r} to reload")
            source = path or self._models[name][current].path
        entry = self.register(name, source, warmup=True)
        self.metrics.inc("models_reloaded")
        return entry

    def get(self, name: str, version: Optional[int] = None) -> ServableModel:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise KeyError(
                    f"no model named {name!r}; registered: {sorted(self._models)}"
                )
            v = self._latest[name] if version is None else int(version)
            entry = versions.get(v)
            if entry is None:
                raise KeyError(
                    f"model {name!r} has no version {v}; available: "
                    f"{sorted(versions)}"
                )
            return entry

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def describe(self) -> List[dict]:
        with self._lock:
            entries = [
                (self._latest[name], versions)
                for name, versions in self._models.items()
            ]
            return [
                {**entry.describe(), "latest": entry.version == latest}
                for latest, versions in entries
                for entry in versions.values()
            ]

    def resolve(self, key: Tuple[str, Optional[int]]) -> ServableModel:
        """(name, version|None) -> entry; the queue's model_key form."""
        return self.get(key[0], key[1])
