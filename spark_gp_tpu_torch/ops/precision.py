"""Precision lanes of the port: ``strict``, ``mixed`` and ``fast``.

The JAX package's lanes (its ``ops/precision.py``) split the work into two
stages:

* the *gram* stage -- the cancellation-sensitive pairwise contractions of
  ``ops/distance.py`` (every kernel family's gram and cross, the gram
  cache build);
* the *linalg* stage -- K1's panel products, the SPD VJP and the k-means
  one-hot sums.

========  ==============================  ================================
lane      gram stage (``gram_mode``)      JAX package's linalg stage
========  ==============================  ================================
strict    ``highest``: IEEE float32       ``highest``
mixed     ``compensated``: 3xTF32         ``high``
fast      ``default``: 1-pass TF32        ``high``
========  ==============================  ================================

On the card the gram stage of a non-strict lane is the hand-written
tensor-core kernel ``csrc/lane_gram.cu`` (``ops/lane_gram.py``): the lane
is an argument of its launch, so a lane can be scoped to one thread (a
fit, a serve batcher that pins its own lane, a captured CUDA graph whose
lane must not change under it).  ``compensated`` splits each operand into
TF32 ``hi`` and ``lo`` parts and sums ``hi1 hi2 + hi1 lo2 + lo1 hi2``
(dropping only ``lo1 lo2``, as the JAX package's split-bf16 path drops
its ``lo1 lo2``); ``default`` and ``high`` are one TF32 pass.  float64
operands always take the strict IEEE path, so the float64 PPA statistics,
magic solve and predict are lane-immune on every lane.

The linalg stage has no lower-precision form on the card: K1
(``csrc/spd_inv_logdet.cu``) is IEEE float32 FMA without tensor cores,
and the SPD VJP and K2 are float32 too, which is at least as accurate as
the JAX package's ``high`` (bf16x3, ~1e-6 relative).  So the port's
policy has no linalg stage: every lane runs it at ``highest``, and a
``GP_MATMUL_PRECISION`` pin of ``high`` or ``default`` is refused rather
than accepted to no effect.  A K1 with its panels on 3xTF32 tensor cores
is held for the speed queues (ROADMAP.md).

The only process-wide precision state PyTorch has, ``allow_tf32``, is set
False here at import (:func:`use_strict_lane`) and written nowhere else
(:func:`tf32_library_matmuls` lifts it inside one block, to time the
library's TF32 matmul beside the kernel): every library matmul of a fit,
predict or serve path stays IEEE float32, and the lanes act only through
the kernel.

Resolution (:func:`active_lane`): the innermost thread-local
:func:`precision_lane_scope`, else :func:`set_precision_lane`'s process
override, else ``GP_PRECISION_LANE``, else ``strict``.
``GP_PRECISION_GRAM`` pins the gram stage (:func:`get_policy`).  A fit at a non-strict lane checks itself against
the strict lane at fit time (``models/common._emit_precision_guard``,
:data:`GUARD_BARS`, :func:`guard_action`).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import NamedTuple, Optional

import torch


def use_strict_lane() -> None:
    """Turn TF32 off for library matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


use_strict_lane()


class PrecisionPolicy(NamedTuple):
    """Resolved per-stage precision of one lane (module doc)."""

    lane: str    # "strict" | "mixed" | "fast"
    gram: str    # "highest" | "compensated" | "high" | "default"


class CardPeaks(NamedTuple):
    """Peak rates of one NVIDIA card (NVIDIA's data sheets): memory
    bytes/s; float32, float64 and dense TF32 tensor-core flop/s; and
    special-function results/s (16 a clock a streaming multiprocessor,
    CUDA C++ Programming Guide, compute capability 9.0, times the SM
    count and the boost clock).  ``tf32`` is None where the table has no
    figure."""

    key: str
    bytes_per_s: float
    f32: float
    sfu: float
    f64: float
    tf32: Optional[float]


#: peak rates by a substring of ``torch.cuda.get_device_name()``, the
#: first match winning (so ``H100 PCIe`` and ``H100 NVL`` before ``H100``)
CARD_PEAKS = {
    "H100 PCIe": CardPeaks("H100 PCIe", 2.0e12, 51e12, 114 * 16 * 1.755e9, 25.6e12, 378e12),
    "H100 NVL": CardPeaks("H100 NVL", 3.9e12, 60e12, 132 * 16 * 1.785e9, 30e12, None),
    "H100": CardPeaks("H100", 3.35e12, 67e12, 132 * 16 * 1.98e9, 34e12, 495e12),
    "H200": CardPeaks("H200", 4.8e12, 67e12, 132 * 16 * 1.98e9, 34e12, 495e12),
}


def chip_peaks(device_name: Optional[str]) -> Optional[CardPeaks]:
    """The :data:`CARD_PEAKS` row of a card name (the JAX package's
    ``chip_peaks`` for NVIDIA cards), or None for an unknown name, the
    CPU, or no name."""
    if not device_name:
        return None
    return next((row for key, row in CARD_PEAKS.items() if key in device_name), None)


#: the three named lanes; ``GP_PRECISION_GRAM`` refines them
LANES = {
    "strict": PrecisionPolicy("strict", gram="highest"),
    "mixed": PrecisionPolicy("mixed", gram="compensated"),
    "fast": PrecisionPolicy("fast", gram="default"),
}

#: what a fit-time guard breach does: ``log`` (the default) warns and
#: stamps ``mixed_precision_guard.breach`` 1, the fit keeping its lane;
#: ``degrade`` raises into the degradation ladder, whose ``strict_lane``
#: rung re-runs the fit on the strict lane (``resilience/fallback.py``)
GUARD_ACTIONS = ("log", "degrade")

#: the guard's bars: relative deltas against the strict lane on the
#: probe expert (``models/common._emit_precision_guard``).  The JAX
#: package's calibration: the NLL and gradient legs amplify the gram's
#: error by the experts' conditioning (~1e3 at sigma2 ~ 1e-3), so a healthy
#: compensated fit reads ~1e-4 .. 2e-3; the fast lane's bar is looser
GUARD_BARS = {"mixed": 1e-2, "fast": 0.5}

_GRAM_MODES = ("compensated", "default", "high", "highest")
_LINALG_MODES = ("default", "high", "highest")

#: the process-wide lane override (set_precision_lane); None: env/default
_LANE_OVERRIDE = None
#: the thread-local lane scope (precision_lane_scope)
_SCOPE = threading.local()


def guard_action() -> str:
    """``GP_GUARD_ACTION`` validated against :data:`GUARD_ACTIONS`;
    ``log`` when unset."""
    raw = os.environ.get("GP_GUARD_ACTION", "").strip().lower()
    if not raw:
        return "log"
    if raw not in GUARD_ACTIONS:
        raise ValueError(
            f"GP_GUARD_ACTION={raw!r} is not supported; use one of "
            f"{sorted(GUARD_ACTIONS)}"
        )
    return raw


def _validate_lane(lane, source: str) -> str:
    lane = str(lane).strip().lower()
    if lane not in LANES:
        raise ValueError(
            f"{source}={lane!r} is not a precision lane; use one of "
            f"{sorted(LANES)}"
        )
    return lane


def active_lane() -> str:
    """The lane in effect on this thread: the innermost
    :func:`precision_lane_scope`, else the :func:`set_precision_lane`
    override, else ``GP_PRECISION_LANE``, else ``strict``."""
    scoped = getattr(_SCOPE, "lane", None)
    if scoped is not None:
        return scoped
    if _LANE_OVERRIDE is not None:
        return _LANE_OVERRIDE
    env = os.environ.get("GP_PRECISION_LANE")
    if env is None or not env.strip():
        return "strict"
    return _validate_lane(env, "GP_PRECISION_LANE")


def set_precision_lane(lane):
    """Process-wide lane setter (the programmatic twin of
    ``GP_PRECISION_LANE``); ``None`` clears it.  Returns the previous
    override, so a caller can restore it."""
    global _LANE_OVERRIDE
    previous = _LANE_OVERRIDE
    _LANE_OVERRIDE = None if lane is None else _validate_lane(lane, "set_precision_lane")
    return previous


@contextlib.contextmanager
def precision_lane_scope(lane):
    """Pin the lane for this thread inside the block (it outranks the
    process setting); ``None`` is a no-op."""
    if lane is None:
        yield
        return
    lane = _validate_lane(lane, "precision_lane_scope")
    prev = getattr(_SCOPE, "lane", None)
    _SCOPE.lane = lane
    try:
        yield
    finally:
        _SCOPE.lane = prev


def get_policy() -> PrecisionPolicy:
    """The active lane's gram stage, ``GP_PRECISION_GRAM`` pinning it (an
    explicit pin wins over the lane).  ``GP_MATMUL_PRECISION`` is validated
    as the JAX package validates it; only ``highest`` is accepted, the
    one linalg precision the port has (module doc)."""
    policy = LANES[active_lane()]
    gram = os.environ.get("GP_PRECISION_GRAM", "").strip().lower()
    if gram:
        if gram not in _GRAM_MODES:
            raise ValueError(
                f"GP_PRECISION_GRAM={gram!r} is not supported; use one of "
                f"{list(_GRAM_MODES)}"
            )
        policy = policy._replace(gram=gram)
    linalg = os.environ.get("GP_MATMUL_PRECISION", "").strip().lower()
    if linalg:
        if linalg not in _LINALG_MODES:
            raise ValueError(
                f"GP_MATMUL_PRECISION={linalg!r} is not supported; use one "
                f"of {list(_LINALG_MODES)}"
            )
        if linalg != "highest":
            raise ValueError(
                f"GP_MATMUL_PRECISION={linalg!r} has no effect on this port: its "
                "linear algebra (K1, the SPD VJP, K2) runs IEEE float32 on every "
                "lane; unset it or set 'highest'"
            )
    return policy


def gram_mode() -> str:
    """The gram stage's mode for ``ops/distance.py``: ``highest`` runs the
    IEEE contraction, ``compensated`` the kernel's 3xTF32 mode, ``high``
    and ``default`` its 1-pass TF32 mode."""
    return get_policy().gram


@contextlib.contextmanager
def tf32_library_matmuls():
    """Library matmuls on TF32 inside the block, IEEE again after it: the
    library's own TF32 contraction, for timing the lane kernel against
    (``chip_smoke.py``).  No fit, predict or serve path enters it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
