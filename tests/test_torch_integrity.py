"""The attested collectives and spot checks of the port's integrity plane
(``resilience/integrity.py``) against the JAX package's
(``tests/test_integrity.py``).

The seal is the JAX package's byte for byte (each package unseals the
other's); the spot-check, target and panel decisions, the tolerance
ladder and the trust ledger's transitions are the JAX package's on the
same inputs.  Under the staged ``chaos.corrupt_host`` faults a two-rank
store-mode regression fit (logical ranks as threads over an
``InProcessCoordStore``) refuses each corruption and names its
publisher on both ranks: a bit flip by its digest, a stuck replay by its
round, a scaled compute by the magnitude bar, and -- audited by
duplicate dispatch at ``GP_INTEGRITY_DUPCHECK_P=1`` -- a scaled claim by
a quarantine.  ``GP_INTEGRITY=0`` leaves the fit bit-identical."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import threading

import numpy as np
import pytest
import torch

import spark_gp_tpu_torch as tgp
from spark_gp_tpu.resilience import integrity as jint
from spark_gp_tpu_torch.obs.runtime import telemetry
from spark_gp_tpu_torch.parallel import coord
from spark_gp_tpu_torch.parallel.coord import DcnContext, InProcessCoordClient, InProcessCoordStore
from spark_gp_tpu_torch.parallel.experts import group_for_experts
from spark_gp_tpu_torch.resilience import chaos, integrity
from spark_gp_tpu_torch.resilience.fallback import SDC, classify_failure


def _counter(key):
    return telemetry.snapshot()["counters"].get(key, 0.0)


# -- the seal, both packages ------------------------------------------------------


@pytest.mark.parametrize("name,pid,payload", [
    ("vag/3", 1, b"\x00\x01expert-bytes" * 7), ("ckpt/GaussianProcessRegression/e0/2", 0, b""),
    ("dims/0", 3, np.arange(2, dtype=np.int64).tobytes())])
def test_seal_is_the_jax_package_byte_for_byte(name, pid, payload):
    sealed = integrity.seal(name, pid, payload)
    assert sealed == jint.seal(name, pid, payload)
    assert sealed.startswith(b"GPIA1\n")
    assert jint.unseal(name, pid, sealed) == payload
    assert integrity.unseal(name, pid, jint.seal(name, pid, payload)) == payload
    # an unsealed blob passes through (a peer with GP_INTEGRITY=0)
    assert integrity.unseal(name, pid, payload) == payload


def test_unseal_attributes_every_failure_mode():
    sealed = integrity.seal("vag/3", 1, b"payload")
    flipped = bytearray(sealed)
    flipped[-1] ^= 1
    cases = [(bytes(flipped), "vag/3", 1, "digest_mismatch"), (sealed, "vag/3", 0, "identity_mismatch"),
             (sealed, "vag/4", 1, "stale_replay")]
    for blob, name, pid, code in cases:
        with pytest.raises(integrity.AttestationError) as err:
            integrity.unseal(name, pid, blob)
        with pytest.raises(jint.AttestationError) as j_err:
            jint.unseal(name, pid, blob)
        assert err.value.code == j_err.value.code == code and err.value.pid == pid
        assert classify_failure(err.value) == SDC


def test_bounds_violation_flags_finite_magnitudes_only():
    for arrays, want in ([[np.array([np.inf, np.nan, 1.0])], False],
                         [[np.array([1e17, -1e17])], False], [[np.array([1.0, -1e19])], True]):
        assert integrity.bounds_violation(arrays) is want is jint.bounds_violation(arrays)


def test_sampling_decisions_match_jax_for_1000_rounds():
    """Spot check, target and panel sample: pure hashes of the index, the
    JAX package's decisions for rounds 0-999 at several rates."""
    for p in (0.05, 0.25, 1.0):
        assert [integrity.should_spot_check(k, p) for k in range(1000)] == \
            [jint.should_spot_check(k, p) for k in range(1000)]
        assert [integrity.panel_checked(k, p) for k in range(1000)] == \
            [jint.panel_checked(k, p) for k in range(1000)]
    for n in (2, 3, 4):
        assert [integrity.spot_check_target(k, n) for k in range(1000)] == \
            [jint.spot_check_target(k, n) for k in range(1000)]
    assert {integrity.spot_check_target(k, 2) for k in range(64)} == {0, 1}
    assert 50 <= sum(integrity.should_spot_check(k, p=0.25) for k in range(400)) <= 150


def test_ladder_rung_matches_jax_on_a_table():
    a = np.array([1.0, -2.0, 3.5])
    nonf = np.array([np.inf, 1.0, np.nan])
    pairs = [(a, a.copy()), (a, a * (1.0 + 1e-12)), (a, a * (1.0 + 1.01e-12)),
             (a, a * (1.0 + 1e-10)), (a, a * (1.0 + 1e-9)), (a, a * (1.0 + 1.01e-9)),
             (a, a * (1.0 + 1e-7)), (a, a * (1.0 + 1e-5)), (a, a * (1.0 + 1.01e-5)),
             (a, a * 2.0), (nonf, nonf.copy()), (nonf, np.array([1.0, 1.0, np.nan])),
             (nonf, np.array([-np.inf, 1.0, np.nan])), (nonf, np.array([np.inf, 1.0, 0.0])),
             (np.array([np.nan]), np.array([np.nan])), (a, a[:2]), (np.zeros(2), np.zeros(2))]
    got = [integrity.ladder_rung(u, v) for u, v in pairs]
    assert got == [jint.ladder_rung(u, v) for u, v in pairs]
    assert [got[0], got[3], got[6], got[9], got[10], got[11]] == \
        ["exact", "tight", "loose", None, "exact", None]


def test_kill_switch_and_knobs(monkeypatch):
    monkeypatch.setenv("GP_INTEGRITY", "off")
    assert not integrity.enabled()
    monkeypatch.delenv("GP_INTEGRITY")
    assert integrity.enabled()
    assert (integrity.max_abs_bound(), integrity.spot_check_p(), integrity.quarantine_after()) \
        == (jint.max_abs_bound(), jint.spot_check_p(), jint.quarantine_after()) == (1e18, 0.05, 2)


def _ledger_run(pkg):
    events = []
    ledger = pkg.TrustLedger(
        quarantine_after_strikes=2,
        on_suspect=lambda i, r: events.append(("suspect", i, r)),
        on_quarantined=lambda i, r: events.append(("quarantined", i, r)))
    states = [ledger.state(7), ledger.record_disagreement(7, reason="verifier"),
              ledger.record_clean(7), ledger.record_disagreement(7), ledger.record_disagreement(7),
              ledger.record_clean(7), ledger.record_disagreement(9, definitive=True, reason="d")]
    snap = ledger.snapshot()
    ledger.forget(7)
    return states, events, snap, ledger.state(7)


def test_trust_ledger_transitions_match_jax():
    port = _ledger_run(integrity)
    assert port == _ledger_run(jint)
    states, events, snap, after = port
    assert states == ["trusted", "suspect", "trusted", "suspect", "quarantined", "quarantined",
                      "quarantined"]
    assert snap["quarantined"] == [7, 9] and after == "trusted"
    assert [kind for kind, _, _ in events].count("quarantined") == 2


# -- attested gathers under chaos (two logical ranks) --------------------------------


def _pair_ctxs(timeout_s=30.0):
    store = InProcessCoordStore()
    return [DcnContext(InProcessCoordClient(store, pid, 2), timeout_s=timeout_s)
            for pid in range(2)]


def _on_pair(ctxs, fn):
    results = {}

    def run(pid):
        try:
            results[pid] = fn(pid, ctxs[pid])
        except BaseException as exc:  # noqa: BLE001 -- collected for the asserts
            results[pid] = exc

    threads = [threading.Thread(target=run, args=(pid,)) for pid in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def test_clean_gathers_are_transparent_through_the_seal():
    out = _on_pair(_pair_ctxs(), lambda pid, ctx: ctx.allreduce_arrays("vag", np.full(3, pid + 1.0)))
    for pid in range(2):
        np.testing.assert_array_equal(out[pid][0], np.full(3, 3.0))


# -- the store-mode fit under each fault ------------------------------------------------


def _half_rows(pid):
    rng = np.random.default_rng(100 + pid)
    n = 144 if pid == 0 else 112
    x = rng.normal(size=(n, 2))
    return x, np.sin(x.sum(axis=1)) + 0.01 * rng.normal(size=n)


def _fit(pid, ctx, maxiter=50):
    x, y = _half_rows(pid)
    coord.set_dcn_context_for_testing(ctx)
    try:
        return (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0))
                .setActiveSetSize(48).setMaxIter(maxiter).setTol(1e-10).setSeed(3)
                .fit_distributed(group_for_experts(x, y, 16, dtype=torch.float64, device="cpu")))
    finally:
        coord.set_dcn_context_for_testing(None)


@pytest.mark.parametrize("kind,scale,code", [("bitflip", 1e3, "digest_mismatch"),
                                             ("stuck", 1e3, "stale_replay"),
                                             ("scale", 1e19, "bounds")])
def test_store_fit_refuses_each_corruption_naming_its_publisher(kind, scale, code):
    ctxs = _pair_ctxs()
    before = _counter("integrity.attestation_failures") + _counter("integrity.bounds_violations")
    with chaos.corrupt_host(1, kind, op="vag", scale=scale) as fired:
        out = _on_pair(ctxs, lambda pid, ctx: _fit(pid, ctx, maxiter=10))
    assert fired[0] >= 1
    for pid in range(2):
        exc = out[pid]
        assert isinstance(exc, integrity.AttestationError), exc
        assert exc.pid == 1 and exc.code == code
        assert classify_failure(exc) == SDC
        assert 1 in ctxs[pid].trust.quarantined()
    assert _counter("integrity.attestation_failures") \
        + _counter("integrity.bounds_violations") >= before + 2


def test_spot_checked_fit_quarantines_a_scaled_claim(monkeypatch):
    """Rank 1's compute silently scaled (consistent bytes, valid digests,
    inside the magnitude bar): with every round audited the claim of its
    republished block disagrees with every recompute, and both ranks stop
    with HostQuarantinedError naming it; a clean audited fit passes every
    audit at the exact rung."""
    monkeypatch.setenv("GP_INTEGRITY_DUPCHECK_P", "1.0")
    clean_ctxs = _pair_ctxs()
    clean = _on_pair(clean_ctxs, lambda pid, ctx: _fit(pid, ctx, maxiter=5))
    assert not isinstance(clean[0], BaseException), clean[0]
    assert clean_ctxs[0].audits and set(clean_ctxs[0].audits) == {"exact"}
    assert clean_ctxs[0].audits == clean_ctxs[1].audits
    before = _counter("integrity.host_quarantined")
    with chaos.corrupt_host(1, kind="scale", scale=32.0) as fired:
        out = _on_pair(_pair_ctxs(), lambda pid, ctx: _fit(pid, ctx))
    assert fired[0] >= 1
    for pid in range(2):
        assert isinstance(out[pid], integrity.HostQuarantinedError), out[pid]
        assert out[pid].pid == 1 and classify_failure(out[pid]) == SDC
    assert _counter("integrity.host_quarantined") >= before + 1


def test_integrity_off_fit_is_bit_identical(monkeypatch):
    on = _on_pair(_pair_ctxs(), lambda pid, ctx: _fit(pid, ctx, maxiter=20))
    monkeypatch.setenv("GP_INTEGRITY", "0")
    off = _on_pair(_pair_ctxs(), lambda pid, ctx: _fit(pid, ctx, maxiter=20))
    np.testing.assert_array_equal(on[0].raw_predictor.theta, off[0].raw_predictor.theta)
    probe = np.random.default_rng(5).normal(size=(16, 2))
    np.testing.assert_array_equal(on[0].predict(probe), off[0].predict(probe))
