"""Mixed-precision refinement across storage modes + solver checkpointing.

Round-4 depth items: (1) the at-scale accuracy-recovery path — an f32
floor stage followed by an f64 refinement stage — must work for EVERY
canonical storage mode (full / blocked / df, split residual included)
and land on the pure-f64 fixed point, because the reference delivers
double-precision energies on everything it can hold
(/root/reference/pycc/ccwfn.py:177-196, oracles at 1e-11 e.g.
pycc/tests/test_002_ccsd_energy.py:32-41); (2) kill-and-resume
checkpointing for solve_cc / solve_lambda / solve_eom (the reference
checkpoints RT propagation only, rt/rtcc.py:439-556 — the oracle
pattern here follows its test_016_chk.py restart-equality test).
"""

import contextlib
import io

import numpy as np
import pytest

import pycc_tpu
from .common import scf

E_CCSD_STO3G = -0.070616830152761   # frozen Psi4 (reference test_002)


def _quiet():
    return contextlib.redirect_stdout(io.StringIO())


# ---------------------------------------------------------------------------
# mixed-precision refinement, per storage mode
# ---------------------------------------------------------------------------

def test_mixed_full_matches_oracle():
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        e = pycc_tpu.ccwfn(wfn).solve_cc_mixed(1e-12, 1e-12)
    assert abs(e - E_CCSD_STO3G) < 1e-11


def test_mixed_blocked_matches_oracle():
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        e = pycc_tpu.ccwfn(wfn, storage="blocked").solve_cc_mixed(1e-12,
                                                                  1e-12)
    assert abs(e - E_CCSD_STO3G) < 1e-11


def test_mixed_df_matches_pure_f64():
    """storage='df': the f32-floor + f64-refine solve must land on the
    SAME fixed point as a pure-f64 solve of the identical factors (and,
    with tight df_tol, on the frozen dense oracle)."""
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        e64 = pycc_tpu.ccwfn(wfn, storage="df",
                             df_tol=1e-12).solve_cc(1e-12, 1e-12)
        emx = pycc_tpu.ccwfn(wfn, storage="df",
                             df_tol=1e-12).solve_cc_mixed(1e-12, 1e-12)
    assert abs(emx - e64) < 1e-11
    assert abs(emx - E_CCSD_STO3G) < 1e-9


def test_mixed_lambda_matches_pure_f64():
    """solve_lambda_mixed (f32 HBAR + Lambda floor, then f64 HBAR +
    refinement) lands on the pure-f64 Lambda pseudoenergy — incl. the
    exact-f64-t restoration (the t-amplitudes are a parameter of the
    Lambda equations; a round-tripped f32 cast would poison the f64
    stage at ~1e-7)."""
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        cc64 = pycc_tpu.ccwfn(wfn, storage="df", df_tol=1e-12)
        cc64.solve_cc(1e-12, 1e-12)
        hb64 = pycc_tpu.cchbar(cc64)
        lam64 = pycc_tpu.cclambda(cc64, hb64)
        le64 = lam64.solve_lambda(e_conv=1e-12, r_conv=1e-12)

        cc = pycc_tpu.ccwfn(wfn, storage="df", df_tol=1e-12)
        cc.solve_cc_mixed(1e-12, 1e-12)
        hb = pycc_tpu.cchbar(cc)
        lam = pycc_tpu.cclambda(cc, hb)
        lemx = lam.solve_lambda_mixed(1e-12, 1e-12)
    assert lam.converged
    assert abs(lemx - le64) < 1e-11, (lemx, le64)
    assert abs(lam.e_sp_floor - le64) < 1e-4  # the floor really was f32


def test_mixed_response_matches_pure_f64():
    """solve_right_mixed / solve_left_mixed (f32 HBAR + pertbar floor,
    then f64 rebuild + refinement warm-started from the floor vectors)
    land on the pure-f64 perturbed amplitudes and pseudoresponses.
    t1/t2 AND l1/l2 are parameters of the response equations — the
    orchestrator must restore the exact f64 copies for the refinement.
    The reference solves X/Y in f64 only
    (/root/reference/pycc/ccresponse.py:336-467)."""
    wfn = scf("H2O", "sto-3g")
    om = 0.0656
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn)
        cc.solve_cc(1e-12, 1e-12)
        lam = pycc_tpu.cclambda(cc, pycc_tpu.cchbar(cc))
        lam.solve_lambda(e_conv=1e-12, r_conv=1e-12)
        resp = pycc_tpu.ccresponse(pycc_tpu.ccdensity(cc, lam))
        X1, X2, px = resp.solve_right(resp.pertbar["MU_X"], om,
                                      e_conv=1e-12, r_conv=1e-12)
        Y1, Y2, py = resp.solve_left(resp.pertbar["MU_X"], om,
                                     e_conv=1e-12, r_conv=1e-12)
        X1m, X2m, pxm = resp.solve_right_mixed("MU_X", om, e_conv=1e-12,
                                               r_conv=1e-12, sp_conv=1e-5)
        Y1m, Y2m, pym = resp.solve_left_mixed("MU_X", om, e_conv=1e-12,
                                              r_conv=1e-12, sp_conv=1e-5)
    assert abs(pxm - px) < 1e-10, (pxm, px)
    assert abs(pym - py) < 1e-10, (pym, py)
    assert float(np.abs(np.asarray(X1m - X1)).max()) < 1e-10
    assert float(np.abs(np.asarray(Y1m - Y1)).max()) < 1e-10
    # downstream consumers see the f64 rebuild
    assert resp.pertbar["MU_X"].Avo.dtype == np.float64
    assert cc.t1.dtype == np.float64


def test_mixed_response_df_matches_pure_f64():
    """storage='df' (the at-scale mode): mixed == pure f64 at
    well-conditioned frequencies.  Near a pole of (HBAR - omega) the
    system is near-singular and ANY two working-precision solutions may
    differ by ||r||/sigma_min (measured ~4e-9 at omega=0.0656 for this
    system) — so the equality oracle uses omega values where the
    conditioning is sound (see ccresponse._solve_mixed docstring)."""
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn, storage="df", df_tol=1e-12)
        cc.solve_cc(1e-12, 1e-12)
        lam = pycc_tpu.cclambda(cc, pycc_tpu.cchbar(cc))
        lam.solve_lambda(e_conv=1e-12, r_conv=1e-12)
        resp = pycc_tpu.ccresponse(pycc_tpu.ccdensity(cc, lam))
        for om in (0.0, 0.1):
            X1, X2, px = resp.solve_right(resp.pertbar["MU_X"], om,
                                          e_conv=1e-12, r_conv=1e-12)
            X1m, X2m, pxm = resp.solve_right_mixed(
                "MU_X", om, e_conv=1e-12, r_conv=1e-12, sp_conv=1e-5)
            assert abs(pxm - px) < 1e-10, (om, pxm, px)
            assert float(np.abs(np.asarray(X1m - X1)).max()) < 1e-10


def test_mixed_response_requires_dp():
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn, precision="SP")
        cc.solve_cc(1e-7, 1e-7)
        lam = pycc_tpu.cclambda(cc, pycc_tpu.cchbar(cc))
        lam.solve_lambda(e_conv=1e-7, r_conv=1e-7)
        resp = pycc_tpu.ccresponse(pycc_tpu.ccdensity(cc, lam))
    with pytest.raises(Exception, match="DP"):
        resp.solve_right_mixed("MU_X", 0.0656)


def test_mixed_lambda_requires_dp():
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn, precision="SP")
        cc.solve_cc(1e-7, 1e-7)
        lam = pycc_tpu.cclambda(cc, pycc_tpu.cchbar(cc))
    with pytest.raises(Exception, match="DP"):
        lam.solve_lambda_mixed()


def test_mixed_df_split_residual():
    """The at-scale composition: mixed precision THROUGH the
    host-sequenced split DF residual (both stages re-evaluate the split
    decision at their own dtype)."""
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn, storage="df", df_tol=1e-12)
        cc._force_split_df = True
        emx = cc.solve_cc_mixed(1e-12, 1e-12)
    assert cc._host_residual_fn is not None  # the split was really active
    assert abs(emx - E_CCSD_STO3G) < 1e-9
    # the f64 refinement stage must have routed through the scan
    # formulation (no o^2v^2-output dot anywhere): a backend that emulates
    # f64 widens every f64 dot output ~8x its natural bytes, so the
    # seven-program split cannot compile there in f64 at scale.
    from pycc_tpu.models.dfccsd import residuals_ccsd_df_scan_host
    assert cc._host_residual_fn.func is residuals_ccsd_df_scan_host


def test_mixed_cc3_df():
    """CC3 over factors through the mixed solver (the CC3 partials bake
    F_ref in and must be rebound per precision stage)."""
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        e64 = pycc_tpu.ccwfn(wfn, model="CC3", storage="df",
                             df_tol=1e-12).solve_cc(1e-12, 1e-12)
        emx = pycc_tpu.ccwfn(wfn, model="CC3", storage="df",
                             df_tol=1e-12).solve_cc_mixed(1e-12, 1e-12)
    assert abs(emx - e64) < 1e-11


def test_mixed_requires_dp():
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn, precision="SP")
    with pytest.raises(Exception, match="DP"):
        cc.solve_cc_mixed()


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def test_solve_cc_kill_and_resume(tmp_path):
    """Interrupt solve_cc after 4 iterations (simulated kill: maxiter=4),
    resume from the checkpoint in a FRESH solver object, and match the
    uninterrupted energy; with the DIIS ring checkpointed the resumed
    trajectory must equal the uninterrupted one iterate-for-iterate."""
    wfn = scf("H2O", "sto-3g")
    pa = tmp_path / "full.npz"
    pb = tmp_path / "killed.npz"
    with _quiet():
        cca = pycc_tpu.ccwfn(wfn)
        with pytest.warns(UserWarning):   # maxiter=8 "non-convergence"
            cca.solve_cc(1e-12, 1e-12, maxiter=8, chk=str(pa),
                         chk_every=1, chk_ring=True)

        ccb = pycc_tpu.ccwfn(wfn)
        with pytest.warns(UserWarning):   # maxiter=4 simulated kill
            ccb.solve_cc(1e-12, 1e-12, maxiter=4, chk=str(pb),
                         chk_every=1, chk_ring=True)
        ccb2 = pycc_tpu.ccwfn(wfn)       # fresh object = a real restart
        with pytest.warns(UserWarning):
            ccb2.solve_cc(1e-12, 1e-12, maxiter=8, chk=str(pb),
                          chk_every=1, chk_ring=True, resume=True)
    da = np.load(pa)
    db = np.load(pb)
    assert int(da["niter"]) == int(db["niter"]) == 8
    # exact trajectory equality at iteration 8 (ring + counter restored)
    assert np.abs(da["t2"] - db["t2"]).max() < 1e-12
    assert abs(float(da["ecc"]) - float(db["ecc"])) < 1e-12

    # and resuming to convergence lands on the uninterrupted fixed point
    with _quiet():
        ccc = pycc_tpu.ccwfn(wfn)
        ec = ccc.solve_cc(1e-12, 1e-12, chk=str(pb), resume=True)
    with _quiet():
        e_full = pycc_tpu.ccwfn(wfn).solve_cc(1e-12, 1e-12)
    assert abs(ec - e_full) < 1e-11
    assert abs(e_full - E_CCSD_STO3G) < 1e-11


def test_solve_lambda_resume(tmp_path):
    wfn = scf("H2O", "sto-3g")
    p = tmp_path / "lam.npz"
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn)
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu.cchbar(cc)
        lam_full = pycc_tpu.cclambda(cc, hbar)
        le_full = lam_full.solve_lambda(1e-12, 1e-12)

        lam_a = pycc_tpu.cclambda(cc, hbar)
        with pytest.warns(UserWarning):
            lam_a.solve_lambda(1e-12, 1e-12, maxiter=3, chk=str(p),
                               chk_every=1, chk_ring=True)
        lam_b = pycc_tpu.cclambda(cc, hbar)
        le_res = lam_b.solve_lambda(1e-12, 1e-12, chk=str(p),
                                    chk_ring=True, resume=True)
    assert abs(le_res - le_full) < 1e-11


def test_solve_eom_resume(tmp_path):
    wfn = scf("H2O", "sto-3g", freeze_core=False)
    p = tmp_path / "eom.npz"
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn)
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu.cchbar(cc)
        eom = pycc_tpu.cceom(hbar)
        E_full, _ = eom.solve_eom(N=2, e_conv=1e-8, r_conv=1e-6)

        eom_a = pycc_tpu.cceom(hbar)
        with pytest.warns(UserWarning):
            eom_a.solve_eom(N=2, e_conv=1e-8, r_conv=1e-6, maxiter=2,
                            chk=str(p))
        eom_b = pycc_tpu.cceom(hbar)
        E_res, _ = eom_b.solve_eom(N=2, e_conv=1e-8, r_conv=1e-6,
                                   chk=str(p), resume=True)
    assert np.allclose(E_res, E_full, atol=1e-8)


def test_mixed_eom_matches_pure_f64():
    """solve_eom_mixed (f32 floor Davidson -> f64 refinement seeded with
    the floor Ritz vectors) must land on the same roots as a pure-f64
    Davidson; the floor stage must actually have run (e_sp_floor is the
    f32 stage's roots, correct to the f32 floor but not beyond)."""
    wfn = scf("H2O", "sto-3g", freeze_core=False)
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn)
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu.cchbar(cc)
        eom64 = pycc_tpu.cceom(hbar)
        E64, _ = eom64.solve_eom(N=3, e_conv=1e-9, r_conv=1e-7)

        eommx = pycc_tpu.cceom(pycc_tpu.cchbar(cc))
        Emx, _ = eommx.solve_eom_mixed(N=3, e_conv=1e-9, r_conv=1e-7)
    assert eommx.converged
    assert np.allclose(Emx, E64, atol=1e-8), (Emx, E64)
    assert np.allclose(eommx.e_sp_floor, E64, atol=1e-3)
    # the refinement actually moved past the f32 floor
    assert np.abs(np.asarray(Emx) - np.asarray(E64)).max() < \
        np.abs(eommx.e_sp_floor - np.asarray(E64)).max() + 1e-8


def test_mixed_eom_device_subspace():
    """The device-resident Davidson path must thread the array-guess
    seeding and ritz_out stash identically (this is the combination the
    at-scale mixed solve uses)."""
    wfn = scf("H2O", "sto-3g", freeze_core=False)
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn)
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu.cchbar(cc)
        eom64 = pycc_tpu.cceom(hbar)
        E64, _ = eom64.solve_eom(N=2, e_conv=1e-9, r_conv=1e-7)

        eommx = pycc_tpu.cceom(pycc_tpu.cchbar(cc))
        Emx, _ = eommx.solve_eom_mixed(N=2, e_conv=1e-9, r_conv=1e-7,
                                       device_subspace=True)
    assert eommx.converged
    assert np.allclose(Emx, E64, atol=1e-8), (Emx, E64)


def test_mixed_eom_requires_dp():
    wfn = scf("H2O", "sto-3g", freeze_core=False)
    with _quiet():
        cc = pycc_tpu.ccwfn(wfn, precision="SP")
        cc.solve_cc(1e-6, 1e-6)
        hbar = pycc_tpu.cchbar(cc)
        eom = pycc_tpu.cceom(hbar)
    with pytest.raises(Exception, match="precision='DP'"):
        eom.solve_eom_mixed(N=1)


def test_mixed_stage_aware_resume(tmp_path):
    """solve_cc_mixed(chk=, resume=): an interruption AFTER the f32 floor
    stage must resume directly into the f64 refinement (the .floor.npz
    completion record carries the floor amplitudes + e_sp_floor), and the
    resumed run must land on the uninterrupted mixed fixed point."""
    wfn = scf("H2O", "sto-3g")
    base = str(tmp_path / "mx")
    import os
    with _quiet():
        e_ref = pycc_tpu.ccwfn(wfn).solve_cc_mixed(1e-12, 1e-12)

        # run 1: complete the floor, then die in refinement (maxiter cap)
        cc1 = pycc_tpu.ccwfn(wfn)
        with pytest.warns(UserWarning):
            cc1.solve_cc_mixed(1e-12, 1e-12, chk=base, chk_every=1,
                               refine_maxiter=2)
        floor1 = cc1.e_sp_floor
    assert os.path.exists(base + ".floor.npz")

    # run 2: fresh object + resume — must SKIP the f32 stage entirely
    # (e_sp_floor restored from the record, not re-solved) and finish
    with _quiet():
        cc2 = pycc_tpu.ccwfn(wfn)
        e2 = cc2.solve_cc_mixed(1e-12, 1e-12, chk=base, chk_every=1,
                                resume=True)
    assert cc2.e_sp_floor == floor1
    assert abs(e2 - e_ref) < 1e-11
    assert abs(e2 - E_CCSD_STO3G) < 1e-11
