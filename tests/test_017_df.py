"""DF/Cholesky-factorized storage: factorization accuracy, residual
equality with the dense equations, and frozen-energy oracles.

The reference has no DF path (its hamiltonian.py:36-39 materializes the
dense MO ERI); the oracle here is the repo's own dense solver plus the
frozen Psi4 energies of tests/test_002.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pycc_tpu import ccwfn
from pycc_tpu.hamiltonian import build_hamiltonian
from pycc_tpu.models import ccsd as eqs
from pycc_tpu.models import dfccsd as dfq
from pycc_tpu.ops.cholesky import cholesky_factor_eri
from pycc_tpu.scf import run_rhf

from .common import H2O as H2O_GEOM


@pytest.fixture(scope="module")
def h2o_sto3g():
    return run_rhf(H2O_GEOM, "sto-3g", freeze_core=True)


@pytest.fixture(scope="module")
def h2o_dz():
    return run_rhf(H2O_GEOM, "cc-pvdz", freeze_core=True)


def test_cholesky_reconstruction(h2o_dz):
    H = build_hamiltonian(h2o_dz, host=True)
    ERI = np.asarray(H.ERI)
    for tol in (1e-4, 1e-8):
        B = cholesky_factor_eri(ERI, tol=tol)
        rec = np.einsum("Ppr,Pqs->pqrs", B, B)
        assert np.abs(rec - ERI).max() < 10 * tol
        assert B.shape[0] < ERI.shape[0] ** 2  # actually compressed


def test_df_residuals_match_dense(h2o_sto3g):
    H = build_hamiltonian(h2o_sto3g, host=True)
    ERI = np.asarray(H.ERI)
    no = H.no
    nv = ERI.shape[0] - no
    B = cholesky_factor_eri(ERI, tol=1e-14)
    rec = np.einsum("Ppr,Pqs->pqrs", B, B)
    L = 2.0 * rec - rec.swapaxes(2, 3)
    rng = np.random.default_rng(7)
    t1 = jnp.asarray(0.05 * rng.standard_normal((no, nv)))
    t2r = 0.05 * rng.standard_normal((no, no, nv, nv))
    t2 = jnp.asarray(t2r + t2r.transpose(1, 0, 3, 2))
    F = jnp.asarray(H.F)
    df = dfq.df_blocks(jnp.asarray(B), no)
    rec, L = jnp.asarray(rec), jnp.asarray(L)
    for dense_fn, df_fn in [(eqs.residuals_ccsd, dfq.residuals_ccsd_df),
                            (eqs.residuals_ccd, dfq.residuals_ccd_df),
                            (eqs.residuals_cc2, dfq.residuals_cc2_df)]:
        r1d, r2d = dense_fn(F, rec, L, t1, t2, no)
        r1f, r2f = df_fn(F, df, t1, t2, no)
        assert float(jnp.abs(r1d - r1f).max()) < 1e-13
        assert float(jnp.abs(r2d - r2f).max()) < 1e-13
    # blocked ladder path == single-shot
    r1b, r2b = dfq.residuals_ccsd_df(F, df, t1, t2, no, nblocks=3)
    _, r2u = dfq.residuals_ccsd_df(F, df, t1, t2, no, nblocks=1)
    assert float(jnp.abs(r2b - r2u).max()) < 1e-13
    # energy
    ed = eqs.cc_energy(F, L, t1, t2, no)
    ef = dfq.cc_energy_df(F, df, t1, t2, no)
    assert abs(float(ed - ef)) < 1e-13


def test_df_ccsd_oracle_sto3g(h2o_sto3g):
    cc = ccwfn(h2o_sto3g, storage="df", df_tol=1e-12)
    e = cc.solve_cc(e_conv=1e-12, r_conv=1e-12)
    assert abs(e - -0.070616830152761) < 1e-10


def test_df_tolerance_controls_energy_error(h2o_sto3g):
    dense = ccwfn(h2o_sto3g)
    e_ref = dense.solve_cc(e_conv=1e-12, r_conv=1e-12)
    loose = ccwfn(h2o_sto3g, storage="df", df_tol=1e-4)
    e_loose = loose.solve_cc(e_conv=1e-12, r_conv=1e-12)
    assert 0 < abs(e_loose - e_ref) < 1e-3
    assert loose.naux < dense.nact ** 2


def test_df_fused_solver(h2o_sto3g):
    cc = ccwfn(h2o_sto3g, storage="df", df_tol=1e-12)
    e = cc.solve_cc_fused(e_conv=1e-12, r_conv=1e-12)
    assert abs(e - -0.070616830152761) < 1e-10


def test_mp2_guess_scan_equals_fused():
    """The at-scale DP guess (f32-assembled, widened — auto-selected for
    big f64 constructions, where an emulated-f64 backend cannot compile
    either f64 assembly form) matches the exact f64 one-shot
    guess to f32 relative accuracy: the guess is only a starting point,
    and both mixed stages iterate to dtype-independent fixed points
    (test_027 pins the fixed-point equality)."""
    from pycc_tpu.ccwfn import (_mp2_guess_big64, _mp2_guess_fused,
                                _mp2_guess_scan)
    rng = np.random.default_rng(7)
    naux, nact, no = 24, 10, 3
    B = jnp.asarray(rng.normal(size=(naux, nact, nact)))
    B = 0.5 * (B + B.swapaxes(1, 2))
    F = jnp.asarray(np.diag(np.arange(nact, dtype=float) - no + 0.5))
    dfb = dfq.df_blocks(B, no)
    a = _mp2_guess_fused(dfb, F, no, dfq._eri_oovv, jnp.float64)
    b = _mp2_guess_scan(dfb, F, no, jnp.float64)
    assert b.dtype == jnp.float64
    scale = float(jnp.abs(a).max())
    assert float(jnp.abs(a - b).max()) < 1e-6 * scale
    # selection: f64-only, and only past the o^2v^2 size threshold
    assert not _mp2_guess_big64(np.dtype(np.float64), 4, 8)
    assert _mp2_guess_big64(np.dtype(np.float64), 40, 360)
    assert not _mp2_guess_big64(np.dtype(np.float32), 40, 360)


def test_df_rejects_unsupported():
    wfn = run_rhf(H2O_GEOM, "sto-3g", freeze_core=True)
    # local correlation has no factor-space path (the pair-space solver
    # covers it); every canonical model now runs under storage='df'
    with pytest.raises(Exception):
        ccwfn(wfn, storage="df", local="PNO")


# ---------------------------------------------------------------------------
# integral-direct route (scf/df.py): no four-index tensor anywhere
# ---------------------------------------------------------------------------

def test_ao_cholesky_reconstruction(h2o_dz):
    """AO factors from shell-pair column batches reconstruct the dense AO
    ERI to tol, at two tolerances (monotone naux)."""
    from pycc_tpu.scf import integrals
    from pycc_tpu.scf.df import cholesky_factor_ao

    basis = h2o_dz.basisset()
    ERI = integrals.eri(basis)
    naux_prev = None
    for tol in (1e-4, 1e-8):
        B = cholesky_factor_ao(basis, tol=tol)
        rec = np.einsum("Pab,Pcd->abcd", B, B)
        assert np.abs(rec - ERI).max() < 10 * tol
        if naux_prev is not None:
            assert B.shape[0] > naux_prev
        naux_prev = B.shape[0]


def test_recompress_factors(h2o_dz):
    """Second-stage recompression preserves the reconstructed ERI to tol
    while shrinking AO-rank factors toward active-space rank."""
    from pycc_tpu.ops.cholesky import recompress_factors
    from pycc_tpu.scf.df import cholesky_factor_ao, factors_to_mo

    basis = h2o_dz.basisset()
    B_ao = cholesky_factor_ao(basis, tol=1e-9)
    C = np.asarray(h2o_dz.Ca_subset("AO", "ACTIVE"))
    B_mo = factors_to_mo(B_ao, C)
    B2 = recompress_factors(B_mo, tol=1e-9)
    assert B2.shape[0] <= B_mo.shape[0]
    ref = np.einsum("Ppr,Pqs->pqrs", B_mo, B_mo)
    rec = np.einsum("Ppr,Pqs->pqrs", B2, B2)
    assert np.abs(rec - ref).max() < 1e-8


def test_df_scf_matches_exact(h2o_dz):
    """Integral-direct (DF) SCF == conventional SCF at tight df_tol."""
    wfn_df = run_rhf(H2O_GEOM, "cc-pvdz", freeze_core=True, df=True,
                     df_tol=1e-10)
    assert abs(wfn_df.energy() - h2o_dz.energy()) < 1e-9
    assert wfn_df.B_ao is not None


def test_df_direct_ccsd_oracle():
    """Full dense-free pipeline: DF-SCF -> integral-direct factors ->
    recompression -> DF-CCSD, vs the frozen Psi4 oracle.  df_direct
    auto-activates because the wavefunction carries AO factors."""
    wfn = run_rhf(H2O_GEOM, "cc-pvdz", freeze_core=True, df=True,
                  df_tol=1e-10)
    cc = ccwfn(wfn, storage="df", df_tol=1e-10)
    assert cc.df_direct
    e = cc.solve_cc(e_conv=1e-10, r_conv=1e-10)
    assert abs(e - -0.222029814166783) < 1e-9


def test_df_direct_explicit_no_scf_factors(h2o_sto3g):
    """df_direct=True works from a conventional SCF too (factors built on
    demand); CCSD(T) runs dense-free (the (T) scan assembles its slices
    from the factors, triples.py:415); local stays rejected."""
    cc = ccwfn(h2o_sto3g, storage="df", df_direct=True, df_tol=1e-11)
    e = cc.solve_cc(e_conv=1e-12, r_conv=1e-12)
    assert abs(e - -0.070616830152761) < 1e-9
    cct = ccwfn(h2o_sto3g, storage="df", df_direct=True, df_tol=1e-11,
                model="CCSD(T)")
    et = cct.solve_cc(e_conv=1e-12, r_conv=1e-12)
    et_d = ccwfn(h2o_sto3g, model="CCSD(T)").solve_cc(e_conv=1e-12,
                                                      r_conv=1e-12)
    assert abs(et - et_d) < 1e-9, (et, et_d)
    with pytest.raises(Exception):
        ccwfn(h2o_sto3g, storage="df", df_direct=True, local="PNO")


def test_from_df_factors_round_trip(h2o_sto3g):
    """ccwfn.from_df_factors (the prepare-on-host / solve-on-device entry,
    examples/prepare_df_molecule.py + run_df_molecule.py) reproduces the
    in-process DF solve exactly from the reassembled factor matrix."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        cc = ccwfn(h2o_sto3g, storage="df", df_tol=1e-11)
        e1 = cc.solve_cc(e_conv=1e-11, r_conv=1e-11)
        B = np.concatenate([
            np.concatenate([np.asarray(cc.dfb.Boo),
                            np.asarray(cc.dfb.Bov)], axis=2),
            np.concatenate([np.asarray(cc.dfb.Bov).transpose(0, 2, 1),
                            np.asarray(cc.dfb.Bvv)], axis=2)], axis=1)
        cc2 = ccwfn.from_df_factors(B, np.asarray(cc.H.F), cc.no,
                                    escf=h2o_sto3g.energy())
        e2 = cc2.solve_cc(e_conv=1e-11, r_conv=1e-11)
    assert abs(float(e1) - float(e2)) < 1e-12
    assert abs(float(e1) - -0.070616830152761) < 1e-9


def test_df_solve_without_diis(h2o_sto3g):
    """max_diis=0 disables DIIS at trace time (no ring buffers on device;
    at (48,432) f32 even the depth-1 ring is 3.6 GB) — plain damped
    Jacobi reaches the same fixed point."""
    cc = ccwfn(h2o_sto3g, storage="df", df_tol=1e-13)
    e = cc.solve_cc(e_conv=1e-11, r_conv=1e-11, max_diis=8)
    cc0 = ccwfn(h2o_sto3g, storage="df", df_tol=1e-13)
    e0 = cc0.solve_cc(e_conv=1e-11, r_conv=1e-11, maxiter=300, max_diis=0)
    assert abs(e - e0) < 1e-10, (e, e0)


def test_df_split_residual_and_solve(h2o_sto3g):
    """The host-sequenced seven-program CCSD residual (the at-scale path:
    the ONE-program form holds ~11 simultaneous o^2v^2 temps, over 16 GB
    at (48,432) f32) equals the fused residual
    term by term on arbitrary amplitudes, and the forced-split solve with
    the lean factor-wise update reaches the fused fixed point."""
    import jax

    H = build_hamiltonian(h2o_sto3g, host=True)
    no = H.no
    nv = np.asarray(H.ERI).shape[0] - no
    B = cholesky_factor_eri(np.asarray(H.ERI), tol=1e-13)
    df = dfq.df_blocks(jnp.asarray(B), no)
    rng = np.random.default_rng(17)
    t1 = jnp.asarray(0.05 * rng.standard_normal((no, nv)))
    t2 = jnp.asarray(0.05 * rng.standard_normal((no, no, nv, nv)))
    F = jnp.asarray(H.F)
    r1a, r2a = jax.jit(dfq.residuals_ccsd_df,
                       static_argnames="no")(F, df, t1, t2, no=no)
    r1b, r2b = dfq.residuals_ccsd_df_split(F, df, t1, t2, no)
    assert np.abs(np.asarray(r1a - r1b)).max() < 1e-12
    assert np.abs(np.asarray(r2a - r2b)).max() < 1e-12

    cc = ccwfn(h2o_sto3g, storage="df", df_tol=1e-12)
    cc._force_split_df = True
    cc._maybe_split_df_residual(jnp.float64)
    assert cc._host_residual_fn is not None
    e = cc.solve_cc(e_conv=1e-12, r_conv=1e-12)
    assert abs(e - -0.070616830152761) < 1e-10
