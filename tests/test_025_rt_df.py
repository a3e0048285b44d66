"""Real-time CC over DF factors (rtcc with storage='df').

The RHS (T residuals, Lambda residuals with the HBAR rebuilt under the
field-dressed Fock, phase quasienergy), the step observables (density-
based Lagrangian, one-pdm dipole), and the re/im-split mode must all
equal the dense path on exact factors.  The reference's RT driver needs
the dense MO ERI (/root/reference/pycc/rt/rtcc.py via hamiltonian.py:36)
— RT at DF scale has no counterpart there.
"""

import contextlib
import io

import numpy as np
import jax.numpy as jnp
import pytest

import pycc_tpu
from pycc_tpu.hamiltonian import build_hamiltonian
from pycc_tpu.ops.cholesky import cholesky_factor_eri
from pycc_tpu.rt.lasers import gaussian_laser
from pycc_tpu.scf import run_rhf

from .common import H2O as H2O_GEOM


@pytest.fixture(scope="module")
def setup():
    wfn = run_rhf(H2O_GEOM, "sto-3g", freeze_core=True)
    H = build_hamiltonian(wfn, host=True)
    B = cholesky_factor_eri(np.asarray(H.ERI), tol=1e-14)
    mu = np.stack([np.asarray(m) for m in H.mu])
    V = gaussian_laser(0.05, 0.0, 0.01, center=0.05)
    with contextlib.redirect_stdout(io.StringIO()):
        cc_d = pycc_tpu.ccwfn(wfn)
        cc_d.solve_cc(e_conv=1e-12, r_conv=1e-12)
        hb_d = pycc_tpu.cchbar(cc_d)
        lam_d = pycc_tpu.cclambda(cc_d, hb_d)
        lam_d.solve_lambda(e_conv=1e-12, r_conv=1e-12)
        dens_d = pycc_tpu.ccdensity(cc_d, lam_d)
        rt_d = pycc_tpu.rtcc(cc_d, lam_d, dens_d, V)

        cc_f = pycc_tpu.ccwfn.from_df_factors(B, np.asarray(H.F), H.no,
                                              mu=mu)
        cc_f.solve_cc(e_conv=1e-12, r_conv=1e-12)
        hb_f = pycc_tpu.cchbar(cc_f)
        lam_f = pycc_tpu.cclambda(cc_f, hb_f)
        lam_f.solve_lambda(e_conv=1e-12, r_conv=1e-12)
        dens_f = pycc_tpu.ccdensity(cc_f, lam_f)
        rt_f = pycc_tpu.rtcc(cc_f, lam_f, dens_f, V)
        rt_fr = pycc_tpu.rtcc(cc_f, lam_f, dens_f, V, ri_split=True)
        y0_d = rt_d.collect_amps(cc_d.t1, cc_d.t2, lam_d.l1, lam_d.l2,
                                 jnp.asarray(0.0 + 0.0j))
        y0_f = rt_f.collect_amps(cc_f.t1, cc_f.t2, lam_f.l1, lam_f.l2,
                                 jnp.asarray(0.0 + 0.0j))
    return rt_d, rt_f, rt_fr, np.asarray(y0_d), np.asarray(y0_f)


def test_rhs_df_equals_dense(setup):
    rt_d, rt_f, rt_fr, y0_d, y0_f = setup
    # same converged state to 1e-11 first (the df solve IS the dense
    # fixed point on exact factors)
    assert np.abs(y0_d - y0_f).max() < 1e-9
    f_d = rt_d.f(0.02, y0_d)
    f_f = rt_f.f(0.02, y0_d)
    assert np.abs(np.asarray(f_d) - np.asarray(f_f)).max() < 1e-10


def test_rhs_ri_split_df(setup):
    rt_d, rt_f, rt_fr, y0_d, y0_f = setup
    f_f = rt_f.f(0.02, y0_f)
    f_r = rt_fr.f(0.02, y0_f)
    assert np.abs(np.asarray(f_f) - np.asarray(f_r)).max() < 1e-12


def test_rhs_df_split(setup):
    """The host-sequenced at-scale RHS (rhs_split=True: seven-program
    split T residual + six-program on-the-fly Lambda split + factor-
    reassociated phase) equals the fused RHS exactly, in both complex
    and re/im-split modes — including off the fixed point (perturbed y,
    so every residual term is exercised with nonzero imaginary parts)."""
    rt_d, rt_f, rt_fr, y0_d, y0_f = setup
    cc, lam, dens = rt_f.ccwfn, rt_f.cclambda, rt_f.ccdensity
    V = rt_f.V
    with contextlib.redirect_stdout(io.StringIO()):
        rt_s = pycc_tpu.rtcc(cc, lam, dens, V, rhs_split=True)
        rt_sr = pycc_tpu.rtcc(cc, lam, dens, V, ri_split=True,
                              rhs_split=True)
    assert rt_s.df_split and rt_sr.df_split
    rng = np.random.default_rng(7)
    y = y0_f + 0.01 * (rng.standard_normal(y0_f.shape)
                       + 1j * rng.standard_normal(y0_f.shape))
    f_f = np.asarray(rt_f.f(0.02, y))
    assert np.abs(f_f - np.asarray(rt_s.f(0.02, y))).max() < 1e-12
    f_fr = np.asarray(rt_fr.f(0.02, y))
    assert np.abs(f_fr - np.asarray(rt_sr.f(0.02, y))).max() < 1e-12


def test_rhs_df_cc2_equals_dense():
    """RT-CC2 over factors: the CC2 DF-HBAR/Lambda forms
    (models/dfhbar.py build_hbar_df(model='CC2') /
    _lambda_residuals_cc2_df) drive the same dynamics as the dense CC2
    RHS, in both complex and re/im-split modes."""
    wfn = run_rhf(H2O_GEOM, "sto-3g", freeze_core=True)
    H = build_hamiltonian(wfn, host=True)
    B = cholesky_factor_eri(np.asarray(H.ERI), tol=1e-14)
    mu = np.stack([np.asarray(m) for m in H.mu])
    V = gaussian_laser(0.05, 0.0, 0.01, center=0.05)
    with contextlib.redirect_stdout(io.StringIO()):
        cc_d = pycc_tpu.ccwfn(wfn, model="CC2")
        cc_d.solve_cc(e_conv=1e-12, r_conv=1e-12)
        lam_d = pycc_tpu.cclambda(cc_d, pycc_tpu.cchbar(cc_d))
        lam_d.solve_lambda(e_conv=1e-12, r_conv=1e-12)
        rt_d = pycc_tpu.rtcc(cc_d, lam_d, None, V)

        cc_f = pycc_tpu.ccwfn.from_df_factors(B, np.asarray(H.F), H.no,
                                              model="CC2", mu=mu)
        cc_f.solve_cc(e_conv=1e-12, r_conv=1e-12)
        lam_f = pycc_tpu.cclambda(cc_f, pycc_tpu.cchbar(cc_f))
        lam_f.solve_lambda(e_conv=1e-12, r_conv=1e-12)
        rt_f = pycc_tpu.rtcc(cc_f, lam_f, None, V)
        rt_fr = pycc_tpu.rtcc(cc_f, lam_f, None, V, ri_split=True)
        y0 = rt_d.collect_amps(cc_d.t1, cc_d.t2, lam_d.l1, lam_d.l2,
                               jnp.asarray(0.0 + 0.0j))
    y0 = np.asarray(y0)
    f_d = np.asarray(rt_d.f(0.02, y0))
    f_f = np.asarray(rt_f.f(0.02, y0))
    assert np.abs(f_d - f_f).max() < 1e-10
    f_r = np.asarray(rt_fr.f(0.02, y0))
    assert np.abs(f_d - f_r).max() < 1e-10


def test_rhs_df_cc3_equals_dense():
    """RT-CC3 over factors: the fused RHS (factor-assembled CC3 residual
    scan + slab-scanned Lambda extras), the re/im-split mode, the
    host-stepped rows path, and the step observables (CC3 lagrangian +
    T1-transformed dipole) all equal the dense CC3 path."""
    from pycc_tpu.rt.integrators import rk4

    wfn = run_rhf(H2O_GEOM, "sto-3g", freeze_core=True)
    H = build_hamiltonian(wfn, host=True)
    B = cholesky_factor_eri(np.asarray(H.ERI), tol=1e-14)
    mu = np.stack([np.asarray(m) for m in H.mu])
    V = gaussian_laser(0.05, 0.0, 0.01, center=0.05)
    with contextlib.redirect_stdout(io.StringIO()):
        cc_d = pycc_tpu.ccwfn(wfn, model="CC3")
        cc_d.solve_cc(e_conv=1e-12, r_conv=1e-12)
        lam_d = pycc_tpu.cclambda(cc_d, pycc_tpu.cchbar(cc_d))
        lam_d.solve_lambda(e_conv=1e-12, r_conv=1e-12)
        rt_d = pycc_tpu.rtcc(cc_d, lam_d, None, V)

        cc_f = pycc_tpu.ccwfn.from_df_factors(B, np.asarray(H.F), H.no,
                                              model="CC3", mu=mu)
        cc_f.solve_cc(e_conv=1e-12, r_conv=1e-12)
        lam_f = pycc_tpu.cclambda(cc_f, pycc_tpu.cchbar(cc_f))
        lam_f.solve_lambda(e_conv=1e-12, r_conv=1e-12)
        rt_f = pycc_tpu.rtcc(cc_f, lam_f, None, V)
        rt_fr = pycc_tpu.rtcc(cc_f, lam_f, None, V, ri_split=True)
        y0 = rt_d.collect_amps(cc_d.t1, cc_d.t2, lam_d.l1, lam_d.l2,
                               jnp.asarray(0.0 + 0.0j))
    y0 = np.asarray(y0)
    f_d = np.asarray(rt_d.f(0.02, y0))
    f_f = np.asarray(rt_f.f(0.02, y0))
    assert np.abs(f_d - f_f).max() < 1e-10
    f_r = np.asarray(rt_fr.f(0.02, y0))
    assert np.abs(f_d - f_r).max() < 1e-10

    # host-stepped rows path from factors (the at-scale RHS)
    cc_f.t3_scan = True
    with contextlib.redirect_stdout(io.StringIO()):
        rt_fh = pycc_tpu.rtcc(cc_f, lam_f, None, V)
    cc_f.t3_scan = None
    assert rt_fh.host_stepped
    f_h = np.asarray(rt_fh.f(0.02, y0))
    assert np.abs(f_d - f_h).max() < 1e-10

    # step observables: CC3 lagrangian + T1-transformed dipole
    ode = rk4(0.02)
    with contextlib.redirect_stdout(io.StringIO()):
        y_d, ret_d = rt_d.step(ode, y0, 0.0)
        y_f, ret_f = rt_f.step(ode, y0, 0.0)
    assert np.abs(np.asarray(y_d) - np.asarray(y_f)).max() < 1e-9
    assert abs(ret_d["ecc"] - ret_f["ecc"]) < 1e-9
    for k in ("mu_x", "mu_y", "mu_z"):
        assert abs(ret_d[k] - ret_f[k]) < 1e-9


def test_step_observables_df(setup):
    from pycc_tpu.rt.integrators import rk4

    rt_d, rt_f, rt_fr, y0_d, y0_f = setup
    ode = rk4(0.02)
    y_d, ret_d = rt_d.step(ode, y0_d, 0.0)
    y_f, ret_f = rt_f.step(ode, y0_d, 0.0)
    assert np.abs(np.asarray(y_d) - np.asarray(y_f)).max() < 1e-9
    assert abs(ret_d["ecc"] - ret_f["ecc"]) < 1e-9
    for k in ("mu_x", "mu_y", "mu_z"):
        assert abs(ret_d[k] - ret_f[k]) < 1e-9
