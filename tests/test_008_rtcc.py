"""Real-time CC propagation tests.

Oracles: frozen Psi4 values from test_006_rtccsd.py:61 (He, scipy vode),
test_021_rk4.py:90 (H2O, rk4), test_030_sp.py:78 (static correlated mu_z);
plus the reference's integrator unit-test pattern (test_015_ints.py) and a
self-generated checkpoint/restart equality oracle (test_016_chk.py pattern).
"""

import contextlib
import io

import numpy as np
import pytest

import pycc_tpu
from pycc_tpu.rt.integrators import rk2, rk3, rk38, rk4, gl4, gl6, ck
from pycc_tpu.rt.lasers import gaussian_laser, sine_square_laser
from .common import scf


def _setup(mol, basis):
    wfn = scf(mol, basis, freeze_core=False)
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(wfn)
        cc.solve_cc(1e-13, 1e-13)
        hbar = pycc_tpu.cchbar(cc)
        lam = pycc_tpu.cclambda(cc, hbar)
        lam.solve_lambda(1e-13, 1e-13)
        dens = pycc_tpu.ccdensity(cc, lam)
    return cc, lam, dens


def test_rtcc_he_scipy_vode():
    from scipy.integrate import complex_ode as ode
    cc, lam, dens = _setup("He", "cc-pvdz")
    V = sine_square_laser(1.0, 2.87, 5.0)
    rt = pycc_tpu.rtcc(cc, lam, dens, V)
    y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).astype("complex128")
    ODE = ode(rt.f).set_integrator("vode", atol=1e-13, rtol=1e-13)
    ODE.set_initial_value(y0, 0)
    h, tf = 0.01, 1.0
    while ODE.successful() and ODE.t < tf:
        y = ODE.integrate(ODE.t + h)
    t1, t2, l1, l2, phase = rt.extract_amps(y)
    mu_z = rt.dipole(t1, t2, l1, l2)[2]
    assert abs(0.008400738202694 - mu_z.real) < 1e-10


def test_rtcc_h2o_rk4():
    cc, lam, dens = _setup("H2O", "cc-pvdz")
    V = gaussian_laser(0.01, 0, 0.01, 0.05)
    rt = pycc_tpu.rtcc(cc, lam, dens, V)
    # static correlated dipole (test_030_sp.py:78 oracle, DP here)
    mu0_z = rt.dipole(cc.t1, cc.t2, lam.l1, lam.l2)[2]
    assert abs(-0.07800691 - mu0_z.real) < 1e-6
    y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).astype("complex128")
    ODE = rk4(0.01)
    t = 0.0
    while t < 0.1:
        y = ODE(rt.f, t, y)
        t += 0.01
    t1, t2, l1, l2, phase = rt.extract_amps(y)
    mu_z = rt.dipole(t1, t2, l1, l2)[2]
    assert abs(-0.0780067603267549 - mu_z.real) < 1e-4


def test_integrators_analytic_ode():
    """dy/dx = 3x^2 y with y(0)=1 -> y = exp(x^3) (test_015 pattern)."""
    f = lambda x, y: 3 * x * x * y
    for ODE, tol in [(rk2(0.01), 5e-4), (rk3(0.01), 1e-6), (rk4(0.01), 1e-8),
                     (rk38(0.01), 1e-8), (gl4(0.01), 1e-8), (gl6(0.01), 1e-8)]:
        y = np.array([1.0])
        x = 0.0
        for _ in range(100):
            y = ODE(f, x, y)
            x += ODE.h
        assert abs(y[0] - np.exp(1.0)) < tol, type(ODE).__name__


def test_adaptive_integrator_analytic_ode():
    f = lambda x, y: 3 * x * x * y
    ODE = ck(maxiter=20, yconv=1e-10)
    x, y, h = 0.0, np.array([1.0]), 0.01
    while x < 1.0 - 1e-12:
        h = min(h, 1.0 - x)
        y, h_used, h = ODE(f, x, y, h)
        x += h_used
    assert abs(y[0] - np.exp(1.0)) < 1e-6


def test_rtcc_checkpoint_restart(tmp_path):
    import os
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cc, lam, dens = _setup("He", "cc-pvdz")
        V = gaussian_laser(0.01, 0, 0.01, 0.05)
        rt = pycc_tpu.rtcc(cc, lam, dens, V)
        y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).astype("complex128")
        ODE = rk4(0.01)
        # full run 0 -> 0.1
        ret_full = rt.propagate(ODE, y0.copy(), 0.1, ti=0)
        # checkpointed run 0 -> 0.05, then restart to 0.1
        ret1 = rt.propagate(ODE, y0.copy(), 0.05, ti=0, chk=True,
                            ofile="o.pk", cfile="c.pk")
        import pickle as pk
        with open("c.pk", "rb") as fh:
            chkp = pk.load(fh)
        ret2 = rt.propagate(ODE, chkp["y"], 0.1, ti=chkp["time"], chk=True,
                            ofile="o.pk", cfile="c.pk")
        k_full = sorted(ret_full.keys())[-1]
        k_re = sorted(ret2.keys())[-1]
        assert k_full == k_re
        for prop in ("ecc", "mu_z"):
            assert np.allclose(complex(ret_full[k_full][prop]),
                               complex(ret2[k_re][prop]), atol=1e-12)
    finally:
        os.chdir(cwd)


def test_autocorrelation_identity():
    cc, lam, dens = _setup("He", "cc-pvdz")
    V = gaussian_laser(0.01, 0, 0.01, 0.05)
    rt = pycc_tpu.rtcc(cc, lam, dens, V)
    y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).astype("complex128")
    assert abs(rt.autocorrelation(y0, y0) - 1.0) < 1e-12


def test_delta_pulse_laser():
    """Delta pulse fires only at its center (test_029 pattern, fixed
    assertion — the reference's .all()==.all() check is vacuous)."""
    from pycc_tpu.rt.lasers import delta_pulse_laser
    V = delta_pulse_laser(1.0, center=5)
    vals = np.array([float(V(float(t))) for t in range(20)])
    ref = np.zeros(20)
    ref[5] = 1.0
    assert np.allclose(vals, ref)


def test_mixed_step_integration():
    """Small-step while the field is on, large-step after (test_023_ms_int
    pattern): result consistent with uniform small steps."""
    cc, lam, dens = _setup("He", "cc-pvdz")
    V = gaussian_laser(0.01, 0, 0.01, 0.05)
    rt = pycc_tpu.rtcc(cc, lam, dens, V)
    y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).astype("complex128")
    h_small, h_big, e_field = 0.005, 0.02, 1e-5

    y, t = y0.copy(), 0.0
    while t < 0.2 - 1e-12:
        if float(V(t)) > e_field:
            y = rk4(h_small)(rt.f, t, y)
            t += h_small
        else:
            y = rk4(h_big)(rt.f, t, y)
            t += h_big
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    mu_mixed = rt.dipole(t1, t2, l1, l2)[2].real

    y, t = y0.copy(), 0.0
    while t < 0.2 - 1e-12:
        y = rk4(h_small)(rt.f, t, y)
        t += h_small
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    mu_fine = rt.dipole(t1, t2, l1, l2)[2].real
    assert abs(mu_mixed - mu_fine) < 1e-5


def test_rtcc_cc2_smoke():
    """RT-CC2 propagates with finite, stable properties (capability-matrix
    row RT-CC2; SURVEY §2.2)."""
    wfn = scf("He", "cc-pvdz", freeze_core=False)
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(wfn, model="CC2")
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu.cchbar(cc)
        lam = pycc_tpu.cclambda(cc, hbar)
        lam.solve_lambda(1e-12, 1e-12)
        dens = pycc_tpu.ccdensity(cc, lam)
    V = gaussian_laser(0.01, 0, 0.01, 0.05)
    rt = pycc_tpu.rtcc(cc, lam, dens, V)
    y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).astype("complex128")
    ODE = rk4(0.01)
    t = 0.0
    while t < 0.05:
        y = ODE(rt.f, t, y)
        t += 0.01
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    mu = rt.dipole(t1, t2, l1, l2)
    ecc = rt.lagrangian(t, t1, t2, l1, l2)
    assert np.isfinite(complex(ecc).real)
    assert all(np.isfinite(complex(m).real) for m in mu)


def test_ri_split_matches_complex():
    """Real/imag-split RT (rtcc(ri_split=True), ops/ctensor.py): RHS and
    short rk4 trajectories equal the complex-dtype path to ~1e-17.  This is
    the formulation for a backend without complex ops."""
    cc, lam, dens = _setup("He", "cc-pvdz")
    V = gaussian_laser(0.01, 0, 0.01, 0.05)
    rt_c = pycc_tpu.rtcc(cc, lam, dens, V)
    rt_r = pycc_tpu.rtcc(cc, lam, dens, V, ri_split=True)
    y0 = rt_c.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2,
                           0).astype("complex128")
    assert np.abs(rt_c.f(0.02, y0) - rt_r.f(0.02, y0)).max() < 1e-14
    yc, yr, t = y0.copy(), y0.copy(), 0.0
    for _ in range(5):
        yc = rk4(0.01)(rt_c.f, t, yc)
        yr = rk4(0.01)(rt_r.f, t, yr)
        t += 0.01
    assert np.abs(yc - yr).max() < 1e-14


def test_ri_split_local_matches_complex():
    """RT-PNO with re/im-split amplitudes == the complex path: the
    pair-space filter projections are real-linear, so they apply
    componentwise to the (re, im) pair (round-2 coverage; previously
    local models raised)."""
    import numpy as np
    import pycc_tpu as p
    with contextlib.redirect_stdout(io.StringIO()):
        ccl = p.ccwfn(scf("H2O", "sto-3g", freeze_core=False),
                      local="PNO", local_cutoff=1e-7, filter=True)
        ccl.solve_cc(1e-10, 1e-10)
        hbl = p.cchbar(ccl)
        laml = p.cclambda(ccl, hbl)
        laml.solve_lambda(1e-10, 1e-10)
        densl = p.ccdensity(ccl, laml)
    V = gaussian_laser(0.01, 0, 0.01, 0.05)
    rt_c = p.rtcc(ccl, laml, densl, V)
    rt_r = p.rtcc(ccl, laml, densl, V, ri_split=True)
    y0 = rt_c.collect_amps(ccl.t1, ccl.t2, laml.l1, laml.l2,
                           0).astype("complex128")
    assert np.abs(rt_c.f(0.02, y0) - rt_r.f(0.02, y0)).max() < 1e-14
