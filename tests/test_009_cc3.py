"""CC3 energies, Lambda, dipole, and RT-CC3 vs Psi4/CFOUR frozen values.

Oracles from /root/reference/pycc/tests/test_031_cc3.py:33-55 and
test_037_rtcc3.py:60-69.
"""

import contextlib
import io

import numpy as np

import pycc_tpu
from pycc_tpu.rt.integrators import rk4
from pycc_tpu.rt.lasers import qrcw_laser
from .common import scf


def _pipeline():
    wfn = scf("H2O_Teach", "cc-pvdz", freeze_core=False)
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(wfn, model="CC3")
        ecc = cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu.cchbar(cc)
        lam = pycc_tpu.cclambda(cc, hbar)
        lecc = lam.solve_lambda(1e-12, 1e-12)
        dens = pycc_tpu.ccdensity(cc, lam)
    return wfn, cc, lam, dens, ecc, lecc


def _scf_dipole(wfn):
    from pycc_tpu.scf import integrals as ints
    mu_ao = ints.dipole(wfn.basisset())
    C = wfn.Ca()
    nd = wfn.ndocc
    mol = wfn.molecule()
    return np.array([mol.nuclear_dipole()[ax]
                     + 2 * np.trace(C[:, :nd].T @ mu_ao[ax] @ C[:, :nd])
                     for ax in range(3)])


def test_cc3_h2o():
    wfn, cc, lam, dens, ecc, lecc = _pipeline()
    assert abs(ecc - -0.227888246840310) < 1e-11      # Psi4
    assert abs(ecc - -0.2278882468404231) < 1e-11     # CFOUR
    assert abs(lecc - -0.2233231845185215) < 1e-11    # CFOUR

    rt = pycc_tpu.rtcc(cc, lam, dens, None)
    CFOUR = np.array([0, 0, 0.7703875967])            # total dipole
    ref = CFOUR - _scf_dipole(wfn)
    mu = rt.dipole(cc.t1, cc.t2, lam.l1, lam.l2)
    assert abs(ref[1] - mu[1].real) < 1e-10
    assert abs(ref[2] - mu[2].real) < 1e-10


def test_rtcc3_h2o():
    wfn = scf("H2O_Teach", "cc-pvdz", freeze_core=False)
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(wfn, model="CC3", real_time=True)
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu.cchbar(cc)
        lam = pycc_tpu.cclambda(cc, hbar)
        lam.solve_lambda(1e-12, 1e-12)
        dens = pycc_tpu.ccdensity(cc, lam)
    V = qrcw_laser(0.002, 0.078, 1)
    rt = pycc_tpu.rtcc(cc, lam, dens, V, kick="x")
    y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).astype("complex128")
    ODE = rk4(0.01)
    t = 0.0
    while t < 0.05:
        y = ODE(rt.f, t, y)
        t += 0.01
    t1, t2, l1, l2, phase = rt.extract_amps(y)
    mu_z = rt.dipole(t1, t2, l1, l2, real_time=True)[2]
    assert abs(-0.0859645691 - mu_z.real) < 1e-10


def test_cc3_scan_matches_full():
    """Occupied-slab CC3 residuals equal the full-tensor path (incl. RT)."""
    from pycc_tpu.models.cc3 import residuals_cc3, residuals_cc3_scan
    from pycc_tpu.utils import mp2_guess, synthetic_hamiltonian
    H = synthetic_hamiltonian(4, 12, seed=5)
    t1, t2, _ = mp2_guess(H)
    t1 = t1 + 0.01
    for kw in ({}, {"real_time": True, "F_ref": H.F}):
        F = H.F + (0.01 if kw else 0.0)
        r1a, r2a = residuals_cc3(F, H.ERI, H.L, t1, t2, H.no, **kw)
        r1b, r2b = residuals_cc3_scan(F, H.ERI, H.L, t1, t2, H.no, **kw)
        assert float(abs(r1a - r1b).max()) < 1e-13
        assert float(abs(r2a - r2b).max()) < 1e-13


def test_cc3_lambda_density_scan_matches_full():
    """Slab-scanned Lambda-CC3 extras and CC3 one-pdm equal the full-tensor
    paths."""
    import jax.numpy as jnp
    from pycc_tpu.models.cc3 import (cc3_lambda_extra, cc3_lambda_extra_scan,
                                     cc3_onepdm, cc3_onepdm_scan)
    from pycc_tpu.utils import mp2_guess, synthetic_hamiltonian
    H = synthetic_hamiltonian(4, 10, seed=9)
    t1, t2, _ = mp2_guess(H)
    t1 = t1 + 0.01
    l1 = 2.0 * t1
    l2 = 2.0 * (2.0 * t2 - t2.swapaxes(2, 3))
    a1, a2 = cc3_lambda_extra(H.F, H.ERI, H.L, t1, t2, l1, l2, H.no)
    b1, b2 = cc3_lambda_extra_scan(H.F, H.ERI, H.L, t1, t2, l1, l2, H.no)
    assert float(abs(a1 - b1).max()) < 1e-13
    assert float(abs(a2 - b2).max()) < 1e-13

    class CC:
        pass
    cc = CC()
    cc.no, cc.nv, cc.nact, cc.H, cc.model = 4, 10, 14, H, "CC3"
    p1, p2 = cc3_onepdm(cc, t1, t2, l1, l2)
    q1, q2 = cc3_onepdm_scan(cc, t1, t2, l1, l2)
    assert float(abs(p1 - q1).max()) < 1e-13
    assert float(abs(p2 - q2).max()) < 1e-13


def test_cc3_host_rows_solver_matches():
    """solve_cc with the host-orchestrated per-row CC3 residual
    (t3_scan=True; the at-scale path) matches the fused solver, with and
    without blocked storage."""
    wfn = scf("H2O_Teach", "cc-pvdz", freeze_core=False)
    with contextlib.redirect_stdout(io.StringIO()):
        e_fused = pycc_tpu.ccwfn(wfn, model="CC3").solve_cc(1e-12, 1e-12)
        e_rows = pycc_tpu.ccwfn(wfn, model="CC3",
                                t3_scan=True).solve_cc(1e-12, 1e-12)
        e_rows_b = pycc_tpu.ccwfn(
            wfn, model="CC3", t3_scan=True,
            storage="blocked").solve_cc(1e-12, 1e-12)
    assert abs(e_fused - -0.227888246840310) < 5e-11
    assert abs(e_rows - e_fused) < 1e-13
    assert abs(e_rows_b - e_fused) < 1e-13


def test_cc3_lambda_density_rows_match():
    """Host-orchestrated Lambda-CC3 extras + CC3 one-pdm (per-(i,j) slabs;
    t3_scan=True) equal the fused path through the full user pipeline,
    with and without blocked storage."""
    wfn = scf("H2O_Teach", "cc-pvdz", freeze_core=False)
    res = {}
    for key, kw in (("fused", {}), ("rows", {"t3_scan": True}),
                    ("rows_blk", {"t3_scan": True, "storage": "blocked"})):
        with contextlib.redirect_stdout(io.StringIO()):
            cc = pycc_tpu.ccwfn(wfn, model="CC3", **kw)
            cc.solve_cc(1e-12, 1e-12)
            hbar = pycc_tpu.cchbar(cc)
            lam = pycc_tpu.cclambda(cc, hbar)
            lecc = lam.solve_lambda(1e-12, 1e-12)
            dens = pycc_tpu.ccdensity(cc, lam)
            rt = pycc_tpu.rtcc(cc, lam, dens, None)
            mu_z = complex(rt.dipole(cc.t1, cc.t2, lam.l1, lam.l2)[2]).real
        res[key] = (lecc, mu_z)
    # CFOUR-pinned CC3 dipole oracle (test_009 RT-CC3 geometry)
    for key in ("rows", "rows_blk"):
        assert abs(res[key][0] - res["fused"][0]) < 1e-12, key
        assert abs(res[key][1] - res["fused"][1]) < 1e-12, key


def test_rtcc3_host_stepped_rhs_matches_fused():
    """Host-stepped (per-row dispatch) RT-CC3 RHS == fused one-graph RHS,
    in both complex and re/im-split amplitude modes.
    Reference capability: pycc/tests/test_037_rtcc3.py; the row split
    keeps each dispatch short where the fused one-dispatch T3 scan runs
    for minutes at production sizes."""
    import numpy as np
    from pycc_tpu import ccdensity, cchbar, cclambda, ccwfn, rtcc
    from pycc_tpu.rt.lasers import gaussian_laser
    from .common import scf

    wfn = scf("H2O", "sto-3g", freeze_core=True)

    def build(t3_scan, ri):
        cc = ccwfn(wfn, model="CC3", real_time=True, t3_scan=t3_scan)
        cc.solve_cc(e_conv=1e-10, r_conv=1e-10)
        hb = cchbar(cc)
        lam = cclambda(cc, hb)
        lam.solve_lambda(e_conv=1e-10, r_conv=1e-10)
        dens = ccdensity(cc, lam)
        V = gaussian_laser(0.05, 0.0, 0.01, center=0.05)
        rt = rtcc(cc, lam, dens, V, ri_split=ri)
        y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2,
                             np.array([0.0 + 0.0j]))
        return rt, y0

    rt_ref, y0 = build(False, False)
    assert not rt_ref.host_stepped
    f_ref = rt_ref.f(0.03, y0)

    rt_rows, _ = build(True, False)
    assert rt_rows.host_stepped
    assert np.abs(rt_rows.f(0.03, y0) - f_ref).max() < 1e-12

    rt_ri, _ = build(True, True)
    assert np.abs(rt_ri.f(0.03, y0) - f_ref).max() < 1e-12


def test_rtcc3_host_stepped_local_filter_matches_fused():
    """Local (PNO) RT-CC3: the host-stepped per-row RHS applies the
    pair-space filter exactly like the fused one-graph RHS, in complex
    and re/im-split modes (round-2 advisor finding: the row path used to
    return UNFILTERED residuals for local models)."""
    import numpy as np
    from pycc_tpu import ccdensity, cchbar, cclambda, ccwfn, rtcc
    from pycc_tpu.rt.lasers import gaussian_laser
    from .common import scf

    wfn = scf("H2O", "sto-3g", freeze_core=True)

    def build(t3_scan, ri):
        with contextlib.redirect_stdout(io.StringIO()):
            cc = ccwfn(wfn, model="CC3", real_time=True, t3_scan=t3_scan,
                       local="PNO", local_cutoff=1e-7, filter=True)
            cc.solve_cc(e_conv=1e-10, r_conv=1e-10)
            hb = cchbar(cc)
            lam = cclambda(cc, hb)
            lam.solve_lambda(e_conv=1e-10, r_conv=1e-10)
            dens = ccdensity(cc, lam)
        V = gaussian_laser(0.05, 0.0, 0.01, center=0.05)
        rt = rtcc(cc, lam, dens, V, ri_split=ri)
        y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2,
                             np.array([0.0 + 0.0j]))
        return rt, y0

    rt_ref, y0 = build(False, False)
    assert not rt_ref.host_stepped
    f_ref = rt_ref.f(0.03, y0)

    rt_rows, _ = build(True, False)
    assert rt_rows.host_stepped
    assert np.abs(rt_rows.f(0.03, y0) - f_ref).max() < 1e-12

    rt_ri, _ = build(True, True)
    assert np.abs(rt_ri.f(0.03, y0) - f_ref).max() < 1e-12


def test_cc3_onepdm_rows_chunked_matches_full(monkeypatch):
    """The k-chunk-ASSEMBLED pdm row (the uracil/aug-cc-pVDZ path,
    where the one-shot slab builds exceed 16 GB) equals the
    one-chunk build and the full-tensor pdm; multi-chunk assembly is
    forced here by zeroing the slab-elements threshold."""
    from pycc_tpu.models import cc3 as m
    from pycc_tpu.models.cc3 import cc3_onepdm, cc3_onepdm_rows
    from pycc_tpu.utils import mp2_guess, synthetic_hamiltonian
    H = synthetic_hamiltonian(4, 10, seed=9)
    t1, t2, _ = mp2_guess(H)
    t1 = t1 + 0.01
    l1 = 2.0 * t1
    l2 = 2.0 * (2.0 * t2 - t2.swapaxes(2, 3))

    class CC:
        pass
    cc = CC()
    cc.no, cc.nv, cc.nact, cc.H, cc.model = 4, 10, 14, H, "CC3"
    p1, p2 = cc3_onepdm(cc, t1, t2, l1, l2)
    r1, r2 = cc3_onepdm_rows(cc, t1, t2, l1, l2)
    assert float(abs(p1 - r1).max()) < 1e-13
    assert float(abs(p2 - r2).max()) < 1e-13
    monkeypatch.setattr(m, "_PDM_CHUNK_ELEMS", 0.0)
    c1, c2 = cc3_onepdm_rows(cc, t1, t2, l1, l2)
    assert float(abs(p1 - c1).max()) < 1e-13
    assert float(abs(p2 - c2).max()) < 1e-13
