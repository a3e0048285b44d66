"""CCSD dynamic polarizability vs frozen Psi4 values (test_036_lr.py:75-83).

Also exercises the aug-cc-pVDZ basis data, the dipole integrals, and Psi4's
canonical C2v orientation (frame-dependent tensor components).
"""

import contextlib
import io

import numpy as np
import pycc_tpu
from .common import scf


def test_linresp_polarizability():
    wfn = scf("H2O", "aug-cc-pvdz", freeze_core=False)
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(wfn)
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu.cchbar(cc)
        lam = pycc_tpu.cclambda(cc, hbar)
        lam.solve_lambda(1e-12, 1e-12)
        dens = pycc_tpu.ccdensity(cc, lam)
        resp = pycc_tpu.ccresponse(dens)
        omega = 0.0656
        # full 3x3 dynamic polarizability via the one-call driver (the
        # reference's linresp is broken; test_036_lr.py assembles by hand)
        tensor = resp.linresp("MU", "MU", omega)
        polar = np.diag(tensor)

    assert abs(polar[0] - 9.92992070420665) < 1e-8
    assert abs(polar[1] - 13.443740151331559) < 1e-8
    assert abs(polar[2] - 11.342765745046526) < 1e-8
    assert abs(np.mean(polar) - 11.572142200333) < 1e-8
    # off-diagonal elements vanish by C2v symmetry in this frame
    assert np.abs(tensor - np.diag(polar)).max() < 1e-6


def test_conditioning_probe_and_warning():
    """estimate_conditioning discriminates a genuinely near-pole omega
    (within ~1e-3 of the lowest EOM root) from a well-conditioned one,
    and solve_right warns exactly at the near-pole frequency (a runtime
    signal, not just a docstring).  The reference
    has no conditioning diagnostics (ccresponse.py:336-467)."""
    import warnings as _w
    from types import SimpleNamespace
    wfn = scf("H2O", "sto-3g")
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(wfn)
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu.cchbar(cc)
        lam = pycc_tpu.cclambda(cc, hbar)
        lam.solve_lambda(1e-12, 1e-12)
        eom = pycc_tpu.cceom(hbar)
        E, _ = eom.solve_eom(N=1, e_conv=1e-10, r_conv=1e-8)
        resp = pycc_tpu.ccresponse(SimpleNamespace(ccwfn=cc,
                                                   cclambda=lam))
        e0 = float(np.asarray(E)[0])

        sig_pole = resp.estimate_conditioning(e0 - 1e-3)
        sig_ok = resp.estimate_conditioning(0.0656)
        assert sig_pole < 1e-2, sig_pole       # near-singular detected
        assert sig_ok > 1e-1, sig_ok           # healthy spectrum

        # the warning fires at the pole...
        with _w.catch_warnings(record=True) as rec:
            _w.simplefilter("always")
            resp.solve_right(resp.pertbar["MU_X"], e0 - 1e-3,
                             e_conv=1e-10, r_conv=1e-10)
        assert any("near-singular" in str(r.message) for r in rec), \
            [str(r.message) for r in rec]
        # ...and is silent at the well-conditioned frequency
        with _w.catch_warnings(record=True) as rec:
            _w.simplefilter("always")
            resp.solve_right(resp.pertbar["MU_X"], 0.0656,
                             e_conv=1e-10, r_conv=1e-10)
        assert not any("near-singular" in str(r.message) for r in rec), \
            [str(r.message) for r in rec]
