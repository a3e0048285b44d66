"""EOM-CCSD Davidson vs dense diagonalization of the EOM matrix.

The reference validates against an in-test `psi4.energy('eom-ccsd')`
(test_035_eomccsd.py:56-62); without Psi4 in this environment the oracle is
the dense eigenspectrum of the same HBAR-sigma operator (exact for the
Davidson solver), checked for all three guess types.
"""

import contextlib
import io

import numpy as np
import pycc_tpu
from .common import scf


def test_eom_ccsd_h2o_sto3g():
    wfn = scf("H2O", "sto-3g", freeze_core=False)
    cc = pycc_tpu.ccwfn(wfn)
    with contextlib.redirect_stdout(io.StringIO()):
        cc.solve_cc(e_conv=1e-12, r_conv=1e-12)
        hbar = pycc_tpu.cchbar(cc)
    eom = pycc_tpu.cceom(hbar)

    A = eom.dense_matrix()
    ev = np.linalg.eigvals(A)
    ev = np.sort(np.real(ev[np.abs(np.imag(ev)) < 1e-6]))
    ev = ev[ev > 1e-6][:3]

    for g in ("HBAR_SS", "CIS", "UNIT"):
        with contextlib.redirect_stdout(io.StringIO()):
            E, C = eom.solve_eom(N=3, e_conv=1e-7, guess=g)
        assert np.allclose(E, ev, atol=1e-5), (g, E, ev)

    # the big-system sequential-sigma path (host-streamed vectors +
    # hoisted quartered Hvvvv ladder) must give the same roots, and must
    # survive releasing the dense Hvvvv/Hvovv/Hvvvo blocks it never
    # touches (the at-scale residency mode, examples/eom_at_scale.py)
    eom.sigma_sequential = True
    eom.release_dense_hbar()
    with contextlib.redirect_stdout(io.StringIO()):
        E, C = eom.solve_eom(N=3, e_conv=1e-7, guess="CIS",
                             device_subspace=False)
    assert np.allclose(E, ev, atol=1e-5), (E, ev)

    # the device-resident Davidson (subspace C/S on device, only M x M
    # matrices crossing the host boundary) must find the same roots
    with contextlib.redirect_stdout(io.StringIO()):
        E, C = eom.solve_eom(N=3, e_conv=1e-7, guess="CIS",
                             device_subspace=True)
    assert np.allclose(E, ev, atol=1e-5), (E, ev)


def _solve_eom_dz(freeze_core):
    wfn = scf("H2O", "cc-pvdz", freeze_core=freeze_core)
    cc = pycc_tpu.ccwfn(wfn)
    with contextlib.redirect_stdout(io.StringIO()):
        cc.solve_cc(e_conv=1e-12, r_conv=1e-12)
        hbar = pycc_tpu.cchbar(cc)
        eom = pycc_tpu.cceom(hbar)
        E, C = eom.solve_eom(N=3, e_conv=1e-9, r_conv=1e-7)
    return eom, E, C


def test_eom_ccsd_h2o_ccpvdz_frozen_core():
    """cc-pVDZ frozen-core roots: frozen regression values, certified
    against the dense EOM eigenspectrum (5852-dim) offline; residual-gated
    convergence must hold."""
    eom, E, C = _solve_eom_dz(freeze_core=True)
    assert eom.converged
    ref = np.array([0.246365746068, 0.313591867750, 0.354390071110])
    assert np.allclose(E, ref, atol=1e-7), E
    # per-root residual norms actually meet r_conv
    import jax.numpy as jnp
    S = np.asarray(eom._sigma(jnp.asarray(C)))
    G = C @ S.T
    w, a = np.linalg.eig(G)
    idx = np.real(w).argsort()[:3]
    r = np.real(a[:, idx]).T @ S - np.diag(np.real(w[idx])) @ np.real(a[:, idx]).T @ C
    assert np.linalg.norm(r, axis=1).max() < 1e-6


def test_eom_ccsd_h2o_ccpvdz_all_electron():
    """All-electron variant: core correlation shifts the roots by ~4e-5."""
    eom, E, _ = _solve_eom_dz(freeze_core=False)
    assert eom.converged
    ref = np.array([0.246401542284, 0.313632702320, 0.354376313732])
    assert np.allclose(E, ref, atol=1e-7), E
