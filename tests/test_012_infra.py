"""Infrastructure tests: sharding dry-run, checkpoint utils, synthetic
systems, moldict data."""

import numpy as np
import jax
import jax.numpy as jnp

import pycc_tpu
from pycc_tpu.data import moldict
from pycc_tpu.utils import (load_amps, mp2_guess, save_amps,
                            synthetic_hamiltonian)


def test_dryrun_multichip_8():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_sharded_ccsd_step_matches_single_device():
    from pycc_tpu.models import ccsd as eqs
    from pycc_tpu.parallel import make_mesh, shard_amps, shard_hamiltonian
    H = synthetic_hamiltonian(4, 16, seed=3)
    t1, t2, Dijab = mp2_guess(H)
    no = H.no
    r1_ref, r2_ref = eqs.residuals_ccsd(H.F, H.ERI, H.L, t1, t2, no)

    mesh = make_mesh(n_devices=8)
    Hs = shard_hamiltonian(H, mesh)
    t1s, t2s = shard_amps(t1, t2, mesh)
    r1, r2 = jax.jit(
        lambda F, E, L, a, b: eqs.residuals_ccsd(F, E, L, a, b, no)
    )(Hs.F, Hs.ERI, Hs.L, t1s, t2s)
    assert np.allclose(np.asarray(r1), np.asarray(r1_ref), atol=1e-12)
    assert np.allclose(np.asarray(r2), np.asarray(r2_ref), atol=1e-12)


def test_checkpoint_roundtrip(tmp_path):
    H = synthetic_hamiltonian(2, 4, seed=1)
    t1, t2, _ = mp2_guess(H)
    p = str(tmp_path / "amps.npz")
    save_amps(p, t1=t1, t2=t2)
    amps = load_amps(p)
    assert np.allclose(amps["t1"], np.asarray(t1))
    assert np.allclose(amps["t2"], np.asarray(t2))


def test_moldict_data():
    assert "H2O" in moldict and "benzene" in moldict
    from pycc_tpu.scf import Molecule
    m = Molecule(moldict["H2O"])
    assert m.natom == 3


def test_fused_solver_matches():
    from .common import scf
    import contextlib, io
    wfn = scf("H2O", "sto-3g")
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(wfn)
        e = cc.solve_cc_fused(1e-12, 1e-12)
    assert abs(e - -0.070616830152761) < 1e-11


def test_mixed_precision_solver():
    from .common import scf
    import contextlib, io
    wfn = scf("H2O", "sto-3g")
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(wfn)
        e = cc.solve_cc_mixed(1e-12, 1e-12)
    assert abs(e - -0.070616830152761) < 1e-11


def test_mesh_integrated_solve_matches_single_device():
    """ccwfn(..., mesh=...): the FULL iteration loop (solve_cc with DIIS),
    HBAR, Lambda, and an EOM Davidson solve run SPMD over an 8-device mesh
    and agree with the single-device path (SURVEY §7.11 integration; the
    reference's only multi-device mechanism is a host<->GPU offload,
    /root/reference/pycc/ccwfn.py:205-229)."""
    import contextlib
    import io

    from .common import scf
    from pycc_tpu.parallel import make_mesh

    wfn = scf("H2O", "cc-pvdz", freeze_core=True)
    with contextlib.redirect_stdout(io.StringIO()):
        cc0 = pycc_tpu.ccwfn(wfn)
        e0 = cc0.solve_cc(e_conv=1e-11, r_conv=1e-11)

        mesh = make_mesh(n_devices=8)
        cc1 = pycc_tpu.ccwfn(wfn, mesh=mesh)
        e1 = cc1.solve_cc(e_conv=1e-11, r_conv=1e-11)
    assert abs(float(e0) - float(e1)) < 1e-11
    assert abs(float(e1) - -0.222029814166783) < 1e-10

    with contextlib.redirect_stdout(io.StringIO()):
        hb0 = pycc_tpu.cchbar(cc0)
        lam0 = pycc_tpu.cclambda(cc0, hb0)
        l0 = lam0.solve_lambda(e_conv=1e-10, r_conv=1e-10)
        hb1 = pycc_tpu.cchbar(cc1)
        lam1 = pycc_tpu.cclambda(cc1, hb1)
        l1 = lam1.solve_lambda(e_conv=1e-10, r_conv=1e-10)
    assert abs(float(l0) - float(l1)) < 1e-10

    # sharded EOM Davidson: same roots from the sharded HBAR
    with contextlib.redirect_stdout(io.StringIO()):
        eom1 = pycc_tpu.cceom(hb1)
        E1, _ = eom1.solve_eom(N=2, e_conv=1e-8, r_conv=1e-6)
        eom0 = pycc_tpu.cceom(hb0)
        E0, _ = eom0.solve_eom(N=2, e_conv=1e-8, r_conv=1e-6)
    assert eom1.converged
    assert np.allclose(E1, E0, atol=1e-7)


def test_mesh_df_solve_matches():
    """storage='df' + mesh: the sharded-factor iteration equals the
    single-device DF solve bit-for-bit targets (1e-12)."""
    import contextlib
    import io

    from .common import scf
    from pycc_tpu.parallel import make_mesh

    wfn = scf("H2O", "sto-3g", freeze_core=True)
    with contextlib.redirect_stdout(io.StringIO()):
        cc0 = pycc_tpu.ccwfn(wfn, storage="df", df_tol=1e-11)
        e0 = cc0.solve_cc(e_conv=1e-11, r_conv=1e-11)
        cc1 = pycc_tpu.ccwfn(wfn, storage="df", df_tol=1e-11,
                             mesh=make_mesh(n_devices=8))
        e1 = cc1.solve_cc(e_conv=1e-11, r_conv=1e-11)
    assert abs(float(e0) - float(e1)) < 1e-12
