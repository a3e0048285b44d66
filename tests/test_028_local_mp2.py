"""DLPNO-MP2: the transformed-basis pair loop and the filter-based
simulation path (reference counterparts: the experimental, never-invoked
``_local_MP2_loop`` / ``_sim_MP2_loop``, /root/reference/pycc/local.py:
638-787).  Oracles are the method pair testing each other — the projected
fixed points are analytically identical — plus exactness at cutoff=0,
where both must recover the full (Hylleraas-converged) MP2 energy in the
localized-occupied basis.
"""

import contextlib
import io

import numpy as np
import pycc_tpu
from .common import scf


def _local(cutoff, kind="PNO"):
    wfn = scf("H2O", "sto-3g", freeze_core=False)
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(wfn, local=kind, local_cutoff=cutoff,
                            it2_opt=False, filter=True)
    return cc.Local


def test_local_mp2_complete_space_exact():
    """cutoff=0: the pair spaces are complete, so the DLPNO-MP2 energy is
    the exact MP2 energy — compare against the Hylleraas loop that the
    PNO build itself uses (orbital-invariant fixed point)."""
    lo = _local(0.0)
    with contextlib.redirect_stdout(io.StringIO()):
        lo.it2_opt = True
        t2 = lo._mp2_t2()
        no, nv = lo.no, lo.nv
        L = np.asarray(lo.H.L)[:no, :no, no:no + nv, no:no + nv]
        e_ref = float(np.einsum("ijab,ijab->", np.asarray(t2), L))
        emp2, e_pair, _ = lo.local_mp2(e_conv=1e-12, r_conv=1e-10)
    assert abs(emp2 - e_ref) < 1e-10
    assert abs(float(e_pair.sum()) - emp2) < 1e-12


def test_local_mp2_equals_sim_truncated():
    """Truncated spaces (cutoff=1e-6): the transformed-basis loop and the
    full-space filtered simulation converge to the SAME projected fixed
    point, and the truncation really dropped functions."""
    lo = _local(1e-6)
    assert int(np.asarray(lo.dim).min()) < lo.nv  # truncation is real
    with contextlib.redirect_stdout(io.StringIO()):
        e_loc, e_pair, _ = lo.local_mp2(e_conv=1e-12, r_conv=1e-10)
        e_sim, _ = lo.sim_mp2(e_conv=1e-12, r_conv=1e-10)
    assert abs(e_loc - e_sim) < 1e-10
    # pair-energy matrix is symmetric (hermitian pair equations)
    assert np.abs(e_pair - e_pair.T).max() < 1e-10


def test_local_mp2_pao():
    """PAO spaces through the same machinery."""
    lo = _local(0.02, kind="PAO")
    with contextlib.redirect_stdout(io.StringIO()):
        e_loc, _, _ = lo.local_mp2(e_conv=1e-12, r_conv=1e-10)
        e_sim, _ = lo.sim_mp2(e_conv=1e-12, r_conv=1e-10)
    assert abs(e_loc - e_sim) < 1e-10


def test_local_mp2_pair_energies_vs_hylleraas():
    """Pair-LEVEL oracle: at cutoff=0 every DLPNO-MP2
    pair energy e_pair[i,j] must equal the Hylleraas pair energy
    sum_ab t2[i,j] * L[i,j] from the full-space loop the PNO build uses
    — not just the total.  Reference anchor: the pair loop of
    _local_MP2_loop (/root/reference/pycc/local.py:700-787)."""
    lo = _local(0.0)
    with contextlib.redirect_stdout(io.StringIO()):
        lo.it2_opt = True
        t2 = np.asarray(lo._mp2_t2())
        no, nv = lo.no, lo.nv
        L = np.asarray(lo.H.L)[:no, :no, no:no + nv, no:no + nv]
        e_pair_ref = np.einsum("ijab,ijab->ij", t2, L)
        _, e_pair, _ = lo.local_mp2(e_conv=1e-12, r_conv=1e-10)
    assert np.abs(e_pair - e_pair_ref).max() < 1e-10


def test_local_mp2_pnopp():
    """PNO++ spaces (perturbation-weighted densities) through the same
    machinery: transformed-basis loop == filtered simulation, and the
    truncated total sits below the complete-space (exact MP2) total in
    magnitude while recovering >98% of it."""
    lo = _local(1e-7, kind="PNO++")
    assert int(np.asarray(lo.dim).min()) < lo.nv
    with contextlib.redirect_stdout(io.StringIO()):
        e_loc, e_pair, _ = lo.local_mp2(e_conv=1e-12, r_conv=1e-10)
        e_sim, _ = lo.sim_mp2(e_conv=1e-12, r_conv=1e-10)
        lo0 = _local(0.0, kind="PNO++")
        e_full, _, _ = lo0.local_mp2(e_conv=1e-12, r_conv=1e-10)
    assert abs(e_loc - e_sim) < 1e-10
    assert np.abs(e_pair - e_pair.T).max() < 1e-10
    assert abs(e_loc) < abs(e_full) + 1e-12
    assert abs(e_loc - e_full) < 0.02 * abs(e_full)
