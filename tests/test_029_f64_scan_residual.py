"""The f64-at-scale DF-CCSD residual/energy formulations.

A backend that emulates f64 materializes every f64 dot OUTPUT as a
widened multi-slice f32 accumulator (~8x the natural f64 bytes).  The
scan residual
(models/dfccsd.residuals_ccsd_df_scan) and the quadratic-form energy
(cc_energy_df_qf, with the broadcast _tau) keep every dot output a
row/block slab so the f64 refinement stage of solve_cc_mixed compiles
at (40,360).  These oracles pin the formulations to the fused ones.

Reference equations: /root/reference/pycc/ccwfn.py:331-622 (exists only
in f64 and only as far as the dense nact^4 ERI reaches,
/root/reference/pycc/hamiltonian.py:36-39).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pycc_tpu.models.dfccsd import (DFERI, cc_energy_df, cc_energy_df_qf,
                                    residuals_ccsd_df,
                                    residuals_ccsd_df_scan)


def _rand_problem(no=4, nv=6, naux=30, seed=7):
    rng = np.random.default_rng(seed)
    n = no + nv
    B = rng.standard_normal((naux, n, n)) * 0.1
    B = 0.5 * (B + B.transpose(0, 2, 1))
    df = DFERI(Boo=jnp.asarray(B[:, :no, :no]),
               Bov=jnp.asarray(B[:, :no, no:]),
               Bvv=jnp.asarray(B[:, no:, no:]))
    F = rng.standard_normal((n, n))
    F = jnp.asarray(0.5 * (F + F.T))
    t1 = jnp.asarray(rng.standard_normal((no, nv)) * 0.05)
    t2 = rng.standard_normal((no, no, nv, nv)) * 0.05
    t2 = jnp.asarray(t2 + t2.transpose(1, 0, 3, 2))
    return F, df, t1, t2, no


def test_scan_residual_equals_fused():
    F, df, t1, t2, no = _rand_problem()
    r1a, r2a = residuals_ccsd_df(F, df, t1, t2, no)
    r1b, r2b = residuals_ccsd_df_scan(F, df, t1, t2, no)
    assert float(jnp.max(jnp.abs(r1a - r1b))) < 1e-13
    assert float(jnp.max(jnp.abs(r2a - r2b))) < 1e-13


def test_scan_residual_chunked_equals_fused():
    """HOST-level chunking of the i-scan and the ladder grid (short
    dispatches) must not change the result, including a padded tail grid
    chunk."""
    F, df, t1, t2, no = _rand_problem(seed=11)
    r1a, r2a = residuals_ccsd_df(F, df, t1, t2, no)
    r1b, r2b = residuals_ccsd_df_scan(F, df, t1, t2, no,
                                      nchunks=2, grid_chunks=5)
    assert float(jnp.max(jnp.abs(r1a - r1b))) < 1e-13
    assert float(jnp.max(jnp.abs(r2a - r2b))) < 1e-13


def test_scan_residual_repeat_calls():
    """Repeated calls (the solver loop pattern; the oovv assembly is
    rebuilt and freed inside each call — liveness scheduling) stay
    exactly equal to the fused form at changing amplitudes."""
    F, df, t1, t2, no = _rand_problem(seed=3)
    cache = {}
    residuals_ccsd_df_scan(F, df, t1, t2, no, cache=cache)
    t1b, t2b = 0.7 * t1, 1.3 * t2
    r1a, r2a = residuals_ccsd_df(F, df, t1b, t2b, no)
    r1b, r2b = residuals_ccsd_df_scan(F, df, t1b, t2b, no, cache=cache)
    assert float(jnp.max(jnp.abs(r1a - r1b))) < 1e-13
    assert float(jnp.max(jnp.abs(r2a - r2b))) < 1e-13


def test_qf_energy_equals_assembled():
    F, df, t1, t2, no = _rand_problem(seed=5)
    ea = cc_energy_df(F, df, t1, t2, no)
    eq = cc_energy_df_qf(F, df, t1, t2, no)
    assert abs(float(ea) - float(eq)) < 1e-13
    # CCD form (tau = t2, no F.t1 term)
    eccd_a = cc_energy_df(F, df, jnp.zeros_like(t1), t2, no)
    eccd_q = cc_energy_df_qf(F, df, jnp.zeros_like(t1), t2, no,
                             with_t1=False)
    assert abs(float(eccd_a) - float(eccd_q)) < 1e-13


def test_split_grid_ladder_equals_fused(monkeypatch):
    """Past the BL-copy HBM wall the split residual swaps _rs_ladder for
    the grid ladder + rank-1 seed term; forced here by lowering the
    byte threshold.  Must be exactly the fused result."""
    from pycc_tpu.models import dfccsd
    from pycc_tpu.models.dfccsd import residuals_ccsd_df_split
    F, df, t1, t2, no = _rand_problem(seed=13)
    r1a, r2a = residuals_ccsd_df(F, df, t1, t2, no)
    monkeypatch.setattr(dfccsd, "_GRID_LADDER_BYTES", 0.0)
    r1b, r2b = residuals_ccsd_df_split(F, df, t1, t2, no)
    assert float(jnp.max(jnp.abs(r1a - r1b))) < 1e-13
    assert float(jnp.max(jnp.abs(r2a - r2b))) < 1e-13


def test_scan_residual_multiwindow_equals_fused(monkeypatch):
    """Force multi-window ring chunks (mc < no) and multi-chunk slabs at
    tiny size — at the default budgets a tiny problem runs mc == no and
    window-slicing bugs are invisible (one escaped to the w10 probes
    this way)."""
    from pycc_tpu.models import dfccsd as m
    F, df, t1, t2, no = _rand_problem(seed=21)
    r1a, r2a = residuals_ccsd_df(F, df, t1, t2, no)
    monkeypatch.setattr(m, "_SLAB", 64)
    r1b, r2b = residuals_ccsd_df_scan(F, df, t1, t2, no)
    assert float(jnp.max(jnp.abs(r1a - r1b))) < 1e-13
    assert float(jnp.max(jnp.abs(r2a - r2b))) < 1e-13
