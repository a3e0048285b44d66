"""Benzene/cc-pVDZ PNO-CCSD with the genuinely local-scaling native solver.

Demonstrates the local-correlation machinery at a 114-basis-function system:
the per-iteration cost of lccwfn's batched pair-space equations depends on
the truncated PNO dimension (a handful of functions per pair), not on the
99 canonical virtuals.  Note: C's cc-pVDZ contraction digits are demo-grade
(see pycc_tpu/scf/basis.py), so energies here are not oracle-comparable.
"""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import time

import jax
jax.config.update("jax_platforms", "cpu")  # drop to run on a GPU

import pycc_tpu
from pycc_tpu.data import moldict

t0 = time.time()
wfn = pycc_tpu.scf.run_rhf(moldict["benzene"], "cc-pvdz", freeze_core=True)
print("SCF %.8f  (%.0fs, nbf=%d)" % (wfn.energy(), time.time() - t0, wfn.nmo()))

cc = pycc_tpu.ccwfn(wfn, local="PNO", local_cutoff=1e-4, it2_opt=False)
print("avg PNO dim %.1f of nv=%d" % (float(cc.Local.dim.mean()), cc.nv))

t0 = time.time()
ecc = cc.lccwfn.solve_lcc(1e-7, 1e-7, maxiter=50)
print("PNO-CCSD Ecorr = %.10f  (%.0fs)" % (ecc, time.time() - t0))
