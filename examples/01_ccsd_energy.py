"""CCSD/cc-pVDZ energy of water — the canonical pipeline."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
jax.config.update("jax_platforms", "cpu")  # drop this line to run on a GPU

import pycc_tpu
from pycc_tpu.data import moldict

wfn = pycc_tpu.scf.run_rhf(moldict["H2O"], "cc-pvdz", freeze_core=True)
cc = pycc_tpu.ccwfn(wfn)
ecc = cc.solve_cc(e_conv=1e-10, r_conv=1e-10)
print("E(SCF)  =", wfn.energy())
print("E(CCSD) =", ecc)
