"""Real-time CCSD with real/imag-split amplitudes.

`rtcc(..., ri_split=True)` carries the amplitudes as (re, im) real pairs
(ops/ctensor.py) and lowers every complex contraction to three real
dot_generals — bit-identical trajectories to the complex path, for a
backend without complex arithmetic.  The default (ri_split=False) runs
complex128 directly.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pycc_tpu
from pycc_tpu.rt.integrators import rk4
from pycc_tpu.rt.lasers import gaussian_laser

GEOM = """
O
H 1 1.1
H 1 1.1 2 104
symmetry c1
"""

wfn = pycc_tpu.scf.run_rhf(GEOM, "sto-3g", freeze_core=False)
cc = pycc_tpu.ccwfn(wfn)
cc.solve_cc(1e-12, 1e-12)
hbar = pycc_tpu.cchbar(cc)
lam = pycc_tpu.cclambda(cc, hbar)
lam.solve_lambda(1e-12, 1e-12)
dens = pycc_tpu.ccdensity(cc, lam)

V = gaussian_laser(0.05, 0, 0.01, center=0.05)
rt = pycc_tpu.rtcc(cc, lam, dens, V, ri_split=True)

y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).astype("complex128")
t, h = 0.0, 0.02
print("   t        Re mu_z")
for step in range(10):
    y = rk4(h)(rt.f, t, y)
    t += h
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    mu_z = rt.dipole(t1, t2, l1, l2)[2]
    print("%6.2f  %14.10f" % (t, complex(mu_z).real))
