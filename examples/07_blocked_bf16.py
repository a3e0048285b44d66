"""At-scale usage: blocked Hamiltonian storage + bf16-gated solve +
memory-scaling CCSD(T) density.

`storage="blocked"` keeps the dense nact^4 ERI/L on the host and ships only
the six unique Dirac blocks to the device (~5.6x less device memory);
`bf16_until` runs the early residual contractions in bfloat16 and hands
over to full precision automatically; `t3_scan=True` computes the (T) correction and its full
density from per-(i,j) T3 slabs (O(no v^3) working set) so the no^3 nv^3
tensor never exists.

Runs on the GPU (default backend) or the CPU alike.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import pycc_tpu

GEOM = """
O
H 1 1.1
H 1 1.1 2 104
symmetry c1
"""

wfn = pycc_tpu.scf.run_rhf(GEOM, "cc-pvdz", freeze_core=True)
cc = pycc_tpu.ccwfn(wfn, model="ccsd(t)", storage="blocked",
                    make_t3_density=True, t3_scan=True)
ecc = cc.solve_cc(1e-10, 1e-10, bf16_until=1e-3)
print("CCSD(T) Ecorr = %.12f" % ecc)
print("E(total)      = %.12f" % (ecc + wfn.energy()))
