"""pycc_tpu: a coupled-cluster framework in JAX (XLA, GSPMD sharding).

A ground-up rebuild of the capabilities of jattakumi/pycc (RHF-based CCD /
CC2 / CCSD / CCSD(T) / CC3 energies, Lambda amplitudes, densities, EOM-CCSD,
linear response, real-time propagation, local correlation) for an
accelerator: jitted dot_general contraction graphs, on-device
DIIS/Davidson/RK solvers, and GSPMD mesh sharding for the v^4 tensors.  The reference's Psi4 integral layer is replaced by a native
host-side SCF engine (pycc_tpu.scf).
"""

import jax

# Double precision is required to hit the 1e-11 energy oracles of the
# reference suite; perf paths downcast explicitly (precision='SP' / bf16).
jax.config.update("jax_enable_x64", True)

from . import scf
from .hamiltonian import Hamiltonian
from .ccwfn import ccwfn
from .cchbar import cchbar
from .cclambda import cclambda
from .ccdensity import ccdensity
from .cceom import cceom
from .ccresponse import ccresponse, pertbar
from .rt.rtcc import rtcc
from .utils.log import set_verbosity

__all__ = ["scf", "Hamiltonian", "ccwfn", "cchbar", "cclambda", "ccdensity",
           "cceom", "ccresponse", "pertbar", "rtcc", "set_verbosity"]

__version__ = "0.1.0"
