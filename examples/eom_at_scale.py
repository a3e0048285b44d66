"""End-to-end EOM-CCSD Davidson at (o, v) = (32, 128) on the device.

The at-scale sigma machinery (cceom.py: per-vector host-sequenced
dispatches, pre-laid 2-D HBAR forms, half-K ladder splits) was built in
round 2 but the full Davidson wall-clock was never captured — the number
this script produces.  Synthetic-but-spectrally-sane Hamiltonian (same
operator-norm rules as bench.py): the timing exercises exactly the
device programs a real 160-orbital molecule would run.

Matches the reference driver at /root/reference/pycc/cceom.py:56-184,
which cannot represent this size (dense ERI+L already ~5 GB; Psi4
HBAR route materializes v^4 on one node).

Usage:  python examples/eom_at_scale.py [--no 32] [--nv 128] [--roots 3]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd
import time
from types import SimpleNamespace


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no", type=int, default=32)
    ap.add_argument("--nv", type=int, default=128)
    ap.add_argument("--roots", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=40)
    # CIS by default at this size: the HBAR_SS guess runs a HOST
    # np.linalg.eig of the dense (no*nv)^2 nonsymmetric singles block,
    # tens of minutes on one core; CIS is a symmetric eigh.
    ap.add_argument("--guess", default="CIS")
    args = ap.parse_args()
    no, nv = args.no, args.nv
    nact = no + nv

    import jax
    from pycc_tpu.utils import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from pycc_tpu import cchbar, cceom

    @jax.jit
    def synth(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        eps = jnp.concatenate([jnp.linspace(-2.0, -0.5, no),
                               jnp.linspace(0.3, 3.0, nv)]).astype(jnp.float32)
        F = jnp.diag(eps) + 0.0005 * jax.random.normal(k1, (nact, nact),
                                                       jnp.float32)
        F = 0.5 * (F + F.T)
        # 1/v keeps the synthetic ladder norm below the denominator floor
        # (bench.py measurement rules)
        A = (0.05 / nv) * jax.random.normal(k2, (nact,) * 4, jnp.float32)
        A = A + jnp.transpose(A, (1, 0, 2, 3))
        A = A + jnp.transpose(A, (0, 1, 3, 2))
        A = A + jnp.transpose(A, (2, 3, 0, 1))
        ERI = jnp.swapaxes(A, 1, 2)
        L = 2.0 * ERI - jnp.swapaxes(ERI, 2, 3)
        eps = jnp.diag(F)
        Dijab = (eps[:no, None, None, None] + eps[None, :no, None, None]
                 - eps[None, None, no:, None] - eps[None, None, None, no:])
        t2 = ERI[:no, :no, no:, no:] / Dijab
        t1 = 0.01 * jax.random.normal(k3, (no, nv), jnp.float32)
        blocks = blocks_from_full(ERI, no)
        return F, blocks, t1, t2

    from pycc_tpu.models.blocked import blocks_from_full

    print("synthesizing (o,v)=(%d,%d) blocked H on device..." % (no, nv))
    sys.stdout.flush()
    F, blocks, t1, t2 = synth(jax.random.PRNGKey(7))
    jax.block_until_ready(F)

    # duck-typed ccwfn with blocked storage: the six Dirac blocks +
    # block-native HBAR take far less device memory than dense ERI+L
    cc = SimpleNamespace(storage="blocked", blocks=blocks, model="CCSD",
                         local=None, mesh=None, no=no, nv=nv, t1=t1, t2=t2,
                         H=SimpleNamespace(F=F))

    t0 = time.time()
    hb = cchbar(cc)
    t_hbar = time.time() - t0
    print("HBAR wall: %.1f s" % t_hbar)
    sys.stdout.flush()

    t0 = time.time()
    eom = cceom(hb)
    # nothing downstream consumes the dense HBAR here — drop the
    # Hvvvv/Hvovv/Hvvvo originals (the sigma runs from the pre-laid aux
    # forms); keeping them resident runtime-OOM'd the ladder dispatch
    eom.release_dense_hbar()
    print("cceom init (pre-laid aux forms): %.1f s  sequential=%s"
          % (time.time() - t0, eom.sigma_sequential))
    sys.stdout.flush()

    t0 = time.time()
    E, C = eom.solve_eom(N=args.roots, e_conv=1e-5, r_conv=1e-5,
                         maxiter=args.maxiter, guess=args.guess)
    t_dav = time.time() - t0
    ok = bool(np.all(np.isfinite(E)))
    print(json.dumps({
        "config": "(%d,%d) f32 dense->HBAR, sequential sigma, %s guess"
                  % (no, nv, args.guess),
        "roots": [float(x) for x in np.asarray(E)],
        "finite": ok,
        "t_hbar_s": round(t_hbar, 1),
        "t_davidson_s": round(t_dav, 1),
    }))


if __name__ == "__main__":
    main()
