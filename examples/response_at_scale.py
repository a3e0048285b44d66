"""Response solve_right at (o, v) = (32, 128) on the device.

Round 2 hardened the EOM sigma for this scale but the response equations
had never been RUN on-chip above cc-pVDZ; round 3
consolidated r_X/in_Y1/r_Y onto the pre-laid spin-adapted HBAR
combinations (build_response_aux) — this script captures the wall-clock
of one perturbed-amplitude solve at scale.  Synthetic spectrally-sane
Hamiltonian (bench.py measurement rules).

Matches /root/reference/pycc/ccresponse.py:400-520 (solve_right), which
requires the dense v^4 HBAR blocks Psi4-side and cannot reach this size.

Usage: python examples/response_at_scale.py [--no 32] [--nv 128]
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
    ap.add_argument("--omega", type=float, default=0.0656)
    ap.add_argument("--maxiter", type=int, default=50)
    args = ap.parse_args()
    no, nv = args.no, args.nv
    nact = no + nv

    import jax
    from pycc_tpu.utils import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from pycc_tpu import cchbar, ccresponse

    @jax.jit
    def synth(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        eps = jnp.concatenate([jnp.linspace(-2.0, -0.5, no),
                               jnp.linspace(0.3, 3.0, nv)]).astype(jnp.float32)
        F = jnp.diag(eps) + 0.0005 * jax.random.normal(k1, (nact, nact),
                                                       jnp.float32)
        F = 0.5 * (F + F.T)
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
        mu = 0.1 * jax.random.normal(k4, (3, nact, nact), jnp.float32)
        mu = 0.5 * (mu + jnp.swapaxes(mu, 1, 2))
        blocks = blocks_from_full(ERI, no)
        return F, blocks, t1, t2, mu

    from pycc_tpu.models.blocked import blocks_from_full

    print("synthesizing (o,v)=(%d,%d) blocked H on device..." % (no, nv))
    sys.stdout.flush()
    F, blocks, t1, t2, mu = synth(jax.random.PRNGKey(11))
    jax.block_until_ready(F)

    # blocked storage: the six Dirac blocks take far less device memory
    # than dense ERI+L beside the 11 HBAR blocks, and ccresponse assembles its oovv slices from them on device
    H = SimpleNamespace(F=F, mu=mu, m=mu, p=mu, Q=jnp.stack([mu[0]] * 6))
    cc = SimpleNamespace(storage="blocked", blocks=blocks, model="CCSD",
                         local=None, mesh=None, no=no, nv=nv, t1=t1, t2=t2,
                         H=H, o=slice(0, no), v=slice(no, nact))

    t0 = time.time()
    hb = cchbar(cc)
    t_hbar = time.time() - t0
    print("HBAR wall: %.1f s" % t_hbar)
    sys.stdout.flush()

    ccd = SimpleNamespace(ccwfn=cc, cclambda=SimpleNamespace(hbar=hb))
    t0 = time.time()
    resp = ccresponse(ccd)
    print("ccresponse init (pertbar x21 + pre-laid aux): %.1f s"
          % (time.time() - t0))
    sys.stdout.flush()

    t0 = time.time()
    X1, X2, pr = resp.solve_right(resp.pertbar["MU_Z"], args.omega,
                                  e_conv=1e-6, r_conv=1e-6,
                                  maxiter=args.maxiter)
    t_x = time.time() - t0
    # pr is a HOST python complex
    ok = bool(np.isfinite(pr.real))
    print(json.dumps({
        "config": "(%d,%d) f32 solve_right MU_Z omega=%.4f" % (no, nv,
                                                               args.omega),
        "pseudoresponse": pr.real,
        "finite": ok,
        "t_hbar_s": round(t_hbar, 1),
        "t_solve_right_s": round(t_x, 1),
    }))


if __name__ == "__main__":
    main()
