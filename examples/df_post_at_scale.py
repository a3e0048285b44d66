"""The FULL post-convergence stack at the north-star scale, from factors.

Round 2's headline was an amplitude iteration; rounds 3 added DF-HBAR,
DF-Lambda, DF-EOM and DF-response over dressed Cholesky factors
(models/dfhbar.py, models/dfresponse.py).  This script drives all four at
(o, v) = (32, 512), naux = 1632 — a 544-basis-function system whose dense
ERI (~1.4 TB) the reference cannot even represent
(/root/reference/pycc/hamiltonian.py:36-39, cchbar.py:170-327) — and
records the wall-clock of each stage.  Synthetic spectrally-sane factors
(bench.py measurement rules: uniform draws scaled 1/sqrt(v), diagonal-
dominant F); every stage ends in a finite-checked device fetch.

Usage: python examples/df_post_at_scale.py [--no 32] [--nv 512]
       [--naux 1632] [--roots 3]
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no", type=int, default=32)
    ap.add_argument("--nv", type=int, default=512)
    ap.add_argument("--naux", type=int, default=1632)
    ap.add_argument("--roots", type=int, default=3)
    ap.add_argument("--cc-iters", type=int, default=4)
    ap.add_argument("--lambda-iters", type=int, default=3)
    ap.add_argument("--eom-maxiter", type=int, default=25)
    ap.add_argument("--resp-maxiter", type=int, default=25)
    args = ap.parse_args()
    no, nv, naux = args.no, args.nv, args.naux
    nact = no + nv

    import jax
    from pycc_tpu.utils import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from pycc_tpu import ccwfn, cchbar, cclambda, cceom, ccresponse

    @jax.jit
    def synth(key):
        kB, kF, km = jax.random.split(key, 3)
        # uniform draws: jax.random.normal's erf_inv chain holds ~13 f32
        # copies of a (naux, nact, nact) operand (HBM OOM at this size)
        B = (jax.random.uniform(kB, (naux, nact, nact), jnp.float32,
                                -1.0, 1.0) * (0.05 / jnp.sqrt(nv)))
        B = 0.5 * (B + jnp.swapaxes(B, 1, 2))
        eps = jnp.concatenate([jnp.linspace(-2.0, -0.5, no),
                               jnp.linspace(0.3, 3.0, nv)])
        F = jnp.diag(eps).astype(jnp.float32)
        F = F + 0.0005 * jax.random.uniform(kF, (nact, nact), jnp.float32,
                                            -1.0, 1.0)
        F = 0.5 * (F + F.T)
        mu = 0.1 * jax.random.uniform(km, (3, nact, nact), jnp.float32,
                                      -1.0, 1.0)
        mu = 0.5 * (mu + jnp.swapaxes(mu, 1, 2))
        return B, F, mu

    print("synthesizing (o,v)=(%d,%d) naux=%d factors on device..."
          % (no, nv, naux))
    sys.stdout.flush()
    B, F, mu = synth(jax.random.PRNGKey(3))
    jax.block_until_ready(B)

    out = {"config": "(%d,%d) naux=%d SP df" % (no, nv, naux)}

    cc = ccwfn.from_df_factors(B, F, no, precision="SP")
    t0 = time.time()
    cc.solve_cc(e_conv=1e-10, r_conv=1e-10, maxiter=args.cc_iters)
    t = time.time() - t0
    assert np.isfinite(float(cc.t1[0, 0]))
    out["t_cc_per_iter_s"] = round(t / args.cc_iters, 2)
    print("DF-CCSD: %.2f s/iter" % (t / args.cc_iters))
    sys.stdout.flush()

    t0 = time.time()
    hb = cchbar(cc)
    jax.block_until_ready(hb.Hov)
    out["t_hbar_s"] = round(time.time() - t0, 1)
    print("DF-HBAR wall: %.1f s" % out["t_hbar_s"])
    sys.stdout.flush()

    lam = cclambda(cc, hb)
    t0 = time.time()
    lam.solve_lambda(e_conv=1e-10, r_conv=1e-10,
                     maxiter=args.lambda_iters)
    t = time.time() - t0
    assert np.isfinite(float(lam.l1[0, 0]))
    out["t_lambda_per_iter_s"] = round(t / args.lambda_iters, 2)
    print("DF-Lambda: %.2f s/iter" % (t / args.lambda_iters))
    sys.stdout.flush()

    eom = cceom(hb)
    t0 = time.time()
    # UNIT guess: HBAR_SS diagonalizes a (no*nv)^2 = 16384^2 matrix on
    # the single host core — not the thing being measured here
    E, C = eom.solve_eom(N=args.roots, e_conv=1e-4, r_conv=1e-4,
                         maxiter=args.eom_maxiter, guess="UNIT")
    out["t_eom_davidson_s"] = round(time.time() - t0, 1)
    out["eom_roots"] = [float(x) for x in np.asarray(E)]
    out["eom_finite"] = bool(np.all(np.isfinite(E)))
    print("DF-EOM Davidson wall: %.1f s  roots=%s"
          % (out["t_eom_davidson_s"], out["eom_roots"]))
    sys.stdout.flush()

    cc.H = dataclasses.replace(cc.H, mu=mu)
    from types import SimpleNamespace
    resp = ccresponse(SimpleNamespace(ccwfn=cc, cclambda=lam))
    t0 = time.time()
    X1, X2, pr = resp.solve_right(resp.pertbar["MU_Z"], 0.0656,
                                  e_conv=1e-5, r_conv=1e-5,
                                  maxiter=args.resp_maxiter)
    out["t_resp_solve_right_s"] = round(time.time() - t0, 1)
    out["resp_pseudo"] = float(np.real(pr))
    out["resp_finite"] = bool(np.isfinite(out["resp_pseudo"]))
    print("DF-response solve_right wall: %.1f s" % out["t_resp_solve_right_s"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
