"""Real-time CC RHS at scale, from DF factors, on the device.

Round 3 gave rtcc a storage='df' mode (RHS, field-dressed DF-HBAR Lambda
residuals, observables) and the re/im-split CTensor path for a
backend without complex arithmetic.  The FUSED ri-split RHS compile-OOMs
at (32,256) naux=1024 (26 GB requested — T residual + rebuilt Lambda
HBAR in one program); the host-split RHS (rtcc rhs_split=True, auto past
100 MB of o^2v^2) sequences ~14 short programs instead.  This script
captures the wall-clock of one split RHS evaluation at sizes whose dense
ERI the reference's RT driver cannot even hold
(/root/reference/pycc/rt/rtcc.py consumes the dense MO ERI via
hamiltonian.py:36-39).  Synthetic spectrally-sane factors (bench.py
measurement rules); the timed loop ends in a finite-checked fetch.

Usage: python examples/rt_df_at_scale.py [--no 32] [--nv 256]
       [--naux 1024] [--evals 3]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no", type=int, default=32)
    ap.add_argument("--nv", type=int, default=256)
    ap.add_argument("--naux", type=int, default=1024)
    ap.add_argument("--evals", type=int, default=3)
    ap.add_argument("--fused", action="store_true",
                    help="force the one-program RHS (compile-OOMs at the "
                         "default size; the HBM-wall probe)")
    ap.add_argument("--cc-iters", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke tests)")
    args = ap.parse_args()
    no, nv, naux = args.no, args.nv, args.naux
    nact = no + nv

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from pycc_tpu.utils import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from pycc_tpu import ccdensity, cchbar, cclambda, ccwfn, rtcc
    from pycc_tpu.rt.lasers import gaussian_laser

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
    B, F, mu = synth(jax.random.PRNGKey(11))
    jax.block_until_ready(B)

    cc = ccwfn.from_df_factors(B, F, no, precision="SP", mu=np.asarray(mu))
    # --cc-iters 0 skips the prep solve entirely: the RHS wall-clock does
    # not depend on amplitude quality, and at (32,512) the ONE-program
    # f32 residual exceeds a 16 GB device (~17 o^2v^2 temps; the north-star solve
    # row runs bf16 for exactly this reason).  max_diis=0: the default
    # depth-8 ring alone is ~17 GB here (measured runtime OOM).
    if args.cc_iters > 0:
        cc.solve_cc(e_conv=1e-10, r_conv=1e-10, maxiter=args.cc_iters,
                    max_diis=0)
    hb = cchbar(cc)
    lam = cclambda(cc, hb)
    lam.solve_lambda(e_conv=1e-10, r_conv=1e-10, maxiter=1, max_diis=0)
    # onlyone: rtcc keeps its own per-step density contractions (df mode
    # evaluates them factor-wise); the eager two-pdm blocks would build a
    # 17 GB o v^3 temp at this size (measured OOM in build_Doovv)
    dens = ccdensity(cc, lam, onlyone=True)
    V = gaussian_laser(0.05, 0.0, 0.01, center=0.05)
    rt = rtcc(cc, lam, dens, V, ri_split=True,
              rhs_split=False if args.fused else None)
    mode = "fused" if args.fused else ("split" if rt.df_split else "fused")

    # complex packing happens on the HOST; rt.f unpacks to the (re, im) CTensor pair per program
    y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2,
                         np.zeros((), "complex64"))
    y = np.asarray(y0)

    print("compiling the %s ri-split RHS..." % mode)
    sys.stdout.flush()
    t0 = time.time()
    out = rt.f(0.02, y)
    t_compile = time.time() - t0
    probe0 = complex(out[0])
    assert np.isfinite(probe0.real), "RHS produced non-finite output"
    print("first eval (compile+run): %.1f s" % t_compile)
    sys.stdout.flush()

    t0 = time.time()
    for k in range(args.evals):
        out = rt.f(0.02 + 0.001 * k, y)
    # rt.f host-syncs every program and returns host data, so the loop
    # timing is honest; still end with a finite check
    probe = complex(out[0])
    dt = (time.time() - t0) / args.evals
    assert np.isfinite(probe.real), "RHS produced non-finite output"

    print(json.dumps({
        "config": "(%d,%d) naux=%d SP df ri_split %s RHS"
                  % (no, nv, naux, mode),
        "rhs_s_per_eval": round(dt, 3),
        "first_eval_s": round(t_compile, 1),
        "finite": True,
    }))


if __name__ == "__main__":
    main()
