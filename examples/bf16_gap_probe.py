"""Measure the bf16-vs-f32 DF residual gap at the north-star scale.

The flagship bench row (bench.py bench_df) runs the DF-CCSD iteration in
bfloat16; this probe quantifies what bf16 costs in residual accuracy at
the same (o, v, naux): one residual evaluation from identical synthetic
factors in f32 and in bf16, reporting the max absolute and relative
element gaps and the energy-functional gap.  Complements the
solve_cc(bf16_until=...) noise-floor rollback machinery (test_016),
which gates on exactly this signal during a real solve.

Usage: python examples/bf16_gap_probe.py [--no 32] [--nv 512] [--naux 1632]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no", type=int, default=32)
    ap.add_argument("--nv", type=int, default=512)
    ap.add_argument("--naux", type=int, default=1632)
    # 128 blocks: the f32 pass at (32,512) holds the blk*v^3 ladder W
    # beside ~6 o^2v^2 temps
    ap.add_argument("--nblocks", type=int, default=128)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    no, nv, naux = args.no, args.nv, args.naux

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from pycc_tpu.utils import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from pycc_tpu.models import dfccsd as dfq
    from pycc_tpu.ops.contract import contract

    @jax.jit
    def synth(key):
        ks = jax.random.split(key, 4)
        mk = lambda k, sh: (0.05 / nv ** 0.5) * jax.random.uniform(
            k, sh, jnp.float32, -1.0, 1.0)
        eps = jnp.concatenate([jnp.linspace(-2.0, -0.5, no),
                               jnp.linspace(0.3, 3.0, nv)])
        F = jnp.diag(eps).astype(jnp.float32)
        df = dfq.DFERI(mk(ks[0], (naux, no, no)), mk(ks[1], (naux, no, nv)),
                       mk(ks[2], (naux, nv, nv)))
        Dijab = (eps[:no, None, None, None] + eps[None, :no, None, None]
                 - eps[None, None, no:, None] - eps[None, None, None, no:])
        t1 = 0.01 * jax.random.uniform(ks[3], (no, nv), jnp.float32,
                                       -1.0, 1.0)
        t2 = contract("Pia,Pjb->ijab", df.Bov, df.Bov) / Dijab
        return F, df, t1, t2

    def resid(F, df, t1, t2, dt):
        c = lambda x: x.astype(dt)
        dfc = dfq.DFERI(c(df.Boo), c(df.Bov), c(df.Bvv))
        r1, r2 = dfq.residuals_ccsd_df(c(F), dfc, c(t1), c(t2), no,
                                       nblocks=args.nblocks)
        e = dfq.cc_energy_df(c(F), dfc, c(t1), c(t2), no)
        # compare in f32: bf16 outputs upcast losslessly
        return (r1.astype(jnp.float32), r2.astype(jnp.float32),
                e.astype(jnp.float32))

    print("synthesizing (o,v)=(%d,%d) naux=%d..." % (no, nv, naux))
    sys.stdout.flush()
    F, df, t1, t2 = synth(jax.random.PRNGKey(5))
    jax.block_until_ready(F)

    jr = jax.jit(resid, static_argnums=(4,))
    if no * no * nv * nv * 4 > 9e8:
        # the ONE-program f32 residual exceeds a 16 GB device past ~1 GB of o^2v^2
        # (measured 17.7 G at (32,512)); evaluate the f32 side through
        # the host-sequenced split programs instead (same fixed point,
        # tested to 1e-13 — tests/test_017)
        r1f, r2f = dfq.residuals_ccsd_df_split(F, df, t1, t2, no,
                                               nblocks=args.nblocks)
        ef = jax.jit(dfq.cc_energy_df, static_argnames="no")(
            F, df, t1, t2, no=no)
    else:
        r1f, r2f, ef = jr(F, df, t1, t2, jnp.float32)
    jax.block_until_ready(r2f)
    r1b, r2b, eb = jr(F, df, t1, t2, jnp.bfloat16)
    # device-side reductions: the full r2 pair is 2 x 1 GB at (32,512)
    gap2 = jax.jit(lambda a, b: jnp.abs(a - b).max())(r2f, r2b)
    scale2 = jax.jit(lambda a: jnp.abs(a).max())(r2f)
    gap1 = jax.jit(lambda a, b: jnp.abs(a - b).max())(r1f, r1b)
    out = {
        "config": "(%d,%d) naux=%d df residual" % (no, nv, naux),
        "r2_abs_gap": float(gap2), "r2_scale": float(scale2),
        "r2_rel_gap": float(gap2) / max(float(scale2), 1e-30),
        "r1_abs_gap": float(gap1),
        "energy_f32": float(ef), "energy_bf16": float(eb),
        "energy_gap": abs(float(ef) - float(eb)),
    }
    assert np.isfinite(out["r2_abs_gap"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
