"""(T) slab-scan roofline probe: measure the wall at
(o, v) across the bandwidth knobs — f32 vs bf16 slabs, j-chunk width —
and report TFLOP/s against the analytic flop count plus the implied
slab-traffic bandwidth, so PERF.md can state WHICH resource binds.

Synthetic slices via jax.random.uniform (normal's erf_inv chain holds ~13
copies and compile-OOMs on (naux,v,v) operands — CLAUDE.md), every big
operand a jit argument, finite-fetch at the end of every timed region
(async failed executions return instantly otherwise).

Usage:  python examples/t_probe.py --o 32 --v 128 --configs f32:2,bf16:2,bf16:8
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--o", type=int, default=32)
    ap.add_argument("--v", type=int, default=128)
    ap.add_argument("--configs", default="f32:2,f32:8,bf16:2,bf16:8",
                    help="comma list dtype:jc")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()

    import jax
    from pycc_tpu.utils import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    from pycc_tpu.triples import t_vikings_scan_core, t_scan_flops

    no, nv = args.o, args.v
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 8)
    u = lambda k, shape, s: (jax.random.uniform(k, shape, jnp.float32)
                             - 0.5) * s
    Wvvvo_o = u(ks[0], (no, nv, nv, nv), 0.1)
    Wovoo_t = u(ks[1], (no, no, no, nv), 0.1)
    Evovv = u(ks[2], (nv, no, nv, nv), 0.1)
    Eooov = u(ks[3], (no, no, no, nv), 0.1)
    Loovv = u(ks[4], (no, no, nv, nv), 0.1)
    Fov = u(ks[5], (no, nv), 0.01)
    t1 = u(ks[6], (no, nv), 0.01)
    t2 = u(ks[7], (no, no, nv, nv), 0.02)
    eps = jnp.concatenate([-1.0 - jnp.arange(no, 0, -1, dtype=jnp.float32)
                           * 0.1,
                           1.0 + jnp.arange(nv, dtype=jnp.float32) * 0.01])
    for x in (Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, t1, t2, eps):
        x.block_until_ready()

    flops = t_scan_flops(no, nv, sym=True)
    # slab-traffic model (PERF.md "Triples roofline"): per unordered pair,
    # the 12 build dots R/W the (jc,no,v,v,v) accumulator (24 units of
    # no*v^3 f32 bytes), td/T/t3p materialize ~5 more, and the energy
    # dots re-read ~6; operand reads add 2*no*v^3/jc for the two full-W
    # terms.  One "unit" = no*v^3*itemsize bytes.
    def model_bytes(itemsize, jc):
        pairs = no * (no + 1) // 2
        units = 24.0 + 11.0 + 2.0 / jc
        return pairs * units * no * nv ** 3 * itemsize

    rows = []
    for cfg in args.configs.split(","):
        dts, jcs = cfg.split(":")
        dt = {"f32": None, "bf16": jnp.bfloat16}[dts]
        jc = int(jcs)
        walls = []
        for rep in range(args.repeat):
            t0 = time.time()
            e = t_vikings_scan_core(Wvvvo_o, Wovoo_t, Evovv, Eooov,
                                    Loovv, Fov, eps, t1, t2, no,
                                    slab_dtype=dt, jc=jc)
            ev = float(e)            # device fetch = sync + sanity
            walls.append(time.time() - t0)
            assert np.isfinite(ev), cfg
        wall = min(walls)            # first rep pays the compiles
        mb = model_bytes(2 if dt is not None else 4, jc)
        row = {"cfg": cfg, "o": no, "v": nv, "wall_s": round(wall, 3),
               "tflops": round(flops / wall / 1e12, 2),
               "e": ev,
               "model_TB": round(mb / 1e12, 3),
               "implied_GBs": round(mb / wall / 1e9, 1),
               "walls": [round(w, 3) for w in walls]}
        rows.append(row)
        print(json.dumps(row))
        sys.stdout.flush()
    return rows


if __name__ == "__main__":
    main()
