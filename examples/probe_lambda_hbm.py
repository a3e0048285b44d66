"""Compile-probe the at-scale DF Lambda programs and print the
compiler's own device-memory accounting (temp/argument/output bytes) — run BEFORE
an at-scale Lambda to validate fit and pre-warm the compile cache.

The three host-sequenced residual programs (models/dfhbar.py:
lambda_r2_seed_df / lambda_r2_rings_df / lambda_r1_df) are lowered with
ShapeDtypeStructs at the target (no, nv, naux), mirroring cclambda's
jit wrapping (same jaxpr -> same persistent-cache key), so the real run
compiles instantly afterwards.

Usage: python examples/probe_lambda_hbm.py [no nv naux]
"""
import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd
from pycc_tpu.utils import setup_compile_cache
setup_compile_cache()
from pycc_tpu.models.dfccsd import DFERI
from pycc_tpu.models.dfhbar import (DFHBar, lambda_r1_df,
                                    lambda_r2_ladder_df,
                                    lambda_r2_rings_df,
                                    lambda_r2_small_a_df,
                                    lambda_r2_small_b_df)

no, nv, naux = (int(x) for x in sys.argv[1:4]) if len(sys.argv) > 3 else (40, 360, 2592)
dt = jnp.float32
S = jax.ShapeDtypeStruct

hb = DFHBar(
    Hov=S((no, nv), dt), Hvv=S((nv, nv), dt), Hoo=S((no, no), dt),
    Hoooo=S((no,) * 4, dt), Hooov=S((no, no, no, nv), dt),
    Hovvo=S((no, nv, nv, no), dt), Hovov=S((no, nv, no, nv), dt),
    Hovoo=S((no, nv, no, no), dt),
    df=DFERI(Boo=S((naux, no, no), dt), Bov=S((naux, no, nv), dt),
             Bvv=S((naux, nv, nv), dt)),
    Bd_ae=S((naux, nv, nv), dt), Bd_mi=S((naux, no, no), dt))
t1 = S((no, nv), dt)
t2 = S((no, no, nv, nv), dt)
l1, l2, r2s = t1, t2, t2

GB = 1024.0 ** 3


def probe(name, fn, *args, **kw):
    t0 = time.time()
    c = jax.jit(fn, **kw).lower(*args).compile()
    m = c.memory_analysis()
    print("%-12s compile %6.1fs  temp %6.2f GB  args %6.2f GB  out %5.2f GB"
          % (name, time.time() - t0, m.temp_size_in_bytes / GB,
             m.argument_size_in_bytes / GB, m.output_size_in_bytes / GB),
          flush=True)


probe("small_a", lambda hb_, l1, l2: lambda_r2_small_a_df(hb_, l1, l2, no, None),
      hb, l1, l2)
probe("small_b", lambda hb_, l1, l2, r2s: lambda_r2_small_b_df(hb_, l1, l2, r2s, no),
      hb, l1, l2, r2s, donate_argnums=(3,))
probe("ladder", lambda hb_, t2, l2, r2s: lambda_r2_ladder_df(hb_, t2, l2, r2s, no),
      hb, t2, l2, r2s, donate_argnums=(3,))
probe("rings", lambda hb_, t2, l2, r2s: lambda_r2_rings_df(hb_, t2, l2, r2s, no),
      hb, t2, l2, r2s, donate_argnums=(3,))
probe("r1", lambda hb_, t1, t2, l1, l2: lambda_r1_df(hb_, t1, t2, l1, l2, no, None),
      hb, t1, t2, l1, l2)
