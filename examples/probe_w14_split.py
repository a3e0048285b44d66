"""AOT compile-probe the f32 split-residual programs at w14 scale.

(H2O)_14 aug-cc-pVDZ is (56,504) naux=5414: Bvv alone is 5.5 GB f32 and
the o^2v^2 block is 3.19 GB, so several split programs are near a
16 GB device's capacity.  Lowers each with ShapeDtypeStruct args (no device
arrays) so the verdict lands BEFORE the capture and the persistent
cache is pre-seeded.

Run: python examples/probe_w14_split.py [no nv naux [dtype]]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd

import jax
import jax.numpy as jnp

from pycc_tpu.utils import setup_compile_cache
setup_compile_cache()

from pycc_tpu.models import dfccsd as q
from pycc_tpu.models.dfccsd import DFERI


def main():
    no = int(sys.argv[1]) if len(sys.argv) > 1 else 56
    nv = int(sys.argv[2]) if len(sys.argv) > 2 else 504
    naux = int(sys.argv[3]) if len(sys.argv) > 3 else 5414
    dt = jnp.dtype(sys.argv[4]) if len(sys.argv) > 4 else jnp.float32
    nact = no + nv

    def S(*shape):
        return jax.ShapeDtypeStruct(shape, dt)

    df = DFERI(Boo=S(naux, no, no), Bov=S(naux, no, nv),
               Bvv=S(naux, nv, nv))
    F = S(nact, nact)
    t1, t2 = S(no, nv), S(no, no, nv, nv)
    r2 = S(no, no, nv, nv)
    W = S(no, nv, nv, no)       # Wmbej layout
    Wje = S(no, nv, no, nv)     # Wmbje layout

    max_elems = 3 * 10 ** 7 if dt == jnp.float64 else 6 * 10 ** 7
    ablk, bblk = q._sc_ladder_blocks(nv, max_elems)
    na, nb = nv // ablk, nv // bblk
    grid_chunks = 6 if no * no * nv * nv > 5e7 else 1
    per = -(-(na * nb) // min(grid_chunks, na * nb))
    i32 = jax.ShapeDtypeStruct((per,), jnp.dtype("int32"))
    mk = jax.ShapeDtypeStruct((per,), dt)
    print("grid ladder blocks: ablk=%d bblk=%d per-chunk trips=%d"
          % (ablk, bblk, per), flush=True)

    probes = [
        ("qf_energy", jax.jit(q.cc_energy_df_qf, static_argnums=(4, 5)),
         (F, df, t1, t2, no, True)),
        ("rs_r1", q._rs_r1, (F, df, t1, t2), dict(no=no)),
        ("rs_seed", q._rs_seed, (F, df, t1, t2, S(nv, nv), S(no, no),
                                 S(no, nv)), dict(no=no, ladder_t1=True)),
        ("rs_oooo", q._rs_oooo, (df, t1, t2, r2), dict(no=no)),
        ("grid_ladder", q._sc_ladder, (df, t1, t2, r2, i32, i32, mk),
         dict(no=no, ablk=ablk, bblk=bblk)),
        ("ring_ej_a", q._rs_ring_ej_a, (df, t1, t2)),
        ("ring_ej_b", q._rs_ring_ej_b, (df, t1, t2, W, r2)),
        ("ring_je_a", q._rs_ring_je_a, (df, t1, r2)),
        ("ring_je_b", q._rs_ring_je_b, (df, t1, t2, Wje)),
        ("ring_je_c", q._rs_ring_je_c, (t2, Wje, r2)),
        ("rs_sym", q._rs_sym, (r2,)),
    ]

    for item in probes:
        name, fn, args = item[0], item[1], item[2]
        kw = item[3] if len(item) > 3 else {}
        t0 = time.time()
        try:
            compiled = fn.lower(*args, **kw).compile()
            dt_s = time.time() - t0
            try:
                mem = compiled.memory_analysis()
                extra = " temp=%.2fGB args=%.2fGB" % (
                    getattr(mem, "temp_size_in_bytes", 0) / 1e9,
                    getattr(mem, "argument_size_in_bytes", 0) / 1e9)
            except Exception:
                extra = ""
            print("PROBE %-12s OK   %6.1f s%s" % (name, dt_s, extra),
                  flush=True)
        except Exception as exc:
            msg = str(exc)
            if "Ran out of memory" in msg:
                import re
                m = re.search(r"Used ([0-9.]+[GM]) of", msg)
                msg = "HBM OOM (%s)" % (m.group(1) if m else "?")
            else:
                msg = msg.splitlines()[0][:140]
            print("PROBE %-12s FAIL %6.1f s  %s"
                  % (name, time.time() - t0, msg), flush=True)


if __name__ == "__main__":
    main()
