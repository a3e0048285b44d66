"""Benchmark: CC throughput on one GPU.

    python bench.py     # one JSON line; fails where JAX finds no GPU

The primary metric is the DF-CCSD amplitude iteration at (o, v) =
(32, 512) — a 544-basis-function system, the BASELINE.json north-star
scale — in bfloat16 from Cholesky factors, where the dense ERI could
never fit (dense ERI+L at nact=544 is ~1.4 TB f32 vs ~1 GB of factors).
`flops` counts the full step: XLA's own cost analysis PLUS the
ladder-scan body times its remaining trip count (XLA costs a scan body
once), so `tflops` and the peak share are sustained rates.

`extra` carries secondary rows: the blocked-storage CCSD iteration at
(32,128) f32, the (T) slab-scan wall time at (32,128) (the BASELINE.json
"(T) wall time" metric), the DF-CCSD and (T) scaling curves, and — when
the prepared factors are cached on disk (examples/prepare_df_molecule.py)
— a REAL-molecule DF-CCSD iteration: (H2O)_10 / aug-cc-pVDZ, 410 basis
functions, (o, v) = (40, 360), integral-direct AO Cholesky factors, f32.

Every row names the device, the card's power limit, and its share of
the published peak of its own dtype (pycc_tpu.utils.device.PEAK_FLOPS).

Measurement rules: executions are async, so every timed loop ends with
a device->host fetch of one element that is checked finite; synthetic
factors are drawn uniform (jax.random.normal's erf_inv chain holds
many copies of a (naux,v,v) tensor); and the amplitude update is a real
Jacobi step with denominators so the iterates stay bounded in bfloat16.

vs_baseline scales a measured single-core CPU time (dense blocked CCSD
(16,64) f64: 6.596 s/iter = 3.031e10 flops -> 2.176e-10 s/flop; the
reference publishes no perf numbers, BASELINE.json `published` is empty)
to each config by flop count: vs_baseline = cpu_s_per_flop * flops / dt.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from pycc_tpu.utils.device import card_info, peak_flops, require_gpu  # noqa: E402

# measured: 6.596 s/iter at (16,64) f64 dense-blocked CCSD on one CPU
# core; 3.0314522624e10 flops per step from XLA cost_analysis
CPU_S_PER_FLOP = 6.596 / 3.0314522624e10

DF_CFG = dict(no=32, nv=512, naux=1632, nblocks=64)  # 544-bf, naux=3*nact
BLK_CFG = dict(no=32, nv=128)
T_CFG = dict(no=32, nv=128)
# scaling curves (the literal BASELINE.json metric: s/iter and (T) wall
# vs (o, v)).  naux = 3*nact throughout; nblocks from the same
# memory rule production uses.
DF_CURVE = [(16, 128), (32, 128), (32, 256)]  # + DF_CFG's (32, 512)
T_CURVE = [(16, 128)]                          # + T_CFG's (32, 128)
# real-molecule factors prepared by examples/prepare_df_molecule.py
# ((H2O)_10 aug-cc-pVDZ, 410 bf): the row is emitted only when cached
REAL_NPZ = os.path.join(ROOT, "df_cache", "w10aug.npz")


def _fetch_finite(x):
    """Force execution by fetching one element; raise if non-finite."""
    import jax
    import numpy as np
    v = float(np.asarray(jax.device_get(x[(0,) * x.ndim])))
    if not np.isfinite(v):
        raise FloatingPointError("non-finite bench iterate: %r" % v)
    return v


def _sync(tree):
    import jax
    jax.tree_util.tree_map(lambda x: x.block_until_ready(), tree)


def _flops_of(compiled):
    try:
        c = compiled.cost_analysis()
        if isinstance(c, list):
            c = c[0]
        return float(c.get("flops"))
    except Exception:
        return None


def bench_df(no, nv, naux, nblocks, n=5):
    """DF-CCSD amplitude iteration, bf16 factors/amplitudes."""
    import jax
    import jax.numpy as jnp
    from pycc_tpu.models import dfccsd as dfq

    DT = jnp.bfloat16

    @jax.jit
    def synth(key):
        ks = jax.random.split(key, 5)
        # uniform, NOT normal: erf_inv holds copies of (naux, v, v).
        # 1/sqrt(v) keeps the ladder a bounded operator so the damped
        # Jacobi iteration stays finite at any (v, naux) (real Cholesky
        # factors have a decaying spectrum; constant-scale random ones
        # make the synthetic ERI norm grow with v and diverge the
        # fixed point at production sizes)
        mk = lambda k, sh: ((0.05 / nv ** 0.5) * jax.random.uniform(
            k, sh, minval=-1.0, maxval=1.0)).astype(DT)
        nact = no + nv
        eps = jnp.concatenate([jnp.linspace(-2.0, -0.5, no),
                               jnp.linspace(0.3, 3.0, nv)])
        F = jnp.diag(eps).astype(DT)
        df = dfq.DFERI(mk(ks[1], (naux, no, no)), mk(ks[2], (naux, no, nv)),
                       mk(ks[3], (naux, nv, nv)))
        Dia = (eps[:no, None] - eps[None, no:]).astype(DT)
        Dijab = (eps[:no, None, None, None] + eps[None, :no, None, None]
                 - eps[None, None, no:, None]
                 - eps[None, None, None, no:]).astype(DT)
        t1 = jnp.zeros((no, nv), DT)
        t2 = (contract("Pia,Pjb->ijab", df.Bov, df.Bov) / Dijab).astype(DT)
        return F, df, Dia, Dijab, t1, t2

    from pycc_tpu.ops.contract import contract
    F, df, Dia, Dijab, t1, t2 = synth(jax.random.PRNGKey(0))
    _sync(F)

    def step(F, df, Dia, Dijab, t1, t2):
        # damped Jacobi: a synthetic (non-physical) Hamiltonian is not
        # diagonally dominant enough for the undamped update in bf16
        r1, r2 = dfq.residuals_ccsd_df(F, df, t1, t2, no, nblocks=nblocks)
        return (t1 + 0.25 * r1 / Dia).astype(DT), \
               (t2 + 0.25 * r2 / Dijab).astype(DT)

    comp = jax.jit(step).lower(F, df, Dia, Dijab, t1, t2).compile()
    flops = _flops_of(comp)
    if flops:
        # cost_analysis charges the ladder scan body ONCE; add the
        # remaining trips: per block 2*blk*v^3*(naux + o^2) flops
        blk = -(-nv // nblocks)
        flops += (nblocks - 1) * 2.0 * blk * nv ** 3 * (naux + no * no)
    a, b = comp(F, df, Dia, Dijab, t1, t2)
    _fetch_finite(b)
    t0 = time.time()
    for _ in range(n):
        a, b = comp(F, df, Dia, Dijab, a, b)
    _fetch_finite(b)
    dt = (time.time() - t0) / n
    return dt, flops


def bench_real_molecule(npz_path, n=5):
    """Real-molecule DF-CCSD iteration from integral-direct AO-Cholesky
    factors ((H2O)_10 / aug-cc-pVDZ, 410 bf): the same residual program
    ccwfn(storage='df') runs, timed on physical factors rather than the
    synthetic spectrally-shaped draws of bench_df."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pycc_tpu.models import dfccsd as dfq
    from pycc_tpu.models.dfccsd import _ladder_blocks
    from pycc_tpu.ops.contract import contract

    d = np.load(npz_path, allow_pickle=True)
    B = np.asarray(d["B"], np.float32)
    F = np.asarray(d["F"], np.float32)
    no = int(d["no"])
    naux, nact, _ = B.shape
    nv = nact - no
    nblocks = _ladder_blocks(nv, naux)
    df = dfq.DFERI(jnp.asarray(B[:, :no, :no]), jnp.asarray(B[:, :no, no:]),
                   jnp.asarray(B[:, no:, no:]))
    del B
    eps = np.diag(F)
    Dia = jnp.asarray(eps[:no, None] - eps[None, no:])
    Dijab = jnp.asarray(eps[:no, None, None, None]
                        + eps[None, :no, None, None]
                        - eps[None, None, no:, None]
                        - eps[None, None, None, no:])
    F = jnp.asarray(F)
    t1 = jnp.zeros((no, nv), jnp.float32)
    t2 = jax.jit(lambda df, D: contract("Pia,Pjb->ijab", df.Bov,
                                        df.Bov) / D)(df, Dijab)

    def step(F, df, Dia, Dijab, t1, t2):
        r1, r2 = dfq.residuals_ccsd_df(F, df, t1, t2, no, nblocks=nblocks)
        return t1 + r1 / Dia, t2 + r2 / Dijab

    comp = jax.jit(step).lower(F, df, Dia, Dijab, t1, t2).compile()
    flops = _flops_of(comp)
    if flops:
        blk = -(-nv // nblocks)
        flops += (nblocks - 1) * 2.0 * blk * nv ** 3 * (naux + no * no)
    a, b = comp(F, df, Dia, Dijab, t1, t2)
    _fetch_finite(b)
    t0 = time.time()
    for _ in range(n):
        a, b = comp(F, df, Dia, Dijab, a, b)
    _fetch_finite(b)
    dt = (time.time() - t0) / n
    return dt, flops, dict(no=no, nv=nv, naux=naux)


def bench_blocked(no, nv, n=10):
    """Round-1 continuity metric: blocked-storage CCSD iteration, f32."""
    import jax
    import jax.numpy as jnp
    from pycc_tpu.models import ccsd as eqs
    from pycc_tpu.models.blocked import blocked_views, blocks_from_full

    @jax.jit
    def synth(key):
        k1, k2 = jax.random.split(key)
        nact = no + nv
        eps = jnp.concatenate([jnp.linspace(-2.0, -0.5, no),
                               jnp.linspace(0.3, 3.0, nv)]).astype(jnp.float32)
        F = jnp.diag(eps) + 0.0005 * jax.random.normal(k1, (nact, nact),
                                                       jnp.float32)
        F = 0.5 * (F + F.T)
        # 1/v: the random-ladder operator norm is ~2*sigma*v, which must
        # stay below the denominator floor for the damped Jacobi iterates
        # to remain finite (see bench_df)
        A = (0.05 / nv) * jax.random.normal(k2, (nact,) * 4, jnp.float32)
        A = A + jnp.transpose(A, (1, 0, 2, 3))
        A = A + jnp.transpose(A, (0, 1, 3, 2))
        A = A + jnp.transpose(A, (2, 3, 0, 1))
        ERI = jnp.swapaxes(A, 1, 2)
        eps = jnp.diag(F)
        Dia = eps[:no, None] - eps[None, no:]
        Dijab = (eps[:no, None, None, None] + eps[None, :no, None, None]
                 - eps[None, None, no:, None] - eps[None, None, None, no:])
        t2 = ERI[:no, :no, no:, no:] / Dijab
        return F, ERI, Dia, Dijab, t2

    F, ERI, Dia, Dijab, t2 = synth(jax.random.PRNGKey(0))
    _sync(F)
    t1 = jax.numpy.zeros((no, nv), jax.numpy.float32)
    blocks = jax.jit(blocks_from_full, static_argnums=1)(ERI, no)
    del ERI

    @jax.jit
    def step(F, blocks, Dia, Dijab, t1, t2):
        bE, bL = blocked_views(blocks, no)
        r1, r2 = eqs.residuals_ccsd(F, bE, bL, t1, t2, no)
        return t1 + 0.25 * r1 / Dia, t2 + 0.25 * r2 / Dijab

    comp = jax.jit(step).lower(F, blocks, Dia, Dijab, t1, t2).compile()
    flops = _flops_of(comp)
    a, b = comp(F, blocks, Dia, Dijab, t1, t2)
    _fetch_finite(b)
    t0 = time.time()
    for _ in range(n):
        a, b = comp(F, blocks, Dia, Dijab, a, b)
    _fetch_finite(b)
    dt = (time.time() - t0) / n
    return dt, flops


def bench_triples(no, nv, slab_dtype=None, jc=None):
    """(T) slab-scan wall time (one full energy evaluation), f32 by
    default; slab_dtype/jc expose the slab-traffic knobs.
    flops from the analytic count (triples.t_scan_flops) — XLA's
    cost_analysis charges the fori_loop body once, so the analytic count
    is the only honest sustained-rate basis for the scan."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pycc_tpu.triples import (slab_layouts, t_scan_flops,
                                  t_vikings_scan_core)

    @jax.jit
    def synth(key):
        ks = jax.random.split(key, 6)
        mk = lambda k, sh: 0.02 * jax.random.normal(k, sh, jnp.float32)
        Wvvvo = mk(ks[0], (nv, nv, nv, no))
        Wovoo = mk(ks[1], (no, nv, no, no))
        Evovv = mk(ks[2], (nv, no, nv, nv))
        Eooov = mk(ks[3], (no, no, no, nv))
        Loovv = mk(ks[4], (no, no, nv, nv))
        Fov = mk(ks[5], (no, nv))
        eps = jnp.concatenate([jnp.linspace(-2.0, -0.5, no),
                               jnp.linspace(0.3, 3.0, nv)]).astype(jnp.float32)
        Wvvvo_o, Wovoo_t = slab_layouts(Wvvvo, Wovoo)
        t2 = mk(ks[4], (no, no, nv, nv))
        t1 = mk(ks[5], (no, nv))
        return Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps, t1, t2

    args = synth(jax.random.PRNGKey(1))
    _sync(args[0])
    # warm (compiles the row program)
    e = t_vikings_scan_core(*args, no, slab_dtype=slab_dtype, jc=jc)
    assert np.isfinite(float(e))
    t0 = time.time()
    e = t_vikings_scan_core(*args, no, slab_dtype=slab_dtype, jc=jc)
    assert np.isfinite(float(e))
    return time.time() - t0, t_scan_flops(no, nv)


def _row(metric, dt, flops, dtype, card, unit="s/iter"):
    """One result row; `dtype` names the peak its rate is a share of."""
    row = {"metric": metric, "value": dt, "unit": unit, **card}
    if flops:
        rate = flops / dt
        row["flops"] = flops
        row["tflops"] = rate / 1e12
        row["share_of_%s_peak" % dtype] = rate / peak_flops(
            card["device"]["kind"], dtype)
        row["vs_baseline"] = CPU_S_PER_FLOP * rate
    return row


def main():
    import jax

    from pycc_tpu.utils import setup_compile_cache

    devices = jax.devices()
    dev = require_gpu(devices)
    peak_flops(dev.device_kind, "bfloat16")   # unknown card: fail now
    setup_compile_cache()
    import jax.numpy as jnp

    card = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(devices)},
            "card": card_info()}

    dt, flops = bench_df(**DF_CFG)
    out = _row("dfccsd_iteration_o%d_v%d_naux%d_bf16"
               % (DF_CFG["no"], DF_CFG["nv"], DF_CFG["naux"]), dt, flops,
               "bfloat16", card)
    extra = []
    dtb, fb = bench_blocked(**BLK_CFG)
    extra.append(_row("ccsd_iteration_o32_v128_f32_blocked", dtb, fb,
                      "float32", card))
    dtt, ft = bench_triples(**T_CFG)
    extra.append(_row("triples_T_scan_wall_o32_v128_f32", dtt, ft,
                      "float32", card, unit="s"))
    for nv_, jc in ((128, 8), (192, 1)):
        dtt, ft = bench_triples(no=32, nv=nv_, slab_dtype=jnp.bfloat16,
                                jc=jc)
        extra.append(_row("triples_T_scan_wall_o32_v%d_bf16_jc%d"
                          % (nv_, jc), dtt, ft, "bfloat16", card, unit="s"))
    # scaling curves: DF-CCSD s/iter and (T) wall vs (o, v)
    from pycc_tpu.models.dfccsd import _ladder_blocks
    for no_, nv_ in DF_CURVE:
        naux_ = 3 * (no_ + nv_)
        dtc, fc = bench_df(no=no_, nv=nv_, naux=naux_,
                           nblocks=_ladder_blocks(nv_, naux_))
        extra.append(_row("dfccsd_iteration_o%d_v%d_bf16" % (no_, nv_),
                          dtc, fc, "bfloat16", card))
    for no_, nv_ in T_CURVE:
        dtc, fc = bench_triples(no=no_, nv=nv_)
        extra.append(_row("triples_T_scan_wall_o%d_v%d_f32" % (no_, nv_),
                          dtc, fc, "float32", card, unit="s"))
    if os.path.exists(REAL_NPZ):
        dtr, fr, cfg = bench_real_molecule(REAL_NPZ)
        extra.append(_row(
            "dfccsd_real_w10_augccpvdz_410bf_o%(no)d_v%(nv)d_"
            "naux%(naux)d_f32" % cfg, dtr, fr, "float32", card))
    out["extra"] = extra
    print(json.dumps(out))


if __name__ == "__main__":
    main()
