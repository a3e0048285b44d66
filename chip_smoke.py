"""Smoke run of the main path on an NVIDIA GPU.

    python chip_smoke.py            # phases 0-3 on one GPU
    python chip_smoke.py --gpus 4   # the 2x2-mesh DF-CCSD solve vs one GPU

Phase 0  the device: a GPU, or the script stops.
Phase 1  frozen H2O/cc-pVDZ oracles in f64: CCSD, (T), Lambda, density;
         blocked and DF storage; RT-CCSD on He in complex128.
Phase 2  (H2O)_6/aug-cc-pVDZ (246 basis functions, (o, v) = (24, 216))
         through DF-SCF -> DF-CCSD(T) -> HBAR -> Lambda -> density and
         dipole in f64, with the first residual checked against the CPU
         backend of the same process.
Phase 3  the same factors in f32, at the default matmul precision (which
         may run f32 dots as TF32) and at "highest".

Each phase prints its results before the next starts; a failed check
raises and the script exits non-zero.  The last line of standard output
is one JSON object naming the device.  Everything runs in this one
process; only `nvidia-smi` runs as a child, and it does not touch JAX.
"""

import argparse
import json
import os
import sys
import time

# Frozen oracles (BASELINE.md; tests/test_005, test_008).  The tests hold
# them to 1e-11 on the CPU; the GPU sums in another order, so 1e-10 here.
E_CCSD_H2O_DZ = -0.222029814166783
E_T_H2O_DZ = -0.003861236558801
E_LAMBDA_H2O_DZ = -0.217838951550509
MU_Z_HE_RT = 0.008400738202694
ORACLE_TOL = 1e-10

H2O = "O\nH 1 1.1\nH 1 1.1 2 104\nsymmetry c1"   # moldict["H2O"]
MOLECULE = "(H2O)_6"
BASIS = "aug-cc-pvdz"
DF_TOL = 1e-6
SP_GAP_TOL = 1e-4   # f32-floor energy wobbles of ~4e-5 Eh were seen at 287 bf


def check(label, value, ref, tol):
    """|value - ref| <= tol, else raise; returns the error."""
    err = abs(value - ref)
    if not err <= tol:
        raise AssertionError("%s: %.15f vs %.15f (|d| = %.3e > %.1e)"
                             % (label, value, ref, err, tol))
    return err


def peak_gb(dev):
    """Peak device bytes in use so far, in GB (0 where not reported)."""
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", 0) / 1e9


def say(*lines):
    for ln in lines:
        print(ln)
    sys.stdout.flush()


def phase0(dev, devices):
    import jax
    from pycc_tpu.utils import setup_compile_cache
    from pycc_tpu.utils.device import card_info

    cache = setup_compile_cache()
    say("card: %s" % card_info(),
        "phase 0 device: kind=%s count=%d jax=%s XLA_FLAGS=%r cache=%s"
        % (dev.device_kind, len(devices), jax.__version__,
           os.environ.get("XLA_FLAGS", ""), cache))


def phase1(dev):
    """H2O/cc-pVDZ oracles through the dense, blocked and DF paths, and
    RT-CCSD on He, all in f64 on the card."""
    import numpy as np
    from scipy.integrate import complex_ode

    import pycc_tpu
    from pycc_tpu.rt.lasers import sine_square_laser
    from pycc_tpu.scf import run_rhf

    t0 = time.perf_counter()
    wfn = run_rhf(H2O, "cc-pvdz", freeze_core=True)
    cc = pycc_tpu.ccwfn(wfn, model="CCSD(T)")
    e_tot = cc.solve_cc(e_conv=1e-12, r_conv=1e-12)
    e_ccsd = float(cc.cc_energy(cc.t1, cc.t2))
    d_ccsd = check("CCSD", e_ccsd, E_CCSD_H2O_DZ, ORACLE_TOL)
    d_t = check("(T)", e_tot - e_ccsd, E_T_H2O_DZ, ORACLE_TOL)

    # the Lambda oracle is the CCSD one: CCSD(T)'s Lambda carries the
    # (T) source terms.  The density energy of either equals its
    # amplitude energy (the Lagrangian at zero residual), which for
    # CCSD(T) includes E(T).
    hb = pycc_tpu.cchbar(cc)
    lam_t = pycc_tpu.cclambda(cc, hb)
    lam_t.solve_lambda(e_conv=1e-12, r_conv=1e-12)
    d_dens_t = check("CCSD(T) density energy",
                     pycc_tpu.ccdensity(cc, lam_t).compute_energy(),
                     e_tot, ORACLE_TOL)
    cc2 = pycc_tpu.ccwfn(wfn, model="CCSD")
    cc2.solve_cc(e_conv=1e-12, r_conv=1e-12)
    lam = pycc_tpu.cclambda(cc2, pycc_tpu.cchbar(cc2))
    e_lam = lam.solve_lambda(e_conv=1e-12, r_conv=1e-12)
    d_lam = check("Lambda pseudo-energy", e_lam, E_LAMBDA_H2O_DZ,
                  ORACLE_TOL)
    e_dens = pycc_tpu.ccdensity(cc2, lam).compute_energy()
    d_dens = check("CCSD density energy", e_dens,
                   float(cc2.cc_energy(cc2.t1, cc2.t2)), ORACLE_TOL)

    e_blk = pycc_tpu.ccwfn(wfn, storage="blocked").solve_cc(1e-12, 1e-12)
    d_blk = check("blocked CCSD", e_blk, E_CCSD_H2O_DZ, ORACLE_TOL)
    wfn_df = run_rhf(H2O, "cc-pvdz", freeze_core=True, df=True,
                     df_tol=1e-10)
    e_df = pycc_tpu.ccwfn(wfn_df, storage="df", df_tol=1e-10).solve_cc(
        1e-10, 1e-10)
    d_df = check("DF CCSD", e_df, E_CCSD_H2O_DZ, 1e-9)   # test_017's bound

    # RT-CCSD, He/cc-pVDZ, sine^2 pulse to t = 1 au (test_008)
    wfn_he = run_rhf("He\nsymmetry c1", "cc-pvdz", freeze_core=False)
    he = pycc_tpu.ccwfn(wfn_he)
    he.solve_cc(1e-13, 1e-13)
    he_lam = pycc_tpu.cclambda(he, pycc_tpu.cchbar(he))
    he_lam.solve_lambda(1e-13, 1e-13)
    rt = pycc_tpu.rtcc(he, he_lam, pycc_tpu.ccdensity(he, he_lam),
                       sine_square_laser(1.0, 2.87, 5.0), ri_split=False)
    y0 = rt.collect_amps(he.t1, he.t2, he_lam.l1, he_lam.l2,
                         0).astype("complex128")
    ode = complex_ode(rt.f).set_integrator("vode", atol=1e-13, rtol=1e-13)
    ode.set_initial_value(y0, 0)
    y = y0
    while ode.successful() and ode.t < 1.0:
        y = ode.integrate(ode.t + 0.01)
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    mu_z = float(np.real(rt.dipole(t1, t2, l1, l2)[2]))
    d_rt = check("RT-CCSD mu_z", mu_z, MU_Z_HE_RT, ORACLE_TOL)

    say("phase 1 oracles (|d| vs frozen values, f64 on %s): CCSD %.1e  "
        "(T) %.1e  Lambda %.1e  density(CCSD) %.1e  density(CCSD(T)) "
        "%.1e  blocked %.1e  DF %.1e  RT mu_z %.1e  wall %.1f s  "
        "peak %.2f GB"
        % (dev.device_kind, d_ccsd, d_t, d_lam, d_dens, d_dens_t, d_blk,
           d_df, d_rt, time.perf_counter() - t0, peak_gb(dev)))


def prepare_molecule():
    """DF-SCF of the phase-2 molecule on the host with the native
    integral engine; never the dense fallback."""
    from pycc_tpu.data import moldict
    from pycc_tpu.scf import native, run_rhf

    if not native.available():
        raise RuntimeError("native integral engine unavailable: the "
                           "dense host fallback cannot hold %s" % MOLECULE)
    t0 = time.perf_counter()
    wfn = run_rhf(moldict[MOLECULE], BASIS, freeze_core=True, df=True)
    return wfn, time.perf_counter() - t0


def residual_gap(cc, cpu):
    """max |r_gpu - r_cpu| / max |r| of the DF-CCSD residual at the
    solver's current amplitudes, the same program on both backends."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pycc_tpu.models import dfccsd

    fn = jax.jit(dfccsd.residuals_ccsd_df, static_argnames=("no", "nblocks"))
    args = (jnp.asarray(cc.H.F), cc.dfb, cc.t1, cc.t2)
    r_gpu = [np.asarray(r) for r in fn(*args, no=cc.no,
                                       nblocks=cc._df_nblocks)]
    r_cpu = [np.asarray(r) for r in fn(*jax.device_put(args, cpu),
                                       no=cc.no, nblocks=cc._df_nblocks)]
    scale = max(np.abs(r).max() for r in r_gpu)
    delta = max(np.abs(a - b).max() for a, b in zip(r_gpu, r_cpu))
    return delta / scale


def phase2(dev, cpu):
    """The main path at full width in f64; returns what phase 3 reuses."""
    import jax
    import numpy as np

    import pycc_tpu
    from pycc_tpu.utils import timers

    wfn, t_scf = prepare_molecule()
    timers.reset()
    t0 = time.perf_counter()
    cc = pycc_tpu.ccwfn(wfn, model="CCSD(T)", storage="df", precision="DP",
                        df_tol=DF_TOL)
    jax.block_until_ready(cc.t2)
    t_prep = time.perf_counter() - t0
    say("phase 2 prep: %s/%s nbf=%d (o,v)=(%d,%d) naux=%d  host SCF "
        "(incl. AO Cholesky) %.1f s  MO transform + recompression + "
        "MP2 guess %.1f s  peak %.2f GB"
        % (MOLECULE, BASIS, wfn.nmo(), cc.no, cc.nv, cc.naux, t_scf,
           t_prep, peak_gb(dev)))

    t0 = time.perf_counter()
    rel = residual_gap(cc, cpu)
    if not rel <= 1e-10:
        raise AssertionError("GPU vs CPU DF-CCSD residual: max|dr|/max|r| "
                             "= %.3e > 1e-10" % rel)
    say("phase 2 residual GPU vs CPU at the MP2 guess: max|dr|/max|r| = "
        "%.2e (<= 1e-10)  wall %.1f s" % (rel, time.perf_counter() - t0))

    # the density energy equals the amplitude energy to first order in
    # the amplitude residual: r_conv 1e-9 keeps that gap under 1e-9
    t0 = time.perf_counter()
    e_tot = cc.solve_cc(e_conv=1e-8, r_conv=1e-9)
    t_solve = time.perf_counter() - t0
    if not cc.converged:
        raise AssertionError("DF-CCSD did not converge")
    e_ccsd = float(cc.cc_energy(cc.t1, cc.t2))
    n_it = timers.count["ccwfn.iteration"]
    first = timers.first["ccwfn.iteration"]
    t_triples = timers.total["ccwfn.triples"]
    # the last iteration's timer also covers the (T) evaluation
    steady = ((timers.total["ccwfn.iteration"] - first - t_triples)
              / max(n_it - 1, 1))
    say("phase 2 CCSD(T): Ecorr(CCSD) = %.10f  E(T) = %.10f  %d iterations"
        "  solve wall %.1f s  first step (incl. compile) %.2f s  steady "
        "%.3f s/iter  (T) %.1f s  peak %.2f GB"
        % (e_ccsd, e_tot - e_ccsd, n_it, t_solve, first, steady,
           t_triples, peak_gb(dev)))

    t0 = time.perf_counter()
    hb = pycc_tpu.cchbar(cc)
    jax.block_until_ready(hb.hbar if hasattr(hb, "hbar") else hb)
    t_hbar = time.perf_counter() - t0
    t0 = time.perf_counter()
    lam = pycc_tpu.cclambda(cc, hb)
    e_lam = lam.solve_lambda(e_conv=1e-8, r_conv=1e-7)
    t_lam = time.perf_counter() - t0
    if not lam.converged:
        raise AssertionError("DF-Lambda did not converge")
    n_lam = timers.count["lambda.iteration"]
    t_lam_it = timers.total["lambda.iteration"]
    first_lam = timers.first["lambda.iteration"]
    say("phase 2 Lambda: pseudo-energy %.10f  HBAR %.1f s  Lambda %.1f s "
        "= setup incl. (T) sources %.1f s + %d iterations (first %.2f s, "
        "steady %.3f s/iter)  peak %.2f GB"
        % (e_lam, t_hbar, t_lam, t_lam - t_lam_it, n_lam, first_lam,
           (t_lam_it - first_lam) / max(n_lam - 1, 1),
           peak_gb(dev)))

    t0 = time.perf_counter()
    dens = pycc_tpu.ccdensity(cc, lam)
    e_dens = dens.compute_energy()
    d_dens = check("density energy", e_dens, e_tot, 1e-9)
    opdm = np.asarray(dens.compute_onepdm(cc.t1, cc.t2, lam.l1, lam.l2))
    mu_corr = [float(np.sum(opdm * np.asarray(m))) for m in cc.H.mu]
    if not np.all(np.isfinite(mu_corr)):
        raise AssertionError("non-finite correlation dipole %r" % mu_corr)
    say("phase 2 density: E(density) - E(CCSD(T)) = %.2e (<= 1e-9)  "
        "correlation dipole (%.6f, %.6f, %.6f) au  wall %.1f s  "
        "peak %.2f GB"
        % (d_dens, *mu_corr, time.perf_counter() - t0,
           peak_gb(dev)))
    return cc, e_ccsd


def factors_of(cc):
    """The solver's MO Cholesky factors as one host (naux, nact, nact)."""
    import numpy as np
    Boo, Bov, Bvv = (np.asarray(x) for x in (cc.dfb.Boo, cc.dfb.Bov,
                                             cc.dfb.Bvv))
    return np.concatenate([np.concatenate([Boo, Bov], axis=2),
                           np.concatenate([Bov.transpose(0, 2, 1), Bvv],
                                          axis=2)], axis=1)


def phase3(dev, cc, e_dp):
    """f32 solves from the phase-2 factors: default matmul precision
    (reported, not gated) and "highest" (gated)."""
    import contextlib

    import jax
    import numpy as np

    import pycc_tpu

    B, F, no, escf = factors_of(cc), np.asarray(cc.H.F), cc.no, cc.eref
    gaps = {}
    for label, ctx in (("default", contextlib.nullcontext()),
                       ("highest", jax.default_matmul_precision("highest"))):
        t0 = time.perf_counter()
        with ctx:
            sp = pycc_tpu.ccwfn.from_df_factors(B, F, no, escf=escf,
                                                model="CCSD", precision="SP")
            e_sp = float(sp.solve_cc(e_conv=1e-7, r_conv=1e-6))
        gaps[label] = abs(e_sp - e_dp)
        say("phase 3 SP (%s matmul precision): Ecorr = %.10f  |E_SP - E_DP| "
            "= %.3e  converged=%s  wall %.1f s  peak %.2f GB"
            % (label, e_sp, gaps[label], sp.converged,
               time.perf_counter() - t0, peak_gb(dev)))
        del sp
    if not gaps["highest"] <= SP_GAP_TOL:
        raise AssertionError("SP (highest) energy gap %.3e > %.0e Eh"
                             % (gaps["highest"], SP_GAP_TOL))


def phase_mesh(devices):
    """The phase-2 DF-CCSD f64 solve over a 2x2 mesh of four GPUs against
    the same solve on one of them, from the same factors."""
    import jax
    import numpy as np

    import pycc_tpu
    from pycc_tpu.parallel import make_mesh

    if len(devices) < 4:
        raise RuntimeError("--gpus 4 needs four GPUs; JAX sees %d"
                           % len(devices))
    wfn, t_scf = prepare_molecule()
    mesh = make_mesh(devices=devices[:4], shape=(2, 2))
    cc = pycc_tpu.ccwfn(wfn, model="CCSD", storage="df", precision="DP",
                        df_tol=DF_TOL, mesh=mesh)
    for name, x in (("Bvv", cc.dfb.Bvv), ("t2", cc.t2)):
        shard = x.sharding.shard_shape(x.shape)
        if shard == x.shape:
            raise AssertionError("%s is not split over the mesh: shard %s "
                                 "== global %s" % (name, shard, x.shape))
        say("phase 4 sharding: %s global %s shard %s"
            % (name, x.shape, shard))
    walls, energies = {}, {}
    t0 = time.perf_counter()
    energies["mesh"] = float(cc.solve_cc(e_conv=1e-8, r_conv=1e-7))
    walls["mesh"] = time.perf_counter() - t0
    peaks = ", ".join("%.2f" % peak_gb(d) for d in devices[:4])
    if not cc.converged:
        raise AssertionError("mesh DF-CCSD did not converge")
    B, F, no, escf = factors_of(cc), np.asarray(cc.H.F), cc.no, cc.eref
    del cc
    jax.clear_caches()

    one = pycc_tpu.ccwfn.from_df_factors(B, F, no, escf=escf, model="CCSD",
                                         precision="DP")
    t0 = time.perf_counter()
    energies["one"] = float(one.solve_cc(e_conv=1e-8, r_conv=1e-7))
    walls["one"] = time.perf_counter() - t0
    if not one.converged:
        raise AssertionError("one-GPU DF-CCSD did not converge")
    de = abs(energies["mesh"] - energies["one"])
    if not de <= 1e-10:
        raise AssertionError("mesh vs one-GPU DF-CCSD: |dE| = %.3e > 1e-10"
                             % de)
    say("phase 4 mesh: Ecorr %.12f  |dE(mesh - one GPU)| = %.2e (<= 1e-10)"
        "  solve wall (incl. compile) mesh %.1f s, one GPU %.1f s  host "
        "SCF %.1f s  peak GB per device after the mesh solve %s"
        % (energies["one"], de, walls["mesh"], walls["one"], t_scf, peaks))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1,
                    help="4: run only the 2x2-mesh solve and its "
                         "one-GPU comparison")
    args = ap.parse_args(argv)

    import jax
    from pycc_tpu.utils.device import require_gpu

    devices = jax.devices()
    dev = require_gpu(devices)
    import pycc_tpu

    pycc_tpu.set_verbosity("quiet")
    t0 = time.perf_counter()
    phase0(dev, devices)
    if args.gpus == 4:
        phase_mesh(devices)
        count = 4
    else:
        phase1(dev)
        cc, e_dp = phase2(dev, jax.devices("cpu")[0])
        phase3(dev, cc, e_dp)
        count = 1
    say("all phases passed in %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))


if __name__ == "__main__":
    main()
