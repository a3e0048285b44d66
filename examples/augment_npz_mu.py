"""Add MO dipole integrals to an existing prepared-factors .npz.

The factor build (AO Cholesky + MO transform + recompression) is the
expensive part of prepare_df_molecule.py; the dipole integrals only need
the converged MO coefficients.  This re-runs the (much cheaper) SCF to
recover C_act, computes mu, and rewrites the .npz with the extra key —
so old archives gain --response/--post dipole support without a full
re-preparation.

Usage: python examples/augment_npz_mu.py df_cache/w10aug.npz --waters 10 \
           --basis aug-cc-pvdz --scf-tol 1e-7
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("npz")
    ap.add_argument("--mol", default=None)
    ap.add_argument("--waters", type=int, default=None)
    ap.add_argument("--basis", default="cc-pvdz")
    ap.add_argument("--scf-tol", type=float, default=1e-7)
    args = ap.parse_args()

    from pycc_tpu.data.molecules import moldict, water_cluster
    from pycc_tpu.scf import run_rhf
    from pycc_tpu.scf import integrals as ints

    d = dict(np.load(args.npz, allow_pickle=True))
    if "mu" in d:
        print("npz already has mu; nothing to do")
        return
    geom = water_cluster(args.waters) if args.waters else moldict[args.mol]
    t0 = time.time()
    wfn = run_rhf(geom, args.basis, freeze_core=True, df=True,
                  df_tol=args.scf_tol, e_conv=1e-9, d_conv=1e-7,
                  verbose=True)
    print("SCF E = %.10f (stored %.10f)  %.1f s"
          % (wfn.energy(), float(d["escf"]), time.time() - t0))
    if abs(wfn.energy() - float(d["escf"])) > 1e-6:
        raise SystemExit("SCF does not reproduce the stored escf — "
                         "geometry/basis/tol mismatch; refusing to mix")
    C_act = np.asarray(wfn.Ca_subset("AO", "ACTIVE"))
    # the stored factors live in the ORIGINAL run's MO basis: require the
    # re-derived active Fock to match (catches orbital rotations; sign
    # flips are excluded by the deterministic single-threaded eigensolve)
    F_new = C_act.T @ np.asarray(wfn.Fa()) @ C_act
    dF = np.abs(F_new - d["F"]).max()
    print("max|F_new - F_stored| = %.3e" % dF)
    if dF > 1e-6:
        raise SystemExit("active MO Fock mismatch — the re-run landed in "
                         "a different MO basis; refusing to mix")
    mu = np.stack([C_act.T @ M @ C_act
                   for M in ints.dipole(wfn.basisset())])
    d["mu"] = mu
    np.savez_compressed(args.npz, **d)
    print("rewrote %s with mu %s" % (args.npz, mu.shape))


if __name__ == "__main__":
    main()
