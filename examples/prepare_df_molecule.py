"""Host-side preparation for an at-scale DF-CCSD run on a REAL molecule.

Runs the full dense-free pipeline on the host:
    integral-direct DF-SCF  ->  AO Cholesky factor reuse  ->
    MO transform  ->  active-space recompression
and saves everything the on-chip solver needs to an .npz:
    B    (naux, nact, nact) float32 Cholesky factors
    F    (nact, nact) float64 MO Fock
    no   active occupied count
    escf converged SCF total energy

No four-index tensor exists at any point (the round-2 pipeline needed a
dense nact^4 ERI as factorization input).

Usage:
    python examples/prepare_df_molecule.py --mol '(H2O)_7' --basis aug-cc-pvdz \
        --df-tol 1e-6 --scf-tol 1e-7 --out w7aug.npz
    python examples/prepare_df_molecule.py --waters 10 --basis aug-cc-pvdz ...
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
    ap.add_argument("--mol", default=None, help="moldict key")
    ap.add_argument("--waters", type=int, default=None,
                    help="tiled water-cluster size (data.molecules.water_cluster)")
    ap.add_argument("--basis", default="cc-pvdz")
    ap.add_argument("--df-tol", type=float, default=1e-6)
    ap.add_argument("--scf-tol", type=float, default=1e-7)
    ap.add_argument("--out", required=True)
    ap.add_argument("--no-recompress", action="store_true",
                    help="skip the active-space pivoted recompression "
                    "(it cost 3540 s for a 13%% naux cut on the 410-bf "
                    "(H2O)_10 prep; the solver only pays linearly in naux)")
    args = ap.parse_args()

    from pycc_tpu.data.molecules import moldict, water_cluster
    from pycc_tpu.ops.cholesky import recompress_factors
    from pycc_tpu.scf import run_rhf
    from pycc_tpu.scf.df import factors_to_mo

    geom = water_cluster(args.waters) if args.waters else moldict[args.mol]
    t0 = time.time()
    wfn = run_rhf(geom, args.basis, freeze_core=True, df=True,
                  df_tol=args.scf_tol, e_conv=1e-9, d_conv=1e-7,
                  verbose=True)
    t_scf = time.time() - t0
    print("SCF E = %.10f  (%.1f s)" % (wfn.energy(), t_scf))
    sys.stdout.flush()

    t0 = time.time()
    C_act = np.asarray(wfn.Ca_subset("AO", "ACTIVE"))
    B_mo = factors_to_mo(wfn.B_ao, C_act)
    t_mo = time.time() - t0
    print("MO transform: naux=%d nact=%d  (%.1f s)"
          % (B_mo.shape[0], B_mo.shape[1], t_mo))
    sys.stdout.flush()

    t0 = time.time()
    if args.no_recompress:
        B = B_mo
        t_rc = 0.0
        print("recompression skipped: naux stays %d" % B.shape[0])
    else:
        B = recompress_factors(B_mo, tol=args.df_tol)
        t_rc = time.time() - t0
        print("recompressed: naux %d -> %d  (%.1f s)"
              % (B_mo.shape[0], B.shape[0], t_rc))

    F = C_act.T @ np.asarray(wfn.Fa()) @ C_act
    no = wfn.doccpi()[0] - wfn.frzcpi()[0]
    # MO electric-dipole integrals: lets run_df_molecule --response solve
    # perturbed amplitudes / a polarizability component from the factors
    from pycc_tpu.scf import integrals as ints
    mu = np.stack([C_act.T @ M @ C_act
                   for M in ints.dipole(wfn.basisset())])
    np.savez_compressed(
        args.out, B=B.astype(np.float32), F=F, no=no, mu=mu,
        escf=wfn.energy(), nbf=wfn.basisset().nbf,
        basis=args.basis, molname=args.mol or ("(H2O)_%d" % args.waters),
        t_scf=t_scf, t_mo=t_mo, t_rc=t_rc)
    print("saved", args.out)


if __name__ == "__main__":
    main()
