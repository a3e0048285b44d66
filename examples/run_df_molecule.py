"""Solve DF-CCSD on the device from prepared factors (device half of the
prepare-on-host / solve-on-device pipeline; see prepare_df_molecule.py).

Loads the .npz (B factors, MO Fock, no, escf), constructs the solver via
ccwfn.from_df_factors, and iterates to convergence on the chip.  With
--post it then builds the DF-HBAR and solves Lambda (and optionally a few
EOM roots) — the post-convergence stack the dense reference cannot reach
at this size (/root/reference/pycc/hamiltonian.py:36-39).

Usage:
    python examples/run_df_molecule.py df_cache/w7aug.npz \
        --precision SP --nblocks 16 --e-conv 1e-7 --r-conv 1e-6 --post
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("npz")
    ap.add_argument("--model", default="CCSD",
                    help="CCD/CC2/CCSD/CCSD(T)/CC3 — every canonical "
                         "model runs from factors (CC3 via the dressed-W "
                         "slab scan, models/cc3.py)")
    ap.add_argument("--precision", default="SP")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-precision solve (solve_cc_mixed): f32 to "
                         "its noise floor, then f64 refinement to --e-conv "
                         "— the at-scale accuracy-recovery path (implies "
                         "a DP construction)")
    ap.add_argument("--sp-conv", type=float, default=1e-6,
                    help="floor-stage tolerance for --mixed")
    ap.add_argument("--refine-maxiter", type=int, default=12,
                    help="f64-stage iteration cap for --mixed")
    ap.add_argument("--refine-max-diis", type=int, default=0,
                    help="DIIS depth for the f64 refinement stage (default "
                         "0: an f64 ring is max_diis o^2v^2 pairs — 13 GB "
                         "at (40,360) depth 4 — and Jacobi from the f32 "
                         "floor converges in a handful of steps)")
    ap.add_argument("--nblocks", type=int, default=None)
    ap.add_argument("--e-conv", type=float, default=1e-7)
    ap.add_argument("--r-conv", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--max-diis", type=int, default=8,
                    help="DIIS depth (the on-device ring holds 2*max_diis "
                         "t2-sized buffers; shrink at nact >= 400)")
    ap.add_argument("--post", action="store_true",
                    help="DF-HBAR + Lambda after convergence")
    ap.add_argument("--triples", action="store_true",
                    help="(T) energy from factor-assembled slices after "
                         "the solve (no dense ERI anywhere; working set "
                         "~2 x no*nv^3)")
    ap.add_argument("--eom", type=int, default=0,
                    help="number of EOM-CCSD roots (0 = skip)")
    ap.add_argument("--eom-e-conv", type=float, default=1e-6)
    ap.add_argument("--eom-r-conv", type=float, default=1e-5,
                    help="root/residual tolerances (SP at scale bottoms "
                         "out near 1e-3 residual norms; loosen there)")
    ap.add_argument("--eom-guess", default="UNIT",
                    help="UNIT (orbital-energy diagonal; the at-scale "
                         "choice) or HBAR_SS (dense (no*nv)^2 host eig — "
                         "hours at nact >= 400)")
    ap.add_argument("--eom-maxiter", type=int, default=40)
    ap.add_argument("--response", action="store_true",
                    help="after Lambda: solve the MU_Z right+left perturbed "
                         "amplitudes at --omega and assemble alpha_zz "
                         "(needs mu in the npz; see prepare_df_molecule)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke tests)")
    ap.add_argument("--omega", type=float, default=0.0656)
    ap.add_argument("--resp-conv", type=float, default=1e-5)
    ap.add_argument("--chk", default=None,
                    help="checkpoint base path: the solve auto-saves its "
                         "state every --chk-every iterations (mixed runs "
                         "write per-stage files <base>.sp/.floor/.rf.npz) "
                         "so a killed capture relaunches with --resume "
                         "instead of restarting")
    ap.add_argument("--chk-every", type=int, default=20,
                    help="iterations between checkpoints (each writes an "
                         "o^2v^2 amplitude set to the host)")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()
    print("args: %s" % vars(args))
    model = args.model.upper()
    if args.triples and model not in ("CCSD", "CCSD(T)"):
        ap.error("--triples computes the (T) correction from CCSD "
                 "amplitudes; use --model CCSD or CCSD(T) (got %s)" % model)
    if (args.eom or args.response) and model not in ("CCSD", "CCSD(T)"):
        ap.error("--eom/--response run the EOM-CCSD/CCSD-response "
                 "equations over the CCSD HBAR; got --model %s" % model)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from pycc_tpu.utils import setup_compile_cache
    setup_compile_cache()
    import pycc_tpu

    d = np.load(args.npz, allow_pickle=True)
    B, F, no = d["B"], d["F"], int(d["no"])
    print("loaded %s: naux=%d nact=%d no=%d nv=%d nbf=%d escf=%.10f"
          % (args.npz, B.shape[0], B.shape[1], no, B.shape[1] - no,
             int(d["nbf"]), float(d["escf"])))
    sys.stdout.flush()

    precision = "DP" if args.mixed else args.precision
    cc = pycc_tpu.ccwfn.from_df_factors(
        B, F, no, escf=float(d["escf"]), model=args.model,
        precision=precision, df_nblocks=args.nblocks)
    t0 = time.time()
    chk_kw = ({"chk": args.chk, "chk_every": args.chk_every,
               "resume": args.resume} if args.chk else {})
    if args.mixed:
        ecc = cc.solve_cc_mixed(e_conv=args.e_conv, r_conv=args.r_conv,
                                maxiter=args.maxiter, sp_conv=args.sp_conv,
                                refine_maxiter=args.refine_maxiter,
                                max_diis=args.max_diis,
                                refine_kwargs={
                                    "max_diis": args.refine_max_diis},
                                **chk_kw)
    else:
        ecc = cc.solve_cc(e_conv=args.e_conv, r_conv=args.r_conv,
                          maxiter=args.maxiter, max_diis=args.max_diis,
                          **chk_kw)
    t_solve = time.time() - t0
    row = {
        "molecule": str(d["molname"]), "basis": str(d["basis"]),
        "nbf": int(d["nbf"]), "no": no, "nv": B.shape[1] - no,
        "naux": int(B.shape[0]), "model": args.model,
        "precision": precision,
        "e_corr": float(ecc), "e_total": float(d["escf"]) + float(ecc),
        "converged": bool(cc.converged), "t_solve_s": round(t_solve, 2)}
    if args.mixed:
        row["mixed"] = True
        row["e_sp_floor"] = cc.e_sp_floor
        row["refinement_dE"] = float(ecc) - cc.e_sp_floor
    print(json.dumps(row))
    sys.stdout.flush()

    if args.triples:
        from pycc_tpu.triples import t_vikings_scan
        t0 = time.time()
        et = float(t_vikings_scan(cc))
        print(json.dumps({"e_t": et, "e_ccsd_t": float(ecc) + et,
                          "t_triples_s": round(time.time() - t0, 2)}))
        sys.stdout.flush()

    if args.post:
        t0 = time.time()
        hbar = pycc_tpu.cchbar(cc)
        lam = pycc_tpu.cclambda(cc, hbar)
        lecc = lam.solve_lambda(e_conv=args.e_conv, r_conv=args.r_conv,
                                maxiter=args.maxiter,
                                max_diis=args.max_diis)
        print(json.dumps({"lambda_pseudo_e": float(lecc),
                          "lambda_converged": bool(lam.converged),
                          "t_post_s": round(time.time() - t0, 2)}))
        sys.stdout.flush()
        if "mu" in d:
            # correlation contribution to the electric dipole from the
            # unrelaxed CCSD one-pdm (no v^4 object: onlyone path)
            import jax.numpy as jnp
            from pycc_tpu.ccdensity import onepdm
            from pycc_tpu.ops.contract import contract
            t0 = time.time()
            if cc.model == "CC3":
                from pycc_tpu.models.cc3 import cc3_onepdm_rows
                opdm, opdm_cc3 = cc3_onepdm_rows(cc, cc.t1, cc.t2,
                                                 lam.l1, lam.l2)
                opdm = opdm + opdm_cc3
            else:
                opdm = onepdm(cc.model if cc.model != "CCSD(T)" else "CCSD",
                              cc.t1, cc.t2, lam.l1, lam.l2, cc.no, cc.nact)
            mu_d = np.asarray(d["mu"], np.float32
                              if args.precision == "SP" else np.float64)
            mu_corr = [float(np.real(contract(
                "pq,pq->", jnp.asarray(mu_d[k]), opdm))) for k in range(3)]
            print(json.dumps({"dipole_corr_au": mu_corr,
                              "t_onepdm_s": round(time.time() - t0, 2)}))
            sys.stdout.flush()
        if args.response:
            import dataclasses
            from types import SimpleNamespace
            if "mu" not in d:
                raise SystemExit("npz has no dipole integrals; re-run "
                                 "examples/prepare_df_molecule.py")
            import jax.numpy as jnp
            mu = jnp.asarray(np.asarray(
                d["mu"], np.float32 if args.precision == "SP"
                else np.float64))
            cc.H = dataclasses.replace(cc.H, mu=mu)
            resp = pycc_tpu.ccresponse(SimpleNamespace(ccwfn=cc,
                                                       cclambda=lam))
            t0 = time.time()
            X1, X2, pX = resp.solve_right(
                resp.pertbar["MU_Z"], args.omega, e_conv=args.resp_conv,
                r_conv=args.resp_conv, maxiter=args.maxiter)
            t_x = round(time.time() - t0, 2)
            t0 = time.time()
            Y1, Y2, pY = resp.solve_left(
                resp.pertbar["MU_Z"], args.omega, e_conv=args.resp_conv,
                r_conv=args.resp_conv, maxiter=args.maxiter)
            t_y = round(time.time() - t0, 2)
            lrzz = float(np.real(resp.linresp_asym("MU_Z", X1, X2, Y1, Y2)))
            print(json.dumps({"lr_mu_z_mu_z": lrzz, "omega": args.omega,
                              "pseudoresponse_right": float(np.real(pX)),
                              "t_solve_right_s": t_x,
                              "t_solve_left_s": t_y}))
            sys.stdout.flush()
        if args.eom:
            t0 = time.time()
            eom = pycc_tpu.cceom(hbar)
            E, _ = eom.solve_eom(N=args.eom, e_conv=args.eom_e_conv,
                                 r_conv=args.eom_r_conv,
                                 maxiter=args.eom_maxiter,
                                 guess=args.eom_guess)
            print(json.dumps({"eom_roots_eh": [float(x) for x in E],
                              "eom_converged": bool(eom.converged),
                              "t_eom_s": round(time.time() - t0, 2)}))


if __name__ == "__main__":
    main()
