"""Lambda-amplitude solver: left-hand eigenvector of HBAR.

Functional rebuild of /root/reference/pycc/cclambda.py:17-581.  The residual
is a pure function of (hbar, t, l); the solver reuses the same jitted
DIIS/Jacobi scaffold as the T-amplitude solver.  The standalone
`lambda_residuals_from_F` entry rebuilds HBAR from a (possibly
field-dressed) Fock matrix for the real-time module.
"""

import os
import time
import warnings
from functools import partial

import jax
import jax.numpy as jnp

from .cchbar import build_hbar
from .models.ccsd import build_tau, slices, vvvv_contract_efab
from .ops.contract import contract
from .ops.diis import DIIS
from .utils.timing import timers
from .utils.log import logger as log


def build_Goo(t2, l2):
    return contract("mjab,ijab->mi", t2, l2)


def build_Gvv(t2, l2):
    return -1.0 * contract("ijeb,ijab->ae", t2, l2)


def lambda_residuals(model, hb, F, ERI, L, t1, t2, l1, l2, no,
                     S1=None, S2=None):
    """r_L1, r_L2 for CCD/CC2/CCSD (+ optional (T) source terms S1/S2)."""
    o, v = slices(no)
    Goo = build_Goo(t2, l2)
    Gvv = build_Gvv(t2, l2)
    ccd = model == "CCD"
    cc2 = model == "CC2"

    Hovvo_s = 2.0 * hb.Hovvo - hb.Hovov.swapaxes(2, 3)

    if ccd:
        from .ops.ctensor import ct_zeros_like
        r1 = ct_zeros_like(l1)
    else:
        r1 = 2.0 * hb.Hov
        if S1 is not None:
            r1 = r1 + S1
        r1 += contract("ie,ea->ia", l1, hb.Hvv)
        r1 -= contract("ma,im->ia", l1, hb.Hoo)
        r1 += contract("imef,efam->ia", l2, hb.Hvvvo)
        r1 -= contract("mnae,iemn->ia", l2, hb.Hovoo)
        r1 += contract("me,ieam->ia", l1, Hovvo_s)
        if cc2:
            tmp = contract("me,nmfe->nf", l1, t2)
            r1 += contract("nf,inaf->ia", tmp, 2.0 * L[o, o, v, v])
            tmp = contract("me,mnfe->nf", l1, build_tau(t1, t2))
            r1 -= contract("nf,inaf->ia", tmp, 2.0 * ERI[o, o, v, v])
            r1 += contract("nf,inaf->ia", tmp, ERI[o, o, v, v].swapaxes(2, 3))
        else:
            r1 -= 2.0 * contract("ef,eifa->ia", Gvv, hb.Hvovv)
            r1 += contract("ef,eiaf->ia", Gvv, hb.Hvovv)
            r1 -= 2.0 * contract("mn,mina->ia", Goo, hb.Hooov)
            r1 += contract("mn,imna->ia", Goo, hb.Hooov)

    r2 = L[o, o, v, v]
    if not ccd:
        if S2 is not None:
            r2 = r2 + 0.5 * S2
        r2 = r2 + 2.0 * contract("ia,jb->ijab", l1, hb.Hov)
        r2 -= contract("ja,ib->ijab", l1, hb.Hov)
        r2 += 2.0 * contract("ie,ejab->ijab", l1, hb.Hvovv)
        r2 -= contract("ie,ejba->ijab", l1, hb.Hvovv)
        r2 -= 2.0 * contract("mb,jima->ijab", l1, hb.Hooov)
        r2 += contract("mb,ijma->ijab", l1, hb.Hooov)
    if cc2:
        r2 += contract("ijeb,ea->ijab", l2,
                       F[v, v] - contract("me,ma->ae", F[o, v], t1))
        r2 -= contract("mjab,im->ijab", l2,
                       F[o, o] + contract("ie,me->mi", t1, F[o, v]))
    else:
        r2 = r2 + contract("ijeb,ea->ijab", l2, hb.Hvv)
        r2 -= contract("mjab,im->ijab", l2, hb.Hoo)
        r2 += 0.5 * contract("mnab,ijmn->ijab", l2, hb.Hoooo)
        r2 += 0.5 * vvvv_contract_efab(l2, hb.Hvvvv)
        r2 += contract("mjeb,ieam->ijab", l2, Hovvo_s)
        r2 -= contract("mibe,jema->ijab", l2, hb.Hovov)
        r2 -= contract("mieb,jeam->ijab", l2, hb.Hovvo)
        r2 += contract("ae,ijeb->ijab", Gvv, L[o, o, v, v])
        r2 -= contract("mi,mjab->ijab", Goo, L[o, o, v, v])
    r2 = r2 + r2.transpose(1, 0, 3, 2)
    return r1, r2


def lambda_residuals_from_F(model, F, ERI, L, t1, t2, l1, l2, no,
                            real_time=False, F_ref=None):
    """Rebuild HBAR from F on the fly (RT propagation path; mirrors
    cclambda.residuals, /root/reference/pycc/cclambda.py:281-448)."""
    hb = build_hbar("CCSD" if model == "CC3" else model, F, ERI, L, t1, t2, no)
    r1, r2 = lambda_residuals("CCSD" if model == "CC3" else model,
                              hb, F, ERI, L, t1, t2, l1, l2, no)
    if model == "CC3":
        from .models.cc3 import cc3_lambda_extra, cc3_lambda_extra_scan
        nv = t2.shape[2]
        fn = cc3_lambda_extra_scan if no ** 3 * nv ** 3 > 2e8 else cc3_lambda_extra
        Y1, Y2 = fn(F, ERI, L, t1, t2, l1, l2, no,
                    real_time=real_time, F_ref=F_ref)
        r1 = r1 + Y1
        r2 = r2 + Y2
    return r1, r2


def lambda_residuals_from_F_df(model, F, dfb, t1, t2, l1, l2, no,
                               real_time=False, F_ref=None):
    """RT propagation path over factors: rebuild the DF-HBAR from the
    (field-dressed) F each step — the storage='df' counterpart of
    lambda_residuals_from_F; no four-index object exists.  CCD reduces
    to the CCSD forms at t1 = l1 = 0 (the RT-CCD invariant), with r1
    pinned to zero as in the dense branch.  CC3 adds the slab-scanned
    factor-assembled extras (models/cc3.cc3_lambda_extra_scan_df)."""
    from .models.dfhbar import build_hbar_df, lambda_residuals_df
    if model not in ("CCD", "CC2", "CCSD", "CC3"):
        raise Exception("RT over storage='df' supports CCD/CC2/CCSD/CC3 "
                        "only (got %s)." % model)
    dfh = build_hbar_df(F, dfb, t1, t2, no,
                        model="CC2" if model == "CC2" else "CCSD")
    r1, r2 = lambda_residuals_df(dfh, t1, t2, l1, l2, no,
                                 model="CCSD" if model == "CC3" else model,
                                 F=F)
    if model == "CC3":
        from .models.cc3 import cc3_lambda_extra_scan_df
        Y1, Y2 = cc3_lambda_extra_scan_df(F, dfb, t1, t2, l1, l2, no,
                                          real_time=real_time, F_ref=F_ref)
        r1 = r1 + Y1
        r2 = r2 + Y2
    return r1, r2


def pseudoenergy(ERI, l2, no):
    o, v = slices(no)
    return 0.5 * contract("ijab,ijab->", ERI[o, o, v, v], l2)


class cclambda:
    """API-parity driver: cclambda(ccwfn, hbar).solve_lambda(...)."""

    def __init__(self, ccwfn, hbar):
        self.ccwfn = ccwfn
        self.hbar = hbar
        self.l1 = 2.0 * ccwfn.t1
        self.l2 = 2.0 * (2.0 * ccwfn.t2 - ccwfn.t2.swapaxes(2, 3))
        if getattr(ccwfn, "mesh", None) is not None:
            from .parallel import shard_amps
            self.l1, self.l2 = shard_amps(self.l1, self.l2, ccwfn.mesh)

    def residuals(self, F, t1, t2, l1, l2):
        """Standalone residuals rebuilding HBAR from F (for RT-CC)."""
        cc = self.ccwfn
        return lambda_residuals_from_F(cc.model, F, cc.H.ERI, cc.H.L,
                                       t1, t2, l1, l2, cc.no)

    def solve_lambda_mixed(self, e_conv=1e-10, r_conv=1e-10, maxiter=100,
                           sp_conv=1e-6, sp_dtype=None,
                           refine_maxiter=None, **kw):
        """Mixed-precision Lambda solve, same scheme as ccwfn.solve_cc_mixed:
        rebuild the HBAR at float32, converge Lambda to its f32 noise
        floor (cheap iterations), then
        rebuild the HBAR at float64 and refine the same l1/l2 to the
        requested tolerances.  The Lambda fixed point is dtype-independent
        given converged t-amplitudes, so the refined pseudoenergy equals a
        pure-f64 solve.  Completes the at-scale accuracy-recovery path
        for the post-convergence stack (the reference solves Lambda in
        f64 only, /root/reference/pycc/cclambda.py:64-116).

        Requires a precision='DP' ccwfn (the f64 masters are the
        refinement-stage Hamiltonian); typically called after
        solve_cc_mixed, whose converged f64 t1/t2 both stages consume.
        self.hbar is left at the f64 build for downstream consumers
        (density, response, EOM)."""
        import jax.numpy as jnp

        cc = self.ccwfn
        if cc.precision != "DP":
            raise Exception("solve_lambda_mixed needs a precision='DP' "
                            "ccwfn construction (the f64 masters are the "
                            "refinement-stage Hamiltonian).")
        if cc.local is not None:
            raise Exception("solve_lambda_mixed supports canonical "
                            "storage modes only.")
        from .cchbar import cchbar

        sp_dtype = sp_dtype or jnp.float32
        cc._ensure_mixed_masters()
        # the t-amplitudes are a fixed PARAMETER of the Lambda equations
        # (not the iterate, as in solve_cc_mixed): _cast_stage's f64->f32
        # downcast would permanently truncate them, so keep the exact f64
        # references alive through the floor stage and restore them for
        # the refinement (o^2v^2 f64 ~ 1.7 GB at (40,360) — affordable)
        t1_64, t2_64 = cc.t1, cc.t2
        # ---- low-precision floor stage: f32 HBAR + f32 Lambda ----
        cc._cast_stage(sp_dtype)
        self.hbar = cchbar(cc)
        self.l1 = self.l1.astype(sp_dtype)
        self.l2 = self.l2.astype(sp_dtype)
        self.e_sp_floor = float(self.solve_lambda(sp_conv, sp_conv,
                                                  maxiter, **kw))
        # ---- f64 refinement from the floor multipliers ----
        cc._cast_stage(jnp.float64)
        cc.t1, cc.t2 = t1_64, t2_64
        self.hbar = cchbar(cc)
        self.l1 = self.l1.astype(jnp.float64)
        self.l2 = self.l2.astype(jnp.float64)
        return self.solve_lambda(e_conv, r_conv,
                                 refine_maxiter if refine_maxiter
                                 else maxiter, **kw)

    def solve_lambda(self, e_conv=1e-7, r_conv=1e-7, maxiter=100, max_diis=8,
                     start_diis=1, stall_limit=10,
                     chk=None, chk_every=10, chk_ring=False, resume=False):
        """chk/chk_every/chk_ring/resume: solver checkpointing with the
        same semantics as ccwfn.solve_cc — atomic .npz snapshots of the
        post-extrapolation iterate (+ optional DIIS ring for an exact
        trajectory resume) every chk_every iterations."""
        tstart = time.time()
        cc = self.ccwfn
        no = cc.no
        H = cc.H
        hb = self.hbar.hbar if hasattr(self.hbar, "hbar") else self.hbar
        model = cc.model
        t1, t2 = cc.t1, cc.t2
        use_filter = cc.local is not None
        if use_filter:
            filter_fn = cc.Local.filter_amps

        S1 = getattr(cc, "S1", None)
        S2 = getattr(cc, "S2", None)
        if model == "CCSD(T)" and S1 is None:
            from .triples import t3_lambda_sources
            S1, S2 = t3_lambda_sources(cc)
            cc.S1, cc.S2 = S1, S2

        # max_diis=0 disables DIIS at trace time — no ring allocation, no
        # push in the step graph (see ccwfn.solve_cc; same HBM motive)
        use_diis = max_diis > 0
        diis = DIIS((self.l1, self.l2), max_diis=max(max_diis, 1))

        is_cc3 = model == "CC3"
        host_extras = None
        if is_cc3:
            from .models.cc3 import (cc3_lambda_extra, cc3_lambda_extra_rows,
                                     cc3_lambda_extra_scan)
            big = cc.no ** 3 * cc.nv ** 3 > 2e8
            use_rows = big if cc.t3_scan is None else bool(cc.t3_scan)
            if getattr(cc, "storage", "full") == "df":
                # factors have no in-step dense-ERI extras path; the
                # host-rows extras assemble their dressed W's from the
                # factor blocks (cc3_lambda_prep_df)
                use_rows = True
            cc3_extra_fn = cc3_lambda_extra
            if use_rows:
                # host-orchestrated per-row extras: the in-step 5-D-slab
                # scan holds 8.6 GB slabs in one long program at scale
                is_cc3 = False  # the jitted step computes the CCSD part only
                host_extras = cc3_lambda_extra_rows

        blocked = getattr(cc, "storage", "full") == "blocked"
        dfmode = getattr(cc, "storage", "full") == "df"
        if blocked:
            from .models.blocked import blocked_views
        if dfmode:
            from .models.dfccsd import _eri_oovv as df_eri_oovv
            from .models.dfhbar import lambda_residuals_df
        # at (no, nv) where the fused DF residual's ~14 live o^2v^2 temps
        # exceed HBM, evaluate it as two host-sequenced device programs
        # (models/dfhbar.py lambda_r2_seed_df/lambda_r1_r2_finish_df)
        # the five-program split implements the CCSD-FORM residual (the
        # CCD/CC2 df residuals are far lighter — no ladder/ring blocks;
        # CC3's Lambda step IS the CCSD form, with its extras folded into
        # S1/S2 by the host-rows path above)
        split_df = (dfmode and model in ("CCSD", "CCSD(T)", "CC3")
                    and (no * cc.nv ** 3 > 2e8
                         or getattr(cc, "_force_split_lambda", False)))

        # everything big enters as a jit ARGUMENT (closure constants are
        # baked into the compiled program); l1/l2 and
        # the DIIS ring are donated (outputs alias them in-place), and the
        # denominators are rebuilt from diag(F) in-fusion — the Lambda
        # stage at (40,360) otherwise holds a second ring + a t2-sized
        # Dijab CONSTANT baked into the graph
        @partial(jax.jit, donate_argnums=(8, 9, 10))
        def step(hb, F, ERIa, La, t1, t2, S1, S2, l1, l2, state, do_extrap):
            if blocked:
                ERIa, La = blocked_views(ERIa, no)
            if dfmode:
                r1, r2 = lambda_residuals_df(hb, t1, t2, l1, l2, no,
                                             S1, S2, model=model, F=F)
            else:
                r1, r2 = lambda_residuals("CCSD" if is_cc3 else model,
                                          hb, F, ERIa, La,
                                          t1, t2, l1, l2, no, S1, S2)
            if is_cc3:
                Y1, Y2 = cc3_extra_fn(F, ERIa, La, t1, t2, l1, l2,
                                      no, real_time=False)
                r1 = r1 + Y1
                r2 = r2 + Y2
            if use_filter:
                inc1, inc2 = filter_fn(r1, r2)
            else:
                eps = jnp.diagonal(F).astype(l1.dtype)
                inc1 = r1 / (eps[:no, None] - eps[None, no:])
                inc2 = r2 / (eps[:no, None, None, None]
                             + eps[None, :no, None, None]
                             - eps[None, None, no:, None]
                             - eps[None, None, None, no:])
            l1n = l1 + inc1
            l2n = l2 + inc2
            rms = jnp.sqrt(jnp.sum(jnp.abs(inc1) ** 2)
                           + jnp.sum(jnp.abs(inc2) ** 2))
            if dfmode:
                lecc = 0.5 * jnp.sum(df_eri_oovv(hb.df) * l2n)
            else:
                lecc = pseudoenergy(ERIa, l2n, no)
            if not use_diis:
                # single-pair return: duplicated jit outputs get DISTINCT
                # buffers (an extra l2-sized copy at scale)
                return l1n, l2n, state, lecc, rms
            state = diis.push(state, (l1n, l2n), (l1, l2))
            l1e, l2e = jax.lax.cond(
                do_extrap,
                lambda s: diis.extrapolate(s, (l1n, l2n)),
                lambda s: (l1n, l2n),
                state)
            return l1n, l2n, l1e, l2e, state, lecc, rms

        if split_df:
            from .models.dfhbar import (lambda_r1_df, lambda_r2_ladder_df,
                                        lambda_r2_rings_df,
                                        lambda_r2_small_a_df,
                                        lambda_r2_small_b_df)

            @jax.jit
            def step_small_a(hb_, l1, l2, S2):
                return lambda_r2_small_a_df(hb_, l1, l2, no, S2)

            @partial(jax.jit, donate_argnums=(3,))
            def step_small_b(hb_, l1, l2, r2s):
                return lambda_r2_small_b_df(hb_, l1, l2, r2s, no)

            @partial(jax.jit, donate_argnums=(3,))
            def step_ladder(hb_, t2, l2, r2s):
                return lambda_r2_ladder_df(hb_, t2, l2, r2s, no)

            @partial(jax.jit, donate_argnums=(3,))
            def step_rings(hb_, t2, l2, r2s):
                return lambda_r2_rings_df(hb_, t2, l2, r2s, no)

            @jax.jit
            def step_r1(hb_, t1, t2, l1, l2, S1):
                return lambda_r1_df(hb_, t1, t2, l1, l2, no, S1)

            @partial(jax.jit, donate_argnums=(2, 3, 4, 5, 6))
            def step_update(hb_, F, r1, r2, l1, l2, state, do_extrap):
                # returns ONLY the extrapolated iterate: keeping both the
                # raw and extrapolated pairs doubles the resident l2
                # footprint (0.83 GB at (40,360)) for no consumer
                eps = jnp.diagonal(F).astype(l1.dtype)
                inc1 = r1 / (eps[:no, None] - eps[None, no:])
                inc2 = r2 / (eps[:no, None, None, None]
                             + eps[None, :no, None, None]
                             - eps[None, None, no:, None]
                             - eps[None, None, None, no:])
                l1n = l1 + inc1
                l2n = l2 + inc2
                rms = jnp.sqrt(jnp.sum(jnp.abs(inc1) ** 2)
                               + jnp.sum(jnp.abs(inc2) ** 2))
                lecc = 0.5 * jnp.sum(df_eri_oovv(hb_.df) * l2n)
                if not use_diis:
                    return l1n, l2n, state, lecc, rms
                state = diis.push(state, (l1n, l2n), (l1, l2))
                l1e, l2e = jax.lax.cond(
                    do_extrap,
                    lambda s: diis.extrapolate(s, (l1n, l2n)),
                    lambda s: (l1n, l2n),
                    state)
                return l1e, l2e, state, lecc, rms

        if blocked:
            ERI0 = cc.blocks
            La0 = None
            bE0, _ = blocked_views(cc.blocks, no)
        elif dfmode:
            ERI0, La0, bE0 = None, None, None
        else:
            ERI0, La0, bE0 = H.ERI, H.L, H.ERI
        Fj = jnp.asarray(H.F)
        l1, l2 = self.l1, self.l2
        niter0 = 0
        chk_state = None
        if resume and chk is not None and os.path.exists(chk):
            from .utils.checkpoint import load_amps
            d = load_amps(chk)
            wdt = l1.dtype
            l1 = d["l1"].astype(wdt)
            l2 = d["l2"].astype(wdt)
            self.l1, self.l2 = l1, l2
            niter0 = int(d["niter"])
            if "diis_amps" in d and use_diis:
                chk_state = d
            log.info("Lambda-CC resumed from %s at iteration %d%s"
                     % (chk, niter0,
                        " (with DIIS ring)" if chk_state else ""))
        if dfmode:
            hbar_df = hb
            lecc = float(jnp.real(
                0.5 * jnp.sum(df_eri_oovv(hbar_df.df) * l2)))
        else:
            lecc = float(jnp.real(pseudoenergy(bE0, l2, no)))
        log.info("\nLCC Iter %3d: LCC PseudoE = %.15f  dE = % .5E" % (niter0, lecc, -lecc))
        state = diis.init() if use_diis else None
        if chk_state is not None:
            from .ops.diis import DIISState
            if chk_state["diis_amps"].shape[0] != state.amps.shape[0]:
                # resuming with a different max_diis: don't adopt the old
                # ring depth silently — fall back to an empty ring
                log.warning(
                    "Lambda resume: checkpoint DIIS ring depth %d != "
                    "current max_diis ring depth %d; starting with an "
                    "empty ring (amplitudes are restored)."
                    % (chk_state["diis_amps"].shape[0], state.amps.shape[0]))
            else:
                state = DIISState(
                    amps=jnp.asarray(chk_state["diis_amps"]).astype(state.amps.dtype),
                    errs=jnp.asarray(chk_state["diis_errs"]).astype(state.errs.dtype),
                    count=jnp.asarray(int(chk_state["diis_count"]), jnp.int32))
        best_rms = float("inf")
        stalled = 0
        for niter in range(niter0 + 1, maxiter + 1):
          with timers.time("lambda.iteration"):
            lecc_last = lecc
            do_ext = (max_diis > 0) and (niter >= start_diis)
            if host_extras is not None:
                # CC3 extras per iteration, outside the jitted step
                if dfmode:
                    Y1, Y2 = host_extras(Fj, None, None, t1, t2, l1, l2,
                                         no, dfb=cc.dfb)
                elif blocked:
                    Y1, Y2 = host_extras(Fj, None, None, t1, t2, l1, l2,
                                         no, blocks=cc.blocks)
                else:
                    Y1, Y2 = host_extras(Fj, H.ERI, H.L, t1, t2, l1, l2, no)
                # the step applies 0.5*S2 then pair-symmetrizes; Y2 is
                # already pair-symmetric, so it folds in with weight 1
                S1x = Y1 if S1 is None else S1 + Y1
                S2x = Y2 if S2 is None else S2 + Y2
            else:
                S1x, S2x = S1, S2
            if split_df:
                # five host-sequenced residual programs + an update
                # program: each fits HBM where the fused graph's ~14
                # live o^2v^2 temps do not.  The compiler's own HBM
                # accounting (examples/probe_lambda_hbm.py, (40,360)
                # naux=2592 SP) sized the coarser splits out: fused
                # ~12.4 GB temps, two-program seed 7.4 GB, three-way
                # small 5.8 GB — all OOM on top of the ~10 GB resident
                # set; these five run at <= ~4.5 GB each
                r2s = step_small_a(hb, l1, l2, S2x)
                jax.block_until_ready(r2s)
                r2s = step_small_b(hb, l1, l2, r2s)
                jax.block_until_ready(r2s)
                r2s = step_ladder(hb, t2, l2, r2s)
                jax.block_until_ready(r2s)
                r2x = step_rings(hb, t2, l2, r2s)
                jax.block_until_ready(r2x)
                r1x = step_r1(hb, t1, t2, l1, l2, S1x)
                jax.block_until_ready(r1x)
                l1, l2, state, lecc_j, rms = step_update(
                    hb, Fj, r1x, r2x, l1, l2, state, jnp.asarray(do_ext))
                l1n, l2n = l1, l2
            else:
                if use_diis:
                    l1n, l2n, l1, l2, state, lecc_j, rms = step(
                        hb, Fj, ERI0, La0, t1, t2, S1x, S2x, l1, l2, state,
                        jnp.asarray(do_ext))
                else:
                    l1n, l2n, state, lecc_j, rms = step(
                        hb, Fj, ERI0, La0, t1, t2, S1x, S2x, l1, l2, state,
                        jnp.asarray(do_ext))
                    l1, l2 = l1n, l2n
            lecc = float(jnp.real(lecc_j))
            rms = float(rms)
            # rebind to the fresh outputs: the donated step consumed the
            # previous buffers (incl. self.l1/self.l2 on iteration 1)
            self.l1, self.l2 = l1n, l2n
            ediff = lecc - lecc_last
            log.info("LCC Iter %3d: LCC PseudoE = %.15f  dE = % .5E  rms = % .5E"
                  % (niter, lecc, ediff, rms))
            if chk is not None and niter % chk_every == 0:
                from .utils.checkpoint import save_amps
                data = dict(l1=l1, l2=l2, niter=niter, lecc=lecc)
                if chk_ring and use_diis:
                    data.update(diis_amps=state.amps, diis_errs=state.errs,
                                diis_count=int(state.count))
                save_amps(chk, **data)
            # working-precision noise floor (see ccwfn.solve_cc): stop
            # when the rms has not improved for stall_limit iterations
            if rms < 0.98 * best_rms:
                best_rms = rms
                stalled = 0
            else:
                stalled += 1
                if stall_limit and stalled >= stall_limit and rms >= r_conv:
                    self.l1, self.l2 = l1n, l2n
                    self.converged = abs(ediff) < e_conv
                    log.info("\nLambda-CC hit the working-precision noise "
                          "floor (rms %.3E > r_conv %.1E, no improvement "
                          "in %d iterations); stopping with dE = %.3E.\n"
                          % (rms, r_conv, stall_limit, ediff))
                    return lecc
            if abs(ediff) < e_conv and rms < r_conv:
                self.l1, self.l2 = l1n, l2n
                self.converged = True
                log.info("\nLambda-CC has converged in %.3f seconds.\n"
                      % (time.time() - tstart))
                return lecc
        self.l1, self.l2 = l1, l2
        self.converged = False
        warnings.warn("Lambda-CC did NOT converge in %d iterations "
                      "(dE=%.2e rms=%.2e)" % (maxiter, ediff, rms))
        return lecc

    def pseudoenergy(self, o, v, ERI, l2):
        return pseudoenergy(ERI, l2, self.ccwfn.no)
