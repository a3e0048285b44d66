"""McMurchie-Davidson molecular integrals over contracted Gaussians.

Host-side replacement for Psi4's MintsHelper used by the reference
(`/root/reference/pycc/hamiltonian.py:36-75`): overlap, kinetic, nuclear
attraction, ERI, and the one-electron property integrals (electric dipole,
traceless quadrupole, nabla, angular momentum) needed by the CC property
and real-time modules.

All integrals are computed in float64 on the host (numpy/scipy); results
feed the device-side Hamiltonian pytree.  Vectorization is over primitive
pairs/quartets per shell block, with Boys functions from scipy's regularized
incomplete gamma.
"""

import numpy as np
from scipy.special import gammainc, gammaln

# ---------------------------------------------------------------------------
# Cartesian component tables and cartesian->pure-spherical transforms
# ---------------------------------------------------------------------------

def cart_components(l):
    """Cartesian (i,j,k) exponent triples in alphabetical order (CCA)."""
    out = []
    for i in range(l, -1, -1):
        for j in range(l - i, -1, -1):
            out.append((i, j, l - i - j))
    return out


def _dfact(n):
    out = 1.0
    while n > 0:
        out *= n
        n -= 2
    return out


def cart_norm_ratios(l):
    """sqrt(N_ijk / N_l00): per-component normalization relative to (l,0,0)."""
    comps = cart_components(l)
    top = _dfact(2 * l - 1)
    return np.array([
        np.sqrt(top / (_dfact(2 * i - 1) * _dfact(2 * j - 1) * _dfact(2 * k - 1)))
        for (i, j, k) in comps])


def _cart_overlap_ratio(l):
    """S[c1, c2] = <cart_1|cart_2> / <(l,0,0)|(l,0,0)> for same-l cartesian
    monomial Gaussians (analytic double-factorial ratios)."""
    comps = cart_components(l)
    n = len(comps)
    S = np.zeros((n, n))
    top = _dfact(2 * l - 1)
    for p, (a1, b1, c1) in enumerate(comps):
        for q, (a2, b2, c2) in enumerate(comps):
            if (a1 + a2) % 2 or (b1 + b2) % 2 or (c1 + c2) % 2:
                continue
            S[p, q] = (_dfact(a1 + a2 - 1) * _dfact(b1 + b2 - 1)
                       * _dfact(c1 + c2 - 1)) / top
    return S


_PURE_CACHE = {}


def pure_transform(l):
    """Matrix T (npure x ncart) from raw (l,0,0)-normalized cartesians to
    normalized real spherical harmonics, m ordered -l..l.

    Built numerically for general l: real Y_lm sampled on a Lebedev-style
    sphere grid is fit by same-l cartesian monomials (exact: the monomials
    span the harmonics), then each row is normalized under the Gaussian
    measure via the analytic cartesian overlap matrix."""
    if l == 0:
        return np.array([[1.0]])
    if l in _PURE_CACHE:
        return _PURE_CACHE[l]
    from scipy.special import sph_harm_y

    comps = cart_components(l)
    rng = np.random.default_rng(12345)
    npts = 40 * (l + 1) ** 2
    pts = rng.standard_normal((npts, 3))
    pts /= np.linalg.norm(pts, axis=1)[:, None]
    theta = np.arccos(np.clip(pts[:, 2], -1, 1))       # polar
    phi = np.arctan2(pts[:, 1], pts[:, 0])             # azimuthal
    # monomial design matrix
    M = np.stack([pts[:, 0] ** i * pts[:, 1] ** j * pts[:, 2] ** k
                  for (i, j, k) in comps], axis=1)
    rows = []
    for m in range(-l, l + 1):
        Y = sph_harm_y(l, abs(m), theta, phi)
        if m < 0:
            y = np.sqrt(2.0) * (-1.0) ** m * np.imag(Y)
        elif m == 0:
            y = np.real(Y)
        else:
            y = np.sqrt(2.0) * (-1.0) ** m * np.real(Y)
        c, *_ = np.linalg.lstsq(M, y, rcond=None)
        rows.append(c)
    T = np.array(rows)
    # normalize each pure function under the Gaussian measure
    S = _cart_overlap_ratio(l)
    for r in range(T.shape[0]):
        T[r] /= np.sqrt(T[r] @ S @ T[r])
    # clean numerical noise
    T[np.abs(T) < 1e-10] = 0.0
    _PURE_CACHE[l] = T
    return T


# ---------------------------------------------------------------------------
# Boys function
# ---------------------------------------------------------------------------

def boys(nmax, T):
    """F_n(T) for n=0..nmax, T an array. Returns shape (nmax+1,) + T.shape."""
    T = np.asarray(T, dtype=float)
    out = np.empty((nmax + 1,) + T.shape)
    small = T < 1.0e-13
    Tsafe = np.where(small, 1.0, T)
    for n in range(nmax + 1):
        a = n + 0.5
        val = gammainc(a, Tsafe) * np.exp(gammaln(a)) / (2.0 * Tsafe ** a)
        series = 1.0 / (2 * n + 1) - T / (2 * n + 3) + T * T / (2 * (2 * n + 5))
        out[n] = np.where(small, series, val)
    return out


# ---------------------------------------------------------------------------
# Hermite expansion coefficients (vectorized over primitive pairs)
# ---------------------------------------------------------------------------

def hermite_E(la, lb, p, PA, PB, mu_dx2):
    """E_t^{ij} for one cartesian direction.

    Parameters: p (npp,), PA (npp,), PB (npp,), mu_dx2 = (a*b/p)*XAB^2 (npp,)
    Returns array (npp, la+1, lb+1, la+lb+1).
    """
    npp = p.shape[0]
    tmax = la + lb
    E = np.zeros((npp, la + 1, lb + 1, tmax + 2))
    E[:, 0, 0, 0] = np.exp(-mu_dx2)
    inv2p = 0.5 / p
    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            if j == 0:
                # build from (i-1, 0)
                for t in range(i + j + 1):
                    val = PA * E[:, i - 1, 0, t]
                    if t > 0:
                        val = val + inv2p * E[:, i - 1, 0, t - 1]
                    val = val + (t + 1) * E[:, i - 1, 0, t + 1]
                    E[:, i, 0, t] = val
            else:
                for t in range(i + j + 1):
                    val = PB * E[:, i, j - 1, t]
                    if t > 0:
                        val = val + inv2p * E[:, i, j - 1, t - 1]
                    val = val + (t + 1) * E[:, i, j - 1, t + 1]
                    E[:, i, j, t] = val
    return E[:, :, :, :tmax + 1]


# ---------------------------------------------------------------------------
# Hermite Coulomb integrals R_tuv (vectorized over a batch)
# ---------------------------------------------------------------------------

def hermite_R(tmax, umax, vmax, alpha, Rpq):
    """R^0_{tuv} for t<=tmax etc.  alpha: (B,), Rpq: (B,3).
    Returns (B, tmax+1, umax+1, vmax+1)."""
    N = tmax + umax + vmax
    T = alpha * np.einsum("bi,bi->b", Rpq, Rpq)
    F = boys(N, T)  # (N+1, B)
    B = alpha.shape[0]
    # R[n][t,u,v] built by ascending total order
    Rn = np.zeros((N + 1, tmax + 1, umax + 1, vmax + 1, B))
    pref = np.ones(B)
    for n in range(N + 1):
        Rn[n, 0, 0, 0] = pref * F[n]
        pref = pref * (-2.0 * alpha)
    X, Y, Z = Rpq[:, 0], Rpq[:, 1], Rpq[:, 2]
    for s in range(1, N + 1):
        for t in range(min(s, tmax) + 1):
            for u in range(min(s - t, umax) + 1):
                v = s - t - u
                if v > vmax or v < 0:
                    continue
                for n in range(N - s + 1):
                    if v > 0:
                        val = Z * Rn[n + 1, t, u, v - 1]
                        if v > 1:
                            val = val + (v - 1) * Rn[n + 1, t, u, v - 2]
                    elif u > 0:
                        val = Y * Rn[n + 1, t, u - 1, v]
                        if u > 1:
                            val = val + (u - 1) * Rn[n + 1, t, u - 2, v]
                    else:
                        val = X * Rn[n + 1, t - 1, u, v]
                        if t > 1:
                            val = val + (t - 1) * Rn[n + 1, t - 2, u, v]
                    Rn[n, t, u, v] = val
    return np.moveaxis(Rn[0], -1, 0)  # (B, tmax+1, umax+1, vmax+1)


# ---------------------------------------------------------------------------
# Shell-pair data
# ---------------------------------------------------------------------------

class ShellPair:
    """Primitive-pair data and Hermite E tensors for a shell pair."""

    def __init__(self, sha, shb, extra=0):
        a = sha.exps
        b = shb.exps
        A, Bc = sha.center, shb.center
        aa, bb = np.meshgrid(a, b, indexing="ij")
        aa = aa.ravel()
        bb = bb.ravel()
        p = aa + bb
        P = (aa[:, None] * A[None, :] + bb[:, None] * Bc[None, :]) / p[:, None]
        AB = A - Bc
        mu = aa * bb / p
        coef = np.outer(sha.coefs, shb.coefs).ravel()
        self.sha, self.shb = sha, shb
        self.p = p
        self.P = P
        self.coef = coef
        self.aa, self.bb = aa, bb
        la, lb = sha.l, shb.l
        # E tensors per direction, ket angular momentum extended by `extra`
        self.E = [hermite_E(la, lb + extra, p, P[:, d] - A[d], P[:, d] - Bc[d],
                            mu * AB[d] ** 2) for d in range(3)]
        self.la, self.lb = la, lb
        self.extra = extra

    def hermite_coefs(self):
        """Theta[npp, ncartA*ncartB, nherm] combining E products (no coefs)."""
        la, lb = self.la, self.lb
        ca = cart_components(la)
        cb = cart_components(lb)
        L = la + lb
        nh = (L + 1) * (L + 2) * (L + 3) // 6
        hmap = hermite_index_map(L)
        npp = self.p.shape[0]
        out = np.zeros((npp, len(ca) * len(cb), nh))
        Ex, Ey, Ez = self.E
        for ia, (ax, ay, az) in enumerate(ca):
            for ib, (bx, by, bz) in enumerate(cb):
                idx = ia * len(cb) + ib
                for t in range(ax + bx + 1):
                    for u in range(ay + by + 1):
                        for v in range(az + bz + 1):
                            out[:, idx, hmap[(t, u, v)]] = (
                                Ex[:, ax, bx, t] * Ey[:, ay, by, u] * Ez[:, az, bz, v])
        return out


def hermite_index_map(L):
    m = {}
    n = 0
    for s in range(L + 1):
        for t in range(s, -1, -1):
            for u in range(s - t, -1, -1):
                m[(t, u, s - t - u)] = n
                n += 1
    return m


def hermite_tuv_list(L):
    out = []
    for s in range(L + 1):
        for t in range(s, -1, -1):
            for u in range(s - t, -1, -1):
                out.append((t, u, s - t - u))
    return out


# ---------------------------------------------------------------------------
# Transformation of raw cartesian shell blocks to final AO functions
# ---------------------------------------------------------------------------

def shell_transform(shell):
    """Matrix (nfunc x ncart) taking raw (l,0,0)-normalized cartesian
    integrals to the shell's final AO functions."""
    if shell.pure:
        return pure_transform(shell.l)
    T = np.diag(cart_norm_ratios(shell.l))
    return T


# ---------------------------------------------------------------------------
# One-electron integrals
# ---------------------------------------------------------------------------

def _one_electron_blocks(basis, block_fn, nmats, extra=2):
    """Drive a generic one-electron integral: block_fn(pair) -> array
    (nmats, npp, ncartA, ncartB); assembles full matrices."""
    nbf = basis.nbf
    mats = np.zeros((nmats, nbf, nbf))
    shells = basis.shells
    for isa in range(len(shells)):
        for isb in range(len(shells)):
            if isb < isa:
                continue
            sha, shb = shells[isa], shells[isb]
            pair = ShellPair(sha, shb, extra=extra)
            raw = block_fn(pair)  # (nmats, npp, ncA, ncB)
            blk = np.einsum("p,mpab->mab", pair.coef, raw)
            Ta = shell_transform(sha)
            Tb = shell_transform(shb)
            blk = np.einsum("ca,mab,db->mcd", Ta, blk, Tb)
            oa, ob = basis.offsets[isa], basis.offsets[isb]
            na, nb = sha.nfunc, shb.nfunc
            mats[:, oa:oa + na, ob:ob + nb] = blk
            if isb != isa:
                # hermitian for S,T,V,moments; caller fixes antisymmetric ops
                mats[:, ob:ob + nb, oa:oa + na] = np.swapaxes(blk, 1, 2)
    return mats


def _s1d(pair, d, i, j):
    """1D overlap <i|j>_d including sqrt(pi/p): (npp,)"""
    return pair.E[d][:, i, j, 0] * np.sqrt(np.pi / pair.p)


def _moment1d(pair, d, i, j, order):
    """1D moment <i| x^order |j>_d about the global origin."""
    Bd = pair.shb.center[d]
    if order == 0:
        return _s1d(pair, d, i, j)
    if order == 1:
        return _s1d(pair, d, i, j + 1) + Bd * _s1d(pair, d, i, j)
    if order == 2:
        return (_s1d(pair, d, i, j + 2) + 2 * Bd * _s1d(pair, d, i, j + 1)
                + Bd * Bd * _s1d(pair, d, i, j))
    raise ValueError(order)


def _deriv1d(pair, d, i, j):
    """1D derivative <i| d/dx |j>_d = j*S(i,j-1) - 2b*S(i,j+1).

    Contains the per-primitive ket exponent, so returns (npp,)."""
    val = -2.0 * pair.bb * _s1d(pair, d, i, j + 1)
    if j > 0:
        val = val + j * _s1d(pair, d, i, j - 1)
    return val


def _ddot1d(pair, d, i, j):
    """1D second derivative <i| d2/dx2 |j>."""
    b = pair.bb
    val = -2.0 * b * (2 * j + 1) * _s1d(pair, d, i, j) \
        + 4.0 * b * b * _s1d(pair, d, i, j + 2)
    if j > 1:
        val = val + j * (j - 1) * _s1d(pair, d, i, j - 2)
    return val


def overlap(basis):
    def fn(pair):
        ca = cart_components(pair.la)
        cb = cart_components(pair.lb)
        npp = pair.p.shape[0]
        out = np.zeros((1, npp, len(ca), len(cb)))
        for ia, A in enumerate(ca):
            for ib, B in enumerate(cb):
                out[0, :, ia, ib] = (_s1d(pair, 0, A[0], B[0])
                                     * _s1d(pair, 1, A[1], B[1])
                                     * _s1d(pair, 2, A[2], B[2]))
        return out
    return _one_electron_blocks(basis, fn, 1)[0]


def kinetic(basis):
    def fn(pair):
        ca = cart_components(pair.la)
        cb = cart_components(pair.lb)
        npp = pair.p.shape[0]
        out = np.zeros((1, npp, len(ca), len(cb)))
        for ia, A in enumerate(ca):
            for ib, B in enumerate(cb):
                s = [_s1d(pair, d, A[d], B[d]) for d in range(3)]
                dd = [_ddot1d(pair, d, A[d], B[d]) for d in range(3)]
                out[0, :, ia, ib] = -0.5 * (dd[0] * s[1] * s[2]
                                            + s[0] * dd[1] * s[2]
                                            + s[0] * s[1] * dd[2])
        return out
    return _one_electron_blocks(basis, fn, 1)[0]


def dipole(basis):
    """Electric-dipole integrals mu_d = -<a| r_d |b> (electron charge -1),
    matching Psi4 MintsHelper.ao_dipole()."""
    def make(d):
        def fn(pair):
            ca = cart_components(pair.la)
            cb = cart_components(pair.lb)
            npp = pair.p.shape[0]
            out = np.zeros((1, npp, len(ca), len(cb)))
            for ia, A in enumerate(ca):
                for ib, B in enumerate(cb):
                    facs = [_moment1d(pair, dd, A[dd], B[dd], 1 if dd == d else 0)
                            for dd in range(3)]
                    out[0, :, ia, ib] = -facs[0] * facs[1] * facs[2]
            return out
        return fn
    return [_one_electron_blocks(basis, make(d), 1)[0] for d in range(3)]


def traceless_quadrupole(basis):
    """Traceless quadrupole Q_ij = -(3 x_i x_j - r^2 delta_ij)/2, 6 matrices
    in XX,XY,XZ,YY,YZ,ZZ order (Psi4 ao_traceless_quadrupole)."""
    # first compute the 6 raw second moments <a| x_i x_j |b>
    pairs_dd = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]

    def make(d1, d2):
        def fn(pair):
            ca = cart_components(pair.la)
            cb = cart_components(pair.lb)
            npp = pair.p.shape[0]
            out = np.zeros((1, npp, len(ca), len(cb)))
            for ia, A in enumerate(ca):
                for ib, B in enumerate(cb):
                    if d1 == d2:
                        facs = [_moment1d(pair, dd, A[dd], B[dd], 2 if dd == d1 else 0)
                                for dd in range(3)]
                    else:
                        facs = [_moment1d(pair, dd, A[dd], B[dd],
                                          1 if dd in (d1, d2) else 0)
                                for dd in range(3)]
                    out[0, :, ia, ib] = facs[0] * facs[1] * facs[2]
            return out
        return fn

    M = [_one_electron_blocks(basis, make(d1, d2), 1)[0] for (d1, d2) in pairs_dd]
    r2 = M[0] + M[3] + M[5]  # xx + yy + zz
    out = []
    for k, (d1, d2) in enumerate(pairs_dd):
        q = -0.5 * (3.0 * M[k] - (r2 if d1 == d2 else 0.0))
        out.append(q)
    return out


def nabla(basis):
    """<a| d/dx_d |b> for d=x,y,z (antisymmetric), matching ao_nabla."""
    nbf = basis.nbf
    mats = np.zeros((3, nbf, nbf))
    shells = basis.shells
    for isa in range(len(shells)):
        for isb in range(len(shells)):
            sha, shb = shells[isa], shells[isb]
            pair = ShellPair(sha, shb, extra=2)
            ca = cart_components(pair.la)
            cb = cart_components(pair.lb)
            npp = pair.p.shape[0]
            raw = np.zeros((3, npp, len(ca), len(cb)))
            for ia, A in enumerate(ca):
                for ib, B in enumerate(cb):
                    s = [_s1d(pair, d, A[d], B[d]) for d in range(3)]
                    dv = [_deriv1d(pair, d, A[d], B[d]) for d in range(3)]
                    raw[0, :, ia, ib] = dv[0] * s[1] * s[2]
                    raw[1, :, ia, ib] = s[0] * dv[1] * s[2]
                    raw[2, :, ia, ib] = s[0] * s[1] * dv[2]
            blk = np.einsum("p,mpab->mab", pair.coef, raw)
            Ta = shell_transform(sha)
            Tb = shell_transform(shb)
            blk = np.einsum("ca,mab,db->mcd", Ta, blk, Tb)
            oa, ob = basis.offsets[isa], basis.offsets[isb]
            mats[:, oa:oa + sha.nfunc, ob:ob + shb.nfunc] = blk
    return [mats[d] for d in range(3)]


def angular_momentum(basis):
    """<a| (r x nabla)_d |b> real matrices (antisymmetric).

    Psi4's ao_angular_momentum returns L = -i r x nabla integrals as the
    imaginary part carrier; pycc multiplies by -0.5j (hamiltonian.py:54-59).
    We return the real matrices of (r x nabla)."""
    nbf = basis.nbf
    mats = np.zeros((3, nbf, nbf))
    shells = basis.shells
    for isa in range(len(shells)):
        for isb in range(len(shells)):
            sha, shb = shells[isa], shells[isb]
            pair = ShellPair(sha, shb, extra=3)
            ca = cart_components(pair.la)
            cb = cart_components(pair.lb)
            npp = pair.p.shape[0]
            raw = np.zeros((3, npp, len(ca), len(cb)))
            for ia, A in enumerate(ca):
                for ib, B in enumerate(cb):
                    s = [_s1d(pair, d, A[d], B[d]) for d in range(3)]
                    m1 = [_moment1d(pair, d, A[d], B[d], 1) for d in range(3)]
                    dv = [_deriv1d(pair, d, A[d], B[d]) for d in range(3)]
                    # x * d/dy acting in separate dims: moment in one dim,
                    # derivative in another, overlap in the third.
                    # Lx = y dz - z dy ; Ly = z dx - x dz ; Lz = x dy - y dx
                    raw[0, :, ia, ib] = m1[1] * dv[2] * s[0] - m1[2] * dv[1] * s[0]
                    raw[1, :, ia, ib] = m1[2] * dv[0] * s[1] - m1[0] * dv[2] * s[1]
                    raw[2, :, ia, ib] = m1[0] * dv[1] * s[2] - m1[1] * dv[0] * s[2]
            blk = np.einsum("p,mpab->mab", pair.coef, raw)
            Ta = shell_transform(sha)
            Tb = shell_transform(shb)
            blk = np.einsum("ca,mab,db->mcd", Ta, blk, Tb)
            oa, ob = basis.offsets[isa], basis.offsets[isb]
            mats[:, oa:oa + sha.nfunc, ob:ob + shb.nfunc] = blk
    return [mats[d] for d in range(3)]


def nuclear_attraction(basis):
    mol = basis.molecule
    nbf = basis.nbf
    V = np.zeros((nbf, nbf))
    shells = basis.shells
    centers = mol.coords
    Zs = mol.Z
    for isa in range(len(shells)):
        for isb in range(isa, len(shells)):
            sha, shb = shells[isa], shells[isb]
            pair = ShellPair(sha, shb, extra=0)
            L = sha.l + shb.l
            theta = pair.hermite_coefs()  # (npp, ncab, nh)
            npp = pair.p.shape[0]
            acc = np.zeros((npp, theta.shape[1]))
            tuv = hermite_tuv_list(L)
            for (Z, C) in zip(Zs, centers):
                Rpq = pair.P - C[None, :]
                R = hermite_R(L, L, L, pair.p, Rpq)  # (npp, L+1,L+1,L+1)
                Rflat = np.stack([R[:, t, u, v] for (t, u, v) in tuv], axis=1)
                acc += -Z * np.einsum("pch,ph->pc", theta, Rflat)
            acc *= (2.0 * np.pi / pair.p)[:, None]
            blk = np.einsum("p,pc->c", pair.coef, acc).reshape(
                sha.ncart, shb.ncart)
            Ta = shell_transform(sha)
            Tb = shell_transform(shb)
            blk = Ta @ blk @ Tb.T
            oa, ob = basis.offsets[isa], basis.offsets[isb]
            V[oa:oa + sha.nfunc, ob:ob + shb.nfunc] = blk
            if isb != isa:
                V[ob:ob + shb.nfunc, oa:oa + sha.nfunc] = blk.T
    return V


# ---------------------------------------------------------------------------
# Two-electron repulsion integrals
# ---------------------------------------------------------------------------

def eri(basis):
    """Full (ab|cd) chemists'-notation ERI tensor over final AO functions.

    Dispatches to the native C++ engine (native/mdints.cpp) when the
    toolchain is available; the pure-Python path below is the reference
    implementation and fallback."""
    try:
        from . import native
        if native.available():
            return native.eri_native(basis)
    except Exception:
        pass
    return _eri_python(basis)


def _eri_python(basis):
    shells = basis.shells
    nsh = len(shells)
    nbf = basis.nbf
    out = np.zeros((nbf, nbf, nbf, nbf))

    # precompute per-shell-pair hermite data
    pair_data = {}
    for i in range(nsh):
        for j in range(i + 1):
            pr = ShellPair(shells[i], shells[j], extra=0)
            theta = pr.hermite_coefs()  # (npp, ncab, nh)
            theta = theta * pr.coef[:, None, None]
            pair_data[(i, j)] = (pr, theta)

    tuv_cache = {}

    def tuvs(L):
        if L not in tuv_cache:
            tuv_cache[L] = hermite_tuv_list(L)
        return tuv_cache[L]

    pairs = sorted(pair_data.keys())
    for pi, (i, j) in enumerate(pairs):
        pr1, th1 = pair_data[(i, j)]
        L1 = shells[i].l + shells[j].l
        t1 = tuvs(L1)
        for (k, l) in pairs[:pi + 1]:
            pr2, th2 = pair_data[(k, l)]
            L2 = shells[k].l + shells[l].l
            t2 = tuvs(L2)
            # (-1)^(t+u+v) on the *ket* hermite components (Helgaker 9.9.33)
            sgn = np.array([(-1.0) ** (t + u + v) for (t, u, v) in t2])
            n1, n2 = pr1.p.shape[0], pr2.p.shape[0]
            pp = pr1.p[:, None]
            qq = pr2.p[None, :]
            alpha = (pp * qq / (pp + qq)).ravel()
            Rpq = (pr1.P[:, None, :] - pr2.P[None, :, :]).reshape(-1, 3)
            R = hermite_R(L1 + L2, L1 + L2, L1 + L2, alpha, Rpq)
            pref = (2.0 * np.pi ** 2.5 / (pp * qq * np.sqrt(pp + qq))).ravel()
            # build R matrix between bra/ket hermite components
            Rmat = np.empty((alpha.shape[0], len(t1), len(t2)))
            for a1, (t, u, v) in enumerate(t1):
                for a2, (tt, uu, vv) in enumerate(t2):
                    Rmat[:, a1, a2] = R[:, t + tt, u + uu, v + vv]
            Rmat *= pref[:, None, None]
            Rmat = Rmat.reshape(n1, n2, len(t1), len(t2))
            blk = np.einsum("pah,pqhk,qbk->ab", th1,
                            Rmat, th2 * sgn[None, None, :], optimize=True)
            blk = blk.reshape(shells[i].ncart, shells[j].ncart,
                              shells[k].ncart, shells[l].ncart)
            Ti = shell_transform(shells[i])
            Tj = shell_transform(shells[j])
            Tk = shell_transform(shells[k])
            Tl = shell_transform(shells[l])
            blk = np.einsum("ai,bj,ijkl,ck,dl->abcd", Ti, Tj, blk, Tk, Tl,
                            optimize=True)
            oi, oj = basis.offsets[i], basis.offsets[j]
            ok, ol = basis.offsets[k], basis.offsets[l]
            ni, nj = shells[i].nfunc, shells[j].nfunc
            nk, nl = shells[k].nfunc, shells[l].nfunc
            # scatter the 8 permutational images
            out[oi:oi + ni, oj:oj + nj, ok:ok + nk, ol:ol + nl] = blk
            out[oj:oj + nj, oi:oi + ni, ok:ok + nk, ol:ol + nl] = blk.transpose(1, 0, 2, 3)
            out[oi:oi + ni, oj:oj + nj, ol:ol + nl, ok:ok + nk] = blk.transpose(0, 1, 3, 2)
            out[oj:oj + nj, oi:oi + ni, ol:ol + nl, ok:ok + nk] = blk.transpose(1, 0, 3, 2)
            out[ok:ok + nk, ol:ol + nl, oi:oi + ni, oj:oj + nj] = blk.transpose(2, 3, 0, 1)
            out[ol:ol + nl, ok:ok + nk, oi:oi + ni, oj:oj + nj] = blk.transpose(3, 2, 0, 1)
            out[ok:ok + nk, ol:ol + nl, oj:oj + nj, oi:oi + ni] = blk.transpose(2, 3, 1, 0)
            out[ol:ol + nl, ok:ok + nk, oj:oj + nj, oi:oi + ni] = blk.transpose(3, 2, 1, 0)
    return out
