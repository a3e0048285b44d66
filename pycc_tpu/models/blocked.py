"""Blocked Hamiltonian storage: 6 unique Dirac ERI blocks instead of the
full nact^4 ERI + L pair.

The reference keeps full <pq|rs> and L = 2<pq|rs> - <pq|sr> resident
(hamiltonian.py:36-39), which costs 2 x nact^4 of device memory *plus*
tile padding when nact is not a multiple of the tile width.  Here only the six
canonical occupied/virtual blocks are stored -- oooo, ooov, oovv, ovov,
ovvv, vvvv -- at (o,v)=(32,128) that is ~1.5 GB against ~8.4 GB, and every
block with v-sized trailing dims avoids the padding of nact.  All sixteen
slice patterns and every L block are *views*: derived inside jit via the
8-fold permutational symmetry of real Dirac integrals, so XLA folds the
transposes into the consuming dot_general's dimension numbers (no copies).

`BlockedERI`/`BlockedL` quack like the full tensors under 4-slice indexing,
so the canonical residual equations (models/ccsd.py) run verbatim on
blocked storage.
"""

from typing import NamedTuple

import jax.numpy as jnp

from .ccsd import slices

# the 8-fold symmetry group of a real Dirac integral <pq|rs> = (pr|qs),
# as index-position permutations: p<->r, q<->s, bra<->ket and compositions
_GROUP = []


def _close_group():
    gens = [(0, 1, 2, 3), (2, 1, 0, 3), (0, 3, 2, 1), (1, 0, 3, 2)]
    group = set(gens)
    frontier = list(gens)
    while frontier:
        a = frontier.pop()
        for b in list(group):
            c = tuple(a[b[k]] for k in range(4))
            if c not in group:
                group.add(c)
                frontier.append(c)
    return sorted(group)


_GROUP = _close_group()

CANONICAL = ("oooo", "ooov", "oovv", "ovov", "ovvv", "vvvv")


class ERIBlocks(NamedTuple):
    """The six canonical Dirac blocks (a pytree; jit-traceable)."""
    oooo: jnp.ndarray
    ooov: jnp.ndarray
    oovv: jnp.ndarray
    ovov: jnp.ndarray
    ovvv: jnp.ndarray
    vvvv: jnp.ndarray


def blocks_from_full(ERI, no):
    """Slice the six canonical blocks out of a full Dirac ERI tensor."""
    o, v = slices(no)
    sl = {"o": o, "v": v}
    return ERIBlocks(*(ERI[tuple(sl[c] for c in pat)] for pat in CANONICAL))


def _pattern_of(key, no):
    pat = []
    for s in key:
        if s.start in (None, 0) and s.stop == no and s.step is None:
            pat.append("o")
        elif s.start == no and s.stop is None and s.step is None:
            pat.append("v")
        else:
            raise KeyError("blocked ERI supports only o/v slices, got %r"
                           % (key,))
    return "".join(pat)


def _resolve(pat):
    """(canonical pattern, transpose axes) reproducing block `pat`.

    With sigma such that pat[sigma[k]] == canonical[k], the block identity
    is B_pat[j] = B_canon[j o sigma], i.e. jnp.transpose(B_canon, sigma^-1).
    """
    for sigma in _GROUP:
        cand = "".join(pat[sigma[k]] for k in range(4))
        if cand in CANONICAL:
            inv = tuple(sigma.index(k) for k in range(4))
            return cand, inv
    raise KeyError(pat)  # unreachable: every pattern reduces


# precompute the 16-entry dispatch table at import time
_TABLE = {}
for _i in range(16):
    _p = "".join("ov"[(_i >> _k) & 1] for _k in (3, 2, 1, 0))
    _TABLE[_p] = _resolve(_p)


class BlockedERI:
    """Quacks like the full Dirac ERI under 4-tuple o/v slicing."""

    def __init__(self, blocks, no):
        self.blocks = blocks
        self.no = no

    def block(self, pat):
        canon, sigma = _TABLE[pat]
        base = getattr(self.blocks, canon)
        if sigma == (0, 1, 2, 3):
            return base
        return jnp.transpose(base, sigma)

    def __getitem__(self, key):
        return self.block(_pattern_of(key, self.no))


class BlockedL:
    """Spin-adapted L = 2<pq|rs> - <pq|sr> as on-the-fly views."""

    def __init__(self, blocks, no):
        self._eri = BlockedERI(blocks, no)
        self.no = no

    def __getitem__(self, key):
        pat = _pattern_of(key, self.no)
        direct = self._eri.block(pat)
        swapped = self._eri.block(pat[:2] + pat[3] + pat[2])
        return 2.0 * direct - jnp.transpose(swapped, (0, 1, 3, 2))


def blocked_views(blocks, no):
    """(ERI-like, L-like) views over an ERIBlocks; build inside jit."""
    return BlockedERI(blocks, no), BlockedL(blocks, no)


class LoovvOnly:
    """Minimal L stand-in for the energy functions (they read only
    L[o,o,v,v]): lets a mixed-precision step evaluate the energy in f32
    while the residual contractions run from bf16 blocks."""

    def __init__(self, Loovv, no):
        self.Loovv = Loovv
        self.no = no

    def __getitem__(self, key):
        if _pattern_of(key, self.no) != "oovv":
            raise KeyError("LoovvOnly holds only the oovv block")
        return self.Loovv
