"""Real/imaginary-split complex tensors.

The real-time CC equations run in complex arithmetic.  For a backend
without complex ops (the accelerator this library was first written
for had none), `CTensor` carries (re, im) as two
real arrays and implements exactly the algebra the CC residual code uses —
+, -, *, scalar complex multiplication, axis permutations, reshapes —
while `ops.contract` lowers mixed/complex einsums to Karatsuba's three
real contractions.  Because the residual/HBAR/Lambda bodies are written
against methods and `contract()` (not raw jnp calls), they run unchanged
on CTensor amplitudes.

This replaces the reference's reliance on complex128 BLAS/torch
(/root/reference/pycc/rt/rtcc.py) with an all-real formulation.
"""

import jax
import jax.numpy as jnp


def _re_im(x):
    """(re, im) views of any operand; im is None for real operands."""
    if isinstance(x, CTensor):
        return x.re, x.im
    if isinstance(x, complex):
        if x.imag == 0.0:
            return x.real, None
        return x.real, x.imag
    return x, None


@jax.tree_util.register_pytree_node_class
class CTensor:
    """A complex tensor as a (re, im) pair of real arrays."""

    __slots__ = ("re", "im")

    def __init__(self, re, im=None):
        self.re = re
        self.im = jnp.zeros_like(re) if im is None else im

    # -- pytree ---------------------------------------------------------
    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- construction / conversion --------------------------------------
    @classmethod
    def from_complex(cls, x):
        return cls(jnp.real(x), jnp.imag(x))

    def to_complex(self):
        return self.re + 1.0j * self.im

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):  # the REAL component dtype
        return self.re.dtype

    def conj(self):
        return CTensor(self.re, -self.im)

    # -- arithmetic ------------------------------------------------------
    def __add__(self, o):
        orr, oi = _re_im(o)
        return CTensor(self.re + orr,
                       self.im if oi is None else self.im + oi)

    __radd__ = __add__

    def __sub__(self, o):
        orr, oi = _re_im(o)
        return CTensor(self.re - orr,
                       self.im if oi is None else self.im - oi)

    def __rsub__(self, o):
        orr, oi = _re_im(o)
        return CTensor(orr - self.re,
                       -self.im if oi is None else oi - self.im)

    def __mul__(self, o):
        orr, oi = _re_im(o)
        if oi is None:
            return CTensor(self.re * orr, self.im * orr)
        return CTensor(self.re * orr - self.im * oi,
                       self.re * oi + self.im * orr)

    __rmul__ = __mul__

    def __truediv__(self, o):
        orr, oi = _re_im(o)
        if oi is None:
            return CTensor(self.re / orr, self.im / orr)
        d = orr * orr + oi * oi
        return CTensor((self.re * orr + self.im * oi) / d,
                       (self.im * orr - self.re * oi) / d)

    def __neg__(self):
        return CTensor(-self.re, -self.im)

    # -- shape ops (mirror jnp.ndarray methods used by the CC equations) -
    def _map(self, fn):
        return CTensor(fn(self.re), fn(self.im))

    def swapaxes(self, a, b):
        return self._map(lambda x: jnp.swapaxes(x, a, b))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return self._map(lambda x: jnp.transpose(x, axes or None))

    @property
    def T(self):
        return self._map(lambda x: x.T)

    def reshape(self, *shape):
        return self._map(lambda x: x.reshape(*shape))

    def ravel(self):
        return self._map(lambda x: x.ravel())

    def astype(self, dtype):  # real-component cast only
        return self._map(lambda x: x.astype(dtype))

    def __getitem__(self, key):
        return self._map(lambda x: x[key])

    def sum(self):
        return CTensor(self.re.sum(), self.im.sum())

    def trace(self):
        return CTensor(jnp.trace(self.re), jnp.trace(self.im))

    @property
    def at(self):
        """jnp-style indexed-update proxy: X.at[i].add/set on both parts."""
        return _CTAt(self)


class _CTAt:
    def __init__(self, ct):
        self._ct = ct

    def __getitem__(self, key):
        return _CTAtIndexed(self._ct, key)


class _CTAtIndexed:
    def __init__(self, ct, key):
        self._ct, self._key = ct, key

    def _pair(self, other):
        o = other if isinstance(other, CTensor) else CTensor(other)
        return o.re, o.im

    def add(self, other):
        orr, oi = self._pair(other)
        return CTensor(self._ct.re.at[self._key].add(orr),
                       self._ct.im.at[self._key].add(oi))

    def set(self, other):
        orr, oi = self._pair(other)
        return CTensor(self._ct.re.at[self._key].set(orr),
                       self._ct.im.at[self._key].set(oi))


def ct_contract(subscripts, a, b, _real_contract=None):
    """Complex-aware einsum over CTensor/real operands.

    Karatsuba: 3 real contractions for complex x complex, 2 for mixed.
    `_real_contract(subscripts, x, y)` supplies the underlying real einsum.
    """
    ar, ai = _re_im(a)
    br, bi = _re_im(b)
    C = _real_contract
    if ai is None and bi is None:
        return C(subscripts, ar, br)
    if ai is None:
        return CTensor(C(subscripts, ar, br), C(subscripts, ar, bi))
    if bi is None:
        return CTensor(C(subscripts, ar, br), C(subscripts, ai, br))
    m1 = C(subscripts, ar, br)
    m2 = C(subscripts, ai, bi)
    m3 = C(subscripts, ar + ai, br + bi)
    return CTensor(m1 - m2, m3 - m1 - m2)


def ct_dot(a, b, preferred_element_type=None, contract_last=False):
    """Complex-aware 2-D dot (the vvvv ladder path).

    contract_last=True contracts a's LAST axis with b's LAST axis
    (A @ B.T) without materializing the transposed copy of b — the
    explicit .T on a (v^2, v^2) operand allocates a full transposed
    buffer per batch element under vmap/scan (8 GB at v=128, M=8)."""
    if contract_last:
        dot = lambda x, y: jax.lax.dot_general(
            x, y, (((1,), (1,)), ((), ())),
            preferred_element_type=preferred_element_type)
    else:
        dot = lambda x, y: jnp.dot(x, y, preferred_element_type=preferred_element_type)
    ar, ai = _re_im(a)
    br, bi = _re_im(b)
    if ai is None and bi is None:
        return dot(ar, br)
    if ai is None:
        return CTensor(dot(ar, br), dot(ar, bi))
    if bi is None:
        return CTensor(dot(ar, br), dot(ai, br))
    m1 = dot(ar, br)
    m2 = dot(ai, bi)
    m3 = dot(ar + ai, br + bi)
    return CTensor(m1 - m2, m3 - m1 - m2)


def ct_zeros_like(x):
    if isinstance(x, CTensor):
        return CTensor(jnp.zeros_like(x.re), jnp.zeros_like(x.im))
    return jnp.zeros_like(x)
