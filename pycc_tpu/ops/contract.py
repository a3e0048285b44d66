"""Tensor-contraction layer: einsum -> XLA dot_general graphs.

Replaces the reference's opt_einsum/torch dispatch backend
(/root/reference/pycc/utils.py:141-187).  Under jit every contraction
lowers to dot_general and is fused/tiled by XLA; there is no
per-call device migration — operands live where the mesh puts them.

CTensor (real/imag-split complex, ops/ctensor.py) operands dispatch to
Karatsuba's three real contractions, for a backend without complex
arithmetic.
"""

import jax.numpy as jnp


def _einsum(subscripts, *operands, precision=None):
    return jnp.einsum(subscripts, *operands, optimize=True,
                      precision=precision)


def contract(subscripts, *operands, precision=None):
    """einsum with an optimal contraction path (complex-split aware).

    jnp.einsum lowers to lax.dot_general; `optimize` lets 3+-operand
    contractions pick the cheapest pairwise order at trace time.
    """
    from .ctensor import CTensor, ct_contract
    if not any(isinstance(o, CTensor) for o in operands):
        return _einsum(subscripts, *operands, precision=precision)
    if len(operands) == 2:
        return ct_contract(subscripts, operands[0], operands[1],
                           _real_contract=lambda s, a, b: _einsum(
                               s, a, b, precision=precision))
    # 3+ operands with a CTensor: contract pairwise left-to-right
    inputs, out = subscripts.split("->")
    labs = inputs.split(",")
    acc = operands[0]
    acc_lab = labs[0]
    for k in range(1, len(operands)):
        rest = set("".join(labs[k + 1:]) + out)
        keep = "".join(dict.fromkeys(
            c for c in acc_lab + labs[k] if c in rest)) if k < len(operands) - 1 else out
        sub = acc_lab + "," + labs[k] + "->" + keep
        acc = contract(sub, acc, operands[k], precision=precision)
        acc_lab = keep
    return acc
