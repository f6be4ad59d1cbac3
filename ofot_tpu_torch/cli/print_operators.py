"""Operator smoke tool — equivalent of the reference's test.py (C17).

Counterpart of ``ofot_tpu.cli.print_operators``: materializes the port's
matrix-free stencils as dense matrices (by applying them to identity
columns) and prints them exactly as the reference's manual harness does
(reference test.py:5-15), including the
``sum(-grad_st('N')^T - div_st('D'))`` adjointness probe.  Like the JAX
tool it runs on the CPU in float64: it is a printout, not a device path.

Usage: python -m ofot_tpu_torch.cli.print_operators
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def densify(apply_fn, in_shape):
    """Dense matrix of a linear stencil by acting on identity columns."""
    n_in = int(np.prod(in_shape))
    eye = torch.eye(n_in, dtype=torch.float64).reshape(
        (n_in,) + tuple(in_shape))
    cols = torch.stack([apply_fn(e) for e in eye])
    return cols.reshape(n_in, -1).numpy().T


def main(argv=None) -> int:
    from ofot_tpu_torch.ops import operators, stencils

    print(densify(lambda x: stencils.grad_forward(x, 1, "N"), (5,)))
    print(densify(lambda x: stencils.grad_backward(x, 1, "D"), (5,)))
    print(-densify(lambda x: stencils.grad_forward(x, 1, "N"), (5,)).T)

    grad = densify(lambda x: operators.grad_st(x, bc="N"), (3, 3, 3))
    div = densify(lambda m: operators.div_st(m, bc="D"), (3, 3, 3, 3))
    print(grad)
    print(div)

    print(np.sum(-grad.T - div))
    return 0


if __name__ == "__main__":
    sys.exit(main())
