"""Stencils, space-time operators and the paraboloid projection (counterpart of ofot_tpu.ops)."""

from ofot_tpu_torch.ops import stencils, operators, projection  # noqa: F401
