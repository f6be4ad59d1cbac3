"""Stencils, space-time operators and the paraboloid projection (counterpart of ofot_tpu.ops)."""
