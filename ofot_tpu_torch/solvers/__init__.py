"""FOTO solver, spectral and CG stepA, flow extraction (counterpart of ofot_tpu.solvers)."""
