"""Hand-written CUDA kernels with their plain torch versions (counterpart of ofot_tpu.ops.pallas)."""
