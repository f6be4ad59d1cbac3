"""Host I/O, metrics, warping and checkpoints (counterpart of ofot_tpu.utils)."""
