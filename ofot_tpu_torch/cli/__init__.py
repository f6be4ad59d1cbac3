"""Command-line entry point (counterpart of ofot_tpu.cli)."""
