"""Host I/O, metrics, warping and checkpoints (counterpart of ofot_tpu.utils)."""

from ofot_tpu_torch.utils import (  # noqa: F401
    flo, image, metrics, warp, colorwheel, checkpoint)
