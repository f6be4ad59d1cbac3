"""Flow evaluation metrics: endpoint error, angular error, interpolation error.

Vectorized equivalents of the reference metrics (reference utils.py:294-354)
including their filtering quirks (SURVEY.md §2 quirk 7):

  * EE silently drops outlier pixels with endpoint error > 50
    (reference utils.py:310-312);
  * AE uses the Middlebury 1.0-augmented cosine formula and drops NaN
    pixels (arccos argument out of [-1, 1], reference utils.py:331-335);
  * both return population (not sample) standard deviations;
  * IE is the RMS image difference scaled by 255 (reference utils.py:354).

These run in host numpy on small arrays after the solve: every caller
evaluates them once per solve, so a device round trip would cost more than
the arithmetic.  A copy of ``ofot_tpu.utils.metrics``, kept in the port so
that the port never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


def _masked_mean_std(values, mask):
    cnt = np.sum(mask)
    if cnt == 0:
        # every pixel dropped (all-outlier EE / all-NaN AE, e.g. a fully
        # divergent solve): return NaN explicitly instead of tripping a
        # 0/0 RuntimeWarning — callers see it in benchmark.txt/manifest
        # as the signal it is (review, round 4)
        return float("nan"), float("nan")
    mean = np.sum(np.where(mask, values, 0.0)) / cnt
    var = np.sum(np.where(mask, (values - mean) ** 2, 0.0)) / cnt
    return mean, np.sqrt(var)


def endpoint_error(u, v, u_gt, v_gt, outlier_threshold: float = 50.0):
    """(mean, stddev) endpoint error, ignoring pixels with EE > 50."""
    ee = np.sqrt((u - u_gt) ** 2 + (v - v_gt) ** 2)
    return _masked_mean_std(ee, ee <= outlier_threshold)


def angular_error(u, v, u_gt, v_gt):
    """(mean, stddev) angular error in radians, NaN pixels dropped."""
    cosang = (1.0 + u * u_gt + v * v_gt) / (
        np.sqrt(1.0 + u * u + v * v) * np.sqrt(1.0 + u_gt * u_gt + v_gt * v_gt))
    with np.errstate(invalid="ignore"):
        ae = np.arccos(cosang)       # NaN when |cosang| > 1, like the reference
    mask = ~np.isnan(ae)
    return _masked_mean_std(np.where(mask, ae, 0.0), mask)


def interpolation_error(image, image_gt):
    """RMS image error on the 255 scale (scalar)."""
    diff = 255.0 * (np.asarray(image, dtype=np.float64)
                    - np.asarray(image_gt, dtype=np.float64))
    return np.sqrt(np.sum(diff * diff) / diff.size)


# reference-style aliases operating on flat arrays
def EE(w, h, u, v, u_gt, v_gt):
    m, s = endpoint_error(np.asarray(u), np.asarray(v),
                          np.asarray(u_gt), np.asarray(v_gt))
    return float(m), float(s)


def AE(w, h, u, v, u_gt, v_gt):
    m, s = angular_error(np.asarray(u), np.asarray(v),
                         np.asarray(u_gt), np.asarray(v_gt))
    return float(m), float(s)


def IE(w, h, image, image_gt):
    return float(interpolation_error(image, image_gt))
