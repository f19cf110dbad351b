"""Evaluation metrics — fuzzy pixel accuracy / Dice / Jaccard and the binary
(otsu-thresholded) variants, matching reference test.py:113-146 and
util.py:147-166.

The fuzzy branch (the one the reference actually uses, test.py:210) operates
on raw float arrays:
    accuracy = sum(min(o, r)) / sum(r)
    jaccard  = sum(o*r) / sum(o^2 + r^2 - o*r)
    dice     = 2*sum(o*r) / sum(o^2 + r^2)
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np


def otsu_threshold(image: np.ndarray) -> float:
    """Otsu's between-class-variance threshold over a [0,1] image, 255 bins
    (parity with reference util.py:147-166 including its bin edges)."""
    hist, _ = np.histogram(image, bins=np.linspace(0, 1, 256))
    hist_norm = hist.astype(float) / np.sum(hist)
    cumsum = np.cumsum(hist_norm)
    cummean = np.cumsum(hist_norm * np.arange(255) / 255.0)
    global_mean = np.sum(hist_norm * np.arange(255) / 255.0)
    variances = np.zeros(255)
    for t in range(255):
        w0 = cumsum[t]
        w1 = 1.0 - w0
        if w0 == 0.0 or w1 == 0.0:
            continue
        mu0 = cummean[t] / w0
        mu1 = (global_mean - cummean[t]) / w1
        variances[t] = w0 * w1 * (mu0 - mu1) ** 2
    return float(np.argmax(variances)) / 255.0


def eval_pair(
    real: np.ndarray,
    out: np.ndarray,
    thresh: Optional[Union[str, float]] = None,
    fuzzy: bool = True,
) -> Dict[str, float]:
    """real/out: CHW or HWC float arrays (shape-agnostic reductions except
    the per-channel thresholds, which use axis 0 like the reference)."""
    o = np.asarray(out, dtype=np.float64)
    r = np.asarray(real, dtype=np.float64)

    if fuzzy:
        intersection = np.sum(o * r)
        denominator = np.sum(o ** 2 + r ** 2)
        union = np.sum(o ** 2 + r ** 2 - o * r)
        accuracy = np.sum(np.minimum(o, r)) / np.sum(r)
        jaccard = intersection / union
        dice = 2 * intersection / denominator
    else:
        if thresh == "otsu":
            threshold = [otsu_threshold(ch) for ch in r]
        elif isinstance(thresh, float):
            threshold = [thresh] * r.shape[0]
        else:
            threshold = [0.5] * r.shape[0]
        o_bin = np.array([o[i] < threshold[i] for i in range(o.shape[0])]).ravel()
        r_bin = np.array([r[i] < threshold[i] for i in range(r.shape[0])]).ravel()
        accuracy = np.sum(o_bin == r_bin) / o_bin.shape[0]
        intersection = np.logical_and(o_bin, r_bin)
        union = np.logical_or(o_bin, r_bin)
        jaccard = np.sum(intersection) / np.sum(union)
        dice = 2 * np.sum(intersection) / (np.sum(o_bin) + np.sum(r_bin))

    return {"accuracy": float(accuracy), "dice": float(dice),
            "jaccard": float(jaccard)}
