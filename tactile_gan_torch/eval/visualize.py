"""Image and plot artifacts of evaluation, as the JAX package writes them:
channel compositing for the 'ch' task, image strips, the loss curve, the
metric distribution plots and eval.txt.

Image helpers take HWC arrays: uint8 passes through, floats in [0, 1] are
clamped and rounded half to even in float64. PIL, matplotlib and scipy are
imported inside the functions that use them; ``can_plot`` says whether the
plots can be drawn on this host.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, Sequence

import numpy as np


def _u8(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.uint8:  # already quantized on the device
        return x
    return (np.clip(x.astype(np.float64), 0.0, 1.0) * 255.0).round().astype(np.uint8)


def to_pil(img_hwc: np.ndarray):
    from PIL import Image

    arr = _u8(img_hwc)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    return Image.fromarray(arr)


def compose_channels(out_hwc: np.ndarray):
    """Task-2 composite: channel 0 (axes) inverted as a grayscale base,
    channel 1 (grids) pasted in blue with itself as the alpha mask,
    channel 2 (content) pasted in red."""
    from PIL import Image
    from PIL.ImageOps import invert

    ax_msk = invert(Image.fromarray(_u8(out_hwc[:, :, 0])))
    grid_msk = Image.fromarray(_u8(out_hwc[:, :, 1]))
    content_msk = Image.fromarray(_u8(out_hwc[:, :, 2]))

    h, w = out_hwc.shape[:2]
    ax = np.stack([np.array(ax_msk)] * 3, axis=2)
    content = np.zeros((h, w, 3), np.uint8)
    content[:, :, 0] = np.array(content_msk)
    grid = np.zeros((h, w, 3), np.uint8)
    grid[:, :, 2] = np.array(grid_msk)

    base = Image.fromarray(ax)
    base.paste(Image.fromarray(grid), (0, 0), grid_msk)
    base.paste(Image.fromarray(content), (0, 0), content_msk)
    return base


def concat_images(*photos, mode: str = "h"):
    from PIL import Image

    if mode == "h":
        res = Image.new(photos[0].mode,
                        (sum(p.width for p in photos), photos[0].height))
        x = 0
        for p in photos:
            res.paste(p, (x, 0))
            x += p.width
    else:
        res = Image.new(photos[0].mode,
                        (photos[0].width, sum(p.height for p in photos)))
        y = 0
        for p in photos:
            res.paste(p, (0, y))
            y += p.height
    return res


def can_plot() -> bool:
    """Whether matplotlib is installed (the plots need it; nothing else
    does)."""
    return importlib.util.find_spec("matplotlib") is not None


def plot_loss(loss_dict: Dict[str, np.ndarray], initial_epoch: int,
              total_epochs: int, output_path: str,
              terms: Sequence[str] = ("gen", "disc")) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    x = np.arange(initial_epoch, initial_epoch + total_epochs)
    for term in terms:
        y = loss_dict[term]
        plt.plot(x[: len(y)], y)
    plt.legend(list(terms))
    plt.xlabel("iteration")
    plt.ylabel("loss")
    plt.savefig(os.path.join(output_path, "loss.png"))
    plt.close()


def plot_dist(data: Sequence[float], x_label: str, file_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.stats import norm

    data = np.asarray(data, float)
    mu, sigma = float(np.mean(data)), float(np.std(data))
    _, ax = plt.subplots()
    x = np.linspace(data.min(), data.max(), 100)
    pdf = norm.pdf(x, mu, max(sigma, 1e-9))
    pdf = pdf / np.max(pdf)
    ax.plot(x, pdf, color="blue", linewidth=2, label="PDF")
    for v, color, label in ((mu, "red", "$\\mu$"),
                            (mu + sigma, "green", "$\\mu+\\sigma$"),
                            (mu - sigma, "green", "$\\mu-\\sigma$")):
        idx = int(np.argmax(x >= v)) if np.any(x >= v) else -1
        ax.vlines(v, ymin=0, ymax=pdf[idx], color=color, linestyle="--",
                  linewidth=1, label=f"{label} = {v:.2f}")
    ax.set_ylim([0, 1])
    ax.set_xlabel(x_label)
    ax.set_ylabel("Probability Density")
    ax.set_title("Probability Distribution Function")
    ax.legend()
    plt.savefig(file_path)
    plt.close()


def write_evaluation(accuracy, dice, jaccard, output_path: str) -> None:
    """eval.txt and the summary line (no plots)."""
    lines = [
        f"Pixel Accuracy => min:{np.min(accuracy)}, max:{np.max(accuracy)}, "
        f"avg:{np.mean(accuracy)}, std:{np.std(accuracy)}\n",
        f"Dice Coeff => min:{np.min(dice)}, max:{np.max(dice)}, "
        f"avg:{np.mean(dice)}, std:{np.std(dice)}\n",
        f"Jaccard Index => min:{np.min(jaccard)}, max:{np.max(jaccard)}, "
        f"avg:{np.mean(jaccard)}, std:{np.std(jaccard)}\n",
    ]
    with open(os.path.join(output_path, "eval.txt"), "w") as f:
        f.writelines(lines)
    print(f"Acc: {np.mean(accuracy)}, IoU: {np.mean(jaccard)}, "
          f"Dice: {np.mean(dice)}")


def print_evaluation(accuracy, dice, jaccard, output_path: str) -> None:
    """eval.txt, the summary line and the three distribution plots."""
    write_evaluation(accuracy, dice, jaccard, output_path)
    plot_dist(accuracy, "accuracy", os.path.join(output_path, "accuracy_dist.png"))
    plot_dist(dice, "dice", os.path.join(output_path, "dice_dist.png"))
    plot_dist(jaccard, "jaccard", os.path.join(output_path, "jaccard_dist.png"))
