"""Augmentation-preview CLI: ``python -m
tactile_gan_torch.cli.visualize_augmentation --data_dir DIR``.

The flags of the repository's ``visualize_augmentation.py`` plus
``--device`` (default cuda). Renders raw and augmented source/target samples
to PNG, the channel-wise target composited additively (axes red, grids
green, content blue). The augmentation is the training step's on-device
stage (``data/augment.py``), drawn from a generator seeded with ``--seed``
plus the sample's index. ``combine_channels`` and ``save_pm1_image`` are
framework-free copies of the JAX CLI's helpers.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image


def combine_channels(axes: np.ndarray, grid: np.ndarray,
                     content: np.ndarray) -> Image.Image:
    """Additive RGB blend: grid in green, axes in red, content in blue."""
    h, w = axes.shape
    base = np.zeros((h, w, 3), dtype=np.uint8)
    base[..., 1] = np.clip(grid.astype(np.int32), 0, 255)
    base[..., 0] = np.clip(base[..., 0] + axes.astype(np.int32), 0, 255)
    base[..., 2] = np.clip(base[..., 2] + content.astype(np.int32), 0, 255)
    return Image.fromarray(base)


def save_pm1_image(arr_hwc: np.ndarray, path: str) -> None:
    """[-1, 1] float HWC -> PNG."""
    u8 = np.clip((arr_hwc * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    if u8.shape[2] == 1:
        u8 = u8[:, :, 0]
    Image.fromarray(u8).save(path)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Visualize dataset augmentation")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="./augmentation_vis")
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--target_mode", type=str, default="non_rgb",
                        choices=["rgb", "non_rgb"])
    # Kept for the reference CLI's surface: it defines the flag and never
    # reads it (raw and augmented samples are always rendered).
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--seed", type=int, default=21)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from tactile_gan_torch.core.device import resolve_device
    from tactile_gan_torch.data.augment import preprocess_batch
    from tactile_gan_torch.data.dataset import PairedDataset

    dev = resolve_device(args.device)
    target = "rgb" if args.target_mode == "rgb" else "ch"
    ds = PairedDataset(args.data_dir, size=args.size, mode="train", aug=True,
                       target=target)
    os.makedirs(args.output_dir, exist_ok=True)

    def comps(t):
        u8 = np.clip(t * 255.0, 0, 255).astype(np.uint8)
        return u8[:, :, 0], u8[:, :, 1], u8[:, :, 2]

    n = min(args.num_samples, len(ds))
    for i in range(n):
        src_u8, tgt_u8 = (torch.from_numpy(np.array(a[None])).to(dev)
                          for a in ds.load_pair(i))
        gen = torch.Generator(device=dev).manual_seed(args.seed + i)
        views = {"raw": preprocess_batch(src_u8, tgt_u8, augment=False),
                 "aug": preprocess_batch(src_u8, tgt_u8, augment=True,
                                         generator=gen)}
        for kind, (s, t) in views.items():
            s, t = s[0].cpu().numpy(), t[0].cpu().numpy()
            save_pm1_image(s, os.path.join(args.output_dir,
                                           f"sample_{i}_source_{kind}.png"))
            path = os.path.join(args.output_dir,
                                f"sample_{i}_target_{kind}.png")
            if target == "rgb":
                # Targets are [0, 1]: through the [-1, 1] writer rescaled.
                save_pm1_image(t * 2 - 1, path)
            else:
                combine_channels(*comps(t)).save(path)

    print(f"wrote {n} raw/augmented sample pairs to {args.output_dir}")


if __name__ == "__main__":
    main()
