"""Source→tactile file pairing.

The reference pairs images purely by path rewriting
(reference datasets/PairedDataset.py:64): ``source``→``tactile``,
``s_``→``t_``, ``.png``→``.tiff``; task 2 ('ch') expects three grayscale
components ``*_axes`` / ``*_grids`` / ``*_content``
(PairedDataset.py:73-76). File discovery is a sorted recursive walk filtered
by extension (PairedDataset.py:21-28,45-48).
"""

from __future__ import annotations

import os
from typing import Dict, List

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".svg", ".tiff")


def is_image(filename: str) -> bool:
    return filename.lower().endswith(IMG_EXTENSIONS)


def list_images(img_dir: str) -> List[str]:
    """Recursive walk. The reference sorts only the walk tuples, leaving
    filename order filesystem-dependent (PairedDataset.py:22); we sort file
    names too so dataset order is deterministic across hosts.

    A missing directory raises instead of silently yielding an empty list
    (os.walk swallows it): a mistyped --data on the eval CLIs otherwise
    writes an empty Outputs tree with no hint of what went wrong."""
    if not os.path.isdir(img_dir):
        raise FileNotFoundError(f"image directory does not exist: {img_dir}")
    images = []
    for root, _, fnames in sorted(os.walk(img_dir)):
        for fname in sorted(fnames):
            if is_image(fname):
                images.append(os.path.join(root, fname))
    return images


def tactile_paths_for(source_path: str, target: str = "rgb") -> Dict[str, str]:
    """Derive the tactile path(s) for a source image.

    Returns {'rgb': path} for task 1 or {'axes','grids','content'} for task 2.
    """
    # The reference rewrites the whole path string, which breaks whenever a
    # parent directory happens to contain "s_" or ".png". We scope the
    # filename rewrites to the basename — identical results for the layout
    # the reference documents (data/{split}/source/s_*.png).
    dirname, basename = os.path.split(source_path)
    dirname = dirname.replace("source", "tactile")
    basename = basename.replace("s_", "t_").replace(".png", ".tiff")
    stem, ext = os.path.join(dirname, basename).rsplit(".", 1)
    if target == "rgb":
        return {"rgb": f"{stem}.{ext}"}
    return {
        "axes": f"{stem}_axes.{ext}",
        "grids": f"{stem}_grids.{ext}",
        "content": f"{stem}_content.{ext}",
    }
