"""Small IO helpers."""

from __future__ import annotations

import os


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)
