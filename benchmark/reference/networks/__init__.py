"""The reference networks, one module each in this directory, found by the
name that a configuration gives in its ``gen`` or ``disc`` key.

Every module here whose name does not start with ``_`` is loaded by path,
as ``core/spec.py`` loads a metric's reader, and declares:

- ``NAME``: the value of the configuration's key, such as ``"UNet++"``
  or ``"PatchGAN"``;
- ``ROLE``: ``"gen"`` or ``"disc"``, the key that names it;
- ``NETWORK``: its ``nn.Module`` class, built with ``prec`` (the conv
  precision of ``models.py``) and, by keyword, the configuration's value
  of each other parameter its constructor names (``input_dim``, ``nf``,
  ...), which the configuration must hold;
- a generator's ``CPU_TEST_SIZE``: the smallest square image its stages
  take, the CPU tests' tiny size.

A class may define ``published_init(name, shape, generator)`` for the
parameters that ``core/weights.py`` does not draw itself. A new network
is one more file here: nothing else in the harness names one.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import inspect
import os
from typing import Dict, Optional

from torch import nn

DIR = os.path.dirname(os.path.abspath(__file__))
ROLES = ("gen", "disc")


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str
    role: str
    network: type
    cpu_test_size: Optional[int]
    path: str


def _load(path: str):
    stem = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        "bench_network_" + stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def table(directory: str = DIR) -> Dict[str, Entry]:
    """Every network of ``directory`` by its ``NAME``."""
    out: Dict[str, Entry] = {}
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        path = os.path.join(directory, fname)
        module = _load(path)
        need = ["NAME", "ROLE", "NETWORK"]
        if getattr(module, "ROLE", None) == "gen":
            need.append("CPU_TEST_SIZE")
        missing = [k for k in need if not hasattr(module, k)]
        if missing:
            raise ValueError(f"{path} declares no {', '.join(missing)}")
        if module.ROLE not in ROLES:
            raise ValueError(f"{path}: ROLE {module.ROLE!r} is none of "
                             f"{ROLES}")
        if module.NAME in out:
            raise ValueError(f"{path}: NAME {module.NAME!r} is "
                             f"{out[module.NAME].path}'s too")
        out[module.NAME] = Entry(module.NAME, module.ROLE, module.NETWORK,
                                 getattr(module, "CPU_TEST_SIZE", None), path)
    return out


def find(name: str, role: str) -> Entry:
    """The ``role`` network called ``name``."""
    entries = table()
    entry = entries.get(name)
    if entry is None or entry.role != role:
        have = sorted(n for n, e in entries.items() if e.role == role)
        raise KeyError(f"no reference {role} network {name!r} in {DIR} "
                       f"(have {have})")
    return entry


def build(config: dict, role: str, prec: str) -> nn.Module:
    """The network that ``config[role]`` names, at the configuration's
    sizes and under ``prec``."""
    cls = find(config[role], role).network
    keys = [k for k in inspect.signature(cls).parameters if k != "prec"]
    missing = [k for k in keys if k not in config]
    if missing:
        raise KeyError(f"{config['name']}: {cls.__name__} takes "
                       f"{', '.join(missing)}, which it does not state")
    return cls(prec=prec, **{k: config[k] for k in keys})
