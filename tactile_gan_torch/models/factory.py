"""Generator and discriminator factories (case-insensitive names, like the
JAX package), and ``networks``: both networks of a training config."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from tactile_gan_torch.models.bcdunet import BCDUNet
from tactile_gan_torch.models.patch_discriminator import PatchDiscriminator
from tactile_gan_torch.models.unet import UNet
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus

GENERATORS = {"unet++": UNetPlusPlus, "unet": UNet, "bcdunet": BCDUNet}


def create_generator(name: str, input_dim: int = 3, output_dim: int = 3,
                     nf: int = 64, activation: bool = True,
                     compute_dtype: torch.dtype = torch.float32,
                     space_to_depth: bool = False) -> nn.Module:
    key = name.lower()
    if space_to_depth and key != "unet++":
        raise ValueError("--space_to_depth is only supported for UNet++")
    cls = GENERATORS.get(key)
    if cls is None:
        raise NameError(f"{name} not a valid generator")
    kw = dict(space_to_depth=True) if space_to_depth else {}
    return cls(input_dim=input_dim, output_dim=output_dim, nf=nf,
               activation=activation, compute_dtype=compute_dtype, **kw)


def create_discriminator(name: str = "patch", input_dim: int = 3,
                         output_dim: int = 3, nf: int = 64,
                         activation: bool = True,
                         compute_dtype: torch.dtype = torch.float32,
                         same_pad: bool = False) -> nn.Module:
    if name.lower() == "patch":
        return PatchDiscriminator(input_dim=input_dim, output_dim=output_dim,
                                  nf=nf, activation=activation,
                                  compute_dtype=compute_dtype,
                                  same_pad=same_pad)
    raise NameError(f"{name} not a valid discriminator")


def networks(cfg) -> Tuple[nn.Module, nn.Module]:
    """The generator and the discriminator that a ``TrainConfig`` trains:
    its widths, variants, compute dtype and the loss's activations (Tanh
    and sigmoid for 'ls' only)."""
    kw = dict(input_dim=cfg.input_dim, output_dim=cfg.output_dim, nf=cfg.nf,
              activation=cfg.activation,
              compute_dtype=cfg.torch_compute_dtype)
    return (create_generator(cfg.gen, space_to_depth=cfg.space_to_depth,
                             **kw),
            create_discriminator("patch", same_pad=cfg.disc_same_pad, **kw))
