"""Generator and discriminator factories (case-insensitive names, like the
JAX package)."""

from __future__ import annotations

import torch
from torch import nn

from tactile_gan_torch.models.bcdunet import BCDUNet
from tactile_gan_torch.models.patch_discriminator import PatchDiscriminator
from tactile_gan_torch.models.unet import UNet
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus

GENERATORS = {"unet++": UNetPlusPlus, "unet": UNet, "bcdunet": BCDUNet}


def create_generator(name: str, input_dim: int = 3, output_dim: int = 3,
                     nf: int = 64, activation: bool = True,
                     compute_dtype: torch.dtype = torch.float32) -> nn.Module:
    cls = GENERATORS.get(name.lower())
    if cls is None:
        raise NameError(f"{name} not a valid generator")
    return cls(input_dim=input_dim, output_dim=output_dim, nf=nf,
               activation=activation, compute_dtype=compute_dtype)


def create_discriminator(name: str = "patch", input_dim: int = 3,
                         output_dim: int = 3, nf: int = 64,
                         activation: bool = True,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> nn.Module:
    if name.lower() == "patch":
        return PatchDiscriminator(input_dim=input_dim, output_dim=output_dim,
                                  nf=nf, activation=activation,
                                  compute_dtype=compute_dtype)
    raise NameError(f"{name} not a valid discriminator")
