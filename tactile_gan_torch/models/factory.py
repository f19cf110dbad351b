"""Generator and discriminator factories (case-insensitive names, like the
JAX package), and ``networks``: both networks of a training config."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from tactile_gan_torch.models.bcdunet import BCDUNet
from tactile_gan_torch.models.patch_discriminator import PatchDiscriminator
from tactile_gan_torch.models.spade import SPADEGenerator
from tactile_gan_torch.models.unet import UNet
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus

GENERATORS = {"unet++": UNetPlusPlus, "unet": UNet, "bcdunet": BCDUNet,
              "spade": SPADEGenerator}


def create_generator(name: str, input_dim: int = 3, output_dim: int = 3,
                     nf: int = 64, activation: bool = True,
                     compute_dtype: torch.dtype = torch.float32,
                     space_to_depth: bool = False,
                     bf16_resident: bool = False) -> nn.Module:
    """``bf16_resident`` applies to UNet++ only; UNet and BCDUNet ignore it,
    as the JAX factory does, and so does SPADE, which the JAX package does
    not have."""
    key = name.lower()
    if space_to_depth and key != "unet++":
        raise ValueError("--space_to_depth is only supported for UNet++")
    cls = GENERATORS.get(key)
    if cls is None:
        raise NameError(f"{name} not a valid generator")
    kw = {}
    if key == "unet++":
        kw = dict(space_to_depth=space_to_depth, bf16_resident=bf16_resident)
    return cls(input_dim=input_dim, output_dim=output_dim, nf=nf,
               activation=activation, compute_dtype=compute_dtype, **kw)


def create_discriminator(name: str = "patch", input_dim: int = 3,
                         output_dim: int = 3, nf: int = 64,
                         activation: bool = True,
                         compute_dtype: torch.dtype = torch.float32,
                         same_pad: bool = False,
                         resident: bool = False) -> nn.Module:
    if name.lower() == "patch":
        return PatchDiscriminator(input_dim=input_dim, output_dim=output_dim,
                                  nf=nf, activation=activation,
                                  compute_dtype=compute_dtype,
                                  same_pad=same_pad, resident=resident)
    raise NameError(f"{name} not a valid discriminator")


def networks(cfg) -> Tuple[nn.Module, nn.Module]:
    """The generator and the discriminator that a ``TrainConfig`` trains:
    its widths, variants, compute dtype, residency (``--bf16_resident``,
    ``--disc_bf16``) and the loss's activations (Tanh and sigmoid for 'ls'
    only)."""
    kw = dict(input_dim=cfg.input_dim, output_dim=cfg.output_dim, nf=cfg.nf,
              activation=cfg.activation,
              compute_dtype=cfg.torch_compute_dtype)
    return (create_generator(cfg.gen, space_to_depth=cfg.space_to_depth,
                             bf16_resident=cfg.effective_bf16_resident(),
                             **kw),
            create_discriminator("patch", same_pad=cfg.disc_same_pad,
                                 resident=cfg.effective_disc_bf16(), **kw))
