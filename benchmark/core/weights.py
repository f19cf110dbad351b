"""Weights made from the run's seed on the device, in a few large draws:
the published initialization (every conv and transposed-conv weight
~ N(0, 0.02), biases 0, instance-norm affine (1, 0); any other parameter
by the network's own ``published_init``, drawn after those) for G and D,
and He-normal weights (std sqrt(2 / (9 cin)), biases 0) for the VGG16
tower of the v1 perceptual loss, whose pretrained weights are not in the
repository. One generator stream a network, so the same seed gives the
same weights on either side and every time they are made again.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from benchmark.reference.models import vgg_layers

STREAMS = {"gen": 1, "disc": 2, "vgg": 3}


def stream_seed(seed: int, stream: str) -> int:
    return (seed * 1_000_003 + STREAMS[stream]) % (2 ** 63)


def network_weights(model: nn.Module, seed: int, stream: str, device
                    ) -> Dict[str, torch.Tensor]:
    """float32 weights for every parameter of ``model`` (whose own values,
    on any device, are not read). Convs, transposed convs and affine
    instance norms are drawn here; every other parameter, in the order of
    ``named_parameters``, by ``model.published_init(name, shape,
    generator)`` from the same stream after the convs' draw."""
    convs, out = [], {}
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            convs.append((prefix + "weight", tuple(m.weight.shape)))
            if m.bias is not None:
                out[prefix + "bias"] = torch.zeros(m.bias.shape,
                                                   device=device)
        elif isinstance(m, nn.InstanceNorm2d) and m.affine:
            out[prefix + "weight"] = torch.ones(m.weight.shape, device=device)
            out[prefix + "bias"] = torch.zeros(m.bias.shape, device=device)
    total = sum(math.prod(s) for _, s in convs)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    flat = torch.randn(total, generator=gen, device=device).mul_(0.02)
    at = 0
    for name, shape in convs:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    rest = [(n, tuple(p.shape)) for n, p in model.named_parameters()
            if n not in out]
    init = getattr(model, "published_init", None)
    if rest and init is None:
        raise ValueError(f"parameters not covered: {[n for n, _ in rest]}")
    for name, shape in rest:
        w = init(name, shape, gen)
        if tuple(w.shape) != shape:
            raise ValueError(f"{name}: published_init gave "
                             f"{tuple(w.shape)}, not {shape}")
        out[name] = w.to(device=device, dtype=torch.float32)
    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(out):
        raise ValueError(f"parameters not covered: "
                         f"{sorted(set(names) ^ set(out))}")
    return out


def vgg_weights(seed: int, device, input_dim: int = 3
                ) -> Dict[str, torch.Tensor]:
    layers = list(vgg_layers(input_dim))
    sizes = [cout * cin * 9 for _, cin, cout in layers]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "vgg"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (idx, cin, cout), n in zip(layers, sizes):
        out[f"features.{idx}.weight"] = flat[at:at + n].view(
            cout, cin, 3, 3).mul_(math.sqrt(2.0 / (9 * cin)))
        out[f"features.{idx}.bias"] = torch.zeros(cout, device=device)
        at += n
    return out


@torch.no_grad()
def load_into(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters, every name and shape
    matched."""
    params = dict(model.named_parameters())
    if sorted(params) != sorted(weights):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(params) ^ set(weights))}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: {tuple(p.shape)} against "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
