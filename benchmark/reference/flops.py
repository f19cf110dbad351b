"""Work counts of one training step, taken from the reference on the meta
device (shapes only, nothing computed):

- ``step_flops``: the floating-point operations of one step of the
  reference at the cell's shapes, counted with the formulas of
  ``torch.utils.flop_counter`` (``FlopCounterMode``'s own module tracking
  breaks the gradient penalty's ``autograd.grad``): convolutions,
  transposed convolutions and matrix products, forward, backward and the
  penalty's second backward; elementwise work and reductions are not
  counted;
- ``generator_norm_shapes``: the (N, C, H, W) shape of every instance norm
  the generator's forward runs.

Neither reads anything of the program, so no change to it moves them.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from benchmark.reference.follow import (
    applies_gp, networks, step_spec, uses_vgg,
)
from benchmark.reference.models import NormRecorder, vgg_layers
from benchmark.reference.step import ReferenceTrainer


def _key(d: dict) -> str:
    return json.dumps(d, sort_keys=True)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


@functools.lru_cache(maxsize=None)
def _step_flops(config_json: str, traffic_json: str) -> int:
    config, traffic = json.loads(config_json), json.loads(traffic_json)
    gen, disc = networks(config, "f32", "meta")
    vgg = None
    if uses_vgg(traffic):
        vgg = {}
        for idx, cin, cout in vgg_layers(config["input_dim"]):
            vgg[f"features.{idx}.weight"] = torch.empty(
                (cout, cin, 3, 3), device="meta")
            vgg[f"features.{idx}.bias"] = torch.empty(cout, device="meta")
    trainer = ReferenceTrainer(gen, disc, vgg, step_spec(config, traffic),
                               None)
    size, batch = config["image_size"], traffic["batch_size"]
    shape = (batch, size, size, config["input_dim"])
    src = torch.empty(shape, dtype=torch.uint8, device="meta")
    tgt = torch.empty(shape[:-1] + (config["output_dim"],),
                      dtype=torch.uint8, device="meta")
    with _Counter() as counter:
        trainer.step(src, tgt, apply_gp=applies_gp(config, traffic))
    return int(counter.total)


def step_flops(config: dict, traffic: dict) -> int:
    return _step_flops(_key(config), _key(traffic))


def generator_norm_shapes(config: dict, batch: int):
    gen, _ = networks(config, "f32", "meta")
    gen.recorder = NormRecorder()
    size = config["image_size"]
    gen(torch.empty((batch, config["input_dim"], size, size), device="meta"))
    return gen.recorder.shapes
