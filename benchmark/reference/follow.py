"""The reference's side of the output check: builds the reference
networks on ``device`` with the weights made from the seed, decodes and
augments the run's first batches from the chart files, and follows the
program's first steps in float32 with TF32 off (or in the lower precision
or with the fault that a control reading asks for). Given the judged
side's state (``at``), it then takes step 2's gradients from that state.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmark.core.check import (
    Readings, STEPS, Tensors, first_grads, host_copy, later_grads,
    leaf_norms,
)
from benchmark.core.weights import load_into, network_weights, vgg_weights
from benchmark.reference.data import epoch_batches
from benchmark.reference.networks import build
from benchmark.reference.step import ReferenceTrainer, StepSpec

INITIAL_EPOCH = 1


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# A precision of the step -> (G's, D's) precision in ``models.py``.
PRECISIONS = {"f32": ("f32", "f32"), "bf16": ("bf16", "bf16"),
              "fp8": ("fp8", "fp8"), "fp8_gbwd": ("fp8_bwd", "bf16"),
              "bf16_gfwd": ("bf16_fwd", "bf16")}


def networks(config: dict, prec: str, device) -> Tuple[torch.nn.Module,
                                                       torch.nn.Module]:
    """G and D as the configuration's ``gen`` and ``disc`` name them."""
    gen, disc = PRECISIONS[prec]
    return (build(config, "gen", gen).to(device),
            build(config, "disc", disc).to(device))


def step_spec(config: dict, traffic: dict) -> StepSpec:
    if config["loss"] != "ls" or config["disc_same_pad"]:
        raise ValueError("the reference follows the 'ls' loss and the "
                         "valid-padding PatchGAN only")
    return StepSpec(version=traffic["version"], lambda_a=config["lambda_a"],
                    lambda_gp=config["lambda_gp"],
                    lambda_per=traffic["lambda_per"],
                    w_per=tuple(config["w_per"]), lr=config["lr"],
                    beta1=config["beta1"],
                    epoch_constant=config["epoch_constant"],
                    total_epochs=config["total_epochs"],
                    steps_per_epoch=traffic["pairs"] // traffic["batch_size"],
                    beta2=config["beta2"], eps=config["adam_eps"],
                    label_smoothing=config["label_smoothing"])


def uses_vgg(traffic: dict) -> bool:
    return traffic["lambda_per"] != 0 and traffic["version"] == 1


def applies_gp(config: dict, traffic: dict, epoch: int = INITIAL_EPOCH
               ) -> bool:
    return (traffic["reg_every"] != 0 and epoch % traffic["reg_every"] == 0
            and config["lambda_gp"] != 0)


def follow(config: dict, traffic: dict, seed: int, img_dir: str, device,
           prec: str = "f32", fault: str = "",
           at: Optional[Dict[str, Tensors]] = None) -> Readings:
    """The readings over the first ``STEPS`` steps; step 2's gradients are
    taken at ``at`` (the judged side's state) where it is given, and are
    the side's own, with the state they were taken at, where it is not."""
    with tf32_off():
        gen, disc = networks(config, prec, device)
        start = {"gen": network_weights(gen, seed, "gen", device),
                 "disc": network_weights(disc, seed, "disc", device)}
        load_into(gen, start["gen"])
        load_into(disc, start["disc"])
        vgg = vgg_weights(seed, device) if uses_vgg(traffic) else None
        spec = step_spec(config, traffic)
        rng = torch.Generator(device=device).manual_seed(seed)
        trainer = ReferenceTrainer(gen, disc, vgg, spec, rng, fault)
        batches = [tuple(torch.from_numpy(a).to(device) for a in b)
                   for b in epoch_batches(img_dir, traffic["batch_size"],
                                          seed, INITIAL_EPOCH, STEPS,
                                          augment=traffic["host_aug"])]
        gp = applies_gp(config, traffic)
        nets = {"gen": (gen, trainer.opt_g), "disc": (disc, trainer.opt_d)}

        def moments(net):
            model, opt = nets[net]
            return host_copy(zip((n for n, _ in model.named_parameters()),
                                 opt.m))

        losses, own, keep = [], {}, at is None
        for i, (src, tgt) in enumerate(batches):
            if i == 1:
                draws = rng.get_state()
                if keep:
                    own = {net: host_copy(model.named_parameters())
                           for net, (model, _) in nets.items()}
                    m1 = {net: moments(net) for net in nets}
            losses.append(trainer.step(src, tgt, apply_gp=gp).cpu().numpy())
            if i == 0:
                grads = {net: leaf_norms(first_grads(model, opt.m,
                                                     spec.beta1))
                         for net, (model, opt) in nets.items()}
            elif i == 1 and keep:
                replay = {net: later_grads(m1[net], moments(net), spec.beta1)
                          for net in nets}
                own["disc_after"] = host_copy(disc.named_parameters())
        change = {net: leaf_norms({n: p - start[net][n]
                                   for n, p in model.named_parameters()})
                  for net, (model, _) in nets.items()}
        if at is not None:
            load_into(gen, at["gen"])
            load_into(disc, at["disc"])
            rng.set_state(draws)
            replay = trainer.gradients(*batches[1], gp, at["disc_after"])
        return Readings(np.stack(losses).astype(np.float64), grads, change,
                        replay, own)
