"""The output check: what the timed path produced in its first three
training steps, against the plain reference's three steps on the same
inputs.

Both sides start from the weights made from the seed, take the same three
batches of the run's first epoch (the reference decodes and augments the
chart files itself) and the same draws (label noise, then the gradient
penalty's alpha, from a generator seeded with the run's seed). The
program's first gradient is read from Adam's first moment after one step
(m / (1 - beta1)), as the optimizer got it; its parameters' change after
the third step, before the fourth. Compared, each against its limit in
``limits/<cell>.json``:

- ``loss_gap``: over the three steps and the two objectives (D's GAN loss
  plus the gradient penalty; G's GAN term plus L1 times ``lambda_a`` plus
  the perceptual term), the largest |program - reference| / |reference|;
- ``grad_gap``: each leaf's first gradient by its norm: the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and its network's median leaf norm; of G's leaves and
  of D's, the median gap, and of those two the larger;
- ``change_gap``: each leaf's change over the three steps, by the worst
  leaf of G and D, measured as ``grad_gap`` measures a leaf; leaves whose
  reference gradient is under a thousandth of their network's median leaf
  gradient are left out (Adam moves them by round-off alone);
- ``disc_grad_error`` and ``gen_grad_error``: D's and G's gradients of
  step 2, the first step the program takes by replaying its CUDA graph (the
  timed path's own call), entry by entry. The program's are worked out
  from Adam's first moments after steps 1 and 2 ((m2 - beta1 m1) / (1 -
  beta1)). The reference takes them at the program's own state: D's at G
  and D as the program left them after step 1, G's at G after step 1 and
  D after step 2's D update (as the program's G step sees it), on step
  2's batch and draws. So nothing but step 2's arithmetic moves them, not
  the chaotic first updates. Each is, for every leaf of its network,
  |program - reference| / |reference| over the leaf's entries, and the
  median over the leaves (leaves left out as for ``change_gap``). D's
  covers D's forward and backward and the gradient penalty's double
  backward; G's covers G's forward, D on the fake, the losses and G's
  backward (kernels C, B-dx and D in UNet++). Over all of a network's
  entries at once its input layer's weight would decide, whose gradient
  the configuration's bf16 forward alone moves by up to a fifth on some
  seeds (``PERF.md``).

Read and reported, not compared: ``grad_gap_worst``, ``grad_gap`` by the
worst leaf instead of the median: G's worst leaf is its input layer's
weight, whose gradient (taken after D's first update) swings from seed to
seed in sound runs as widely as under a lower precision (``PERF.md``). A
loss that is not finite fails the run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

CHECKED = ("loss_gap", "grad_gap", "change_gap", "disc_grad_error",
           "gen_grad_error")
REPORTED = ("grad_gap_worst",)
STEPS = 3
TINY_GRAD = 1e-3

Norms = Dict[str, float]  # leaf (parameter name) -> its norm
Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Readings:
    """losses: (STEPS, 5); grad_norms / change_norms: network ("gen",
    "disc") -> the norm of each leaf; replay_grads: network -> each leaf's
    gradient in step 2; at: the parameters those were taken at ("gen" and
    "disc" after step 1, "disc_after" after step 2's D update), kept by
    the side that is judged for the reference to start from."""
    losses: np.ndarray
    grad_norms: Dict[str, Norms]
    change_norms: Dict[str, Norms]
    replay_grads: Dict[str, Tensors]
    at: Dict[str, Tensors] = dataclasses.field(default_factory=dict)


def leaf_norms(named: Tensors) -> Norms:
    if not named:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(t.detach().double())
                         for t in named.values()])
    return dict(zip(named, norms.cpu().tolist()))


def _leaf_gaps(prog: Norms, ref: Norms, leaves: Sequence[str],
               scale: float) -> np.ndarray:
    if not leaves:
        return np.zeros(1)
    p = np.array([prog[k] for k in leaves])
    r = np.array([ref[k] for k in leaves])
    return np.abs(p - r) / np.maximum(np.maximum(r, scale), 1e-30)


def _error(prog: Tensors, ref: Tensors) -> float:
    """|prog - ref| / |ref| over every entry of a network's leaves."""
    diff = total = 0.0
    for name, r in ref.items():
        p = prog[name].to(r.device, torch.float64)
        diff += float((p - r.double()).square().sum())
        total += float(r.double().square().sum())
    return math.sqrt(diff / max(total, 1e-300))


def _median_leaf_error(prog: Tensors, ref: Tensors) -> float:
    """The median over the leaves of each leaf's |prog - ref| / |ref|,
    leaves whose reference is under ``TINY_GRAD`` of the median leaf's
    norm left out."""
    norms = leaf_norms(ref)
    med = float(np.median(list(norms.values())))
    return float(np.median([_error({k: prog[k]}, {k: ref[k]})
                            for k in ref if norms[k] >= TINY_GRAD * med]))


def objectives(losses: np.ndarray, lambda_a: float) -> np.ndarray:
    """(STEPS, 5) losses [D's GAN loss, G's GAN term, L1, gradient penalty,
    perceptual] -> (STEPS, 2): D's objective and G's."""
    d = losses[:, 0] + losses[:, 3]
    g = losses[:, 1] + lambda_a * losses[:, 2] + losses[:, 4]
    return np.stack([d, g], axis=1)


def gaps(prog: Readings, ref: Readings, lambda_a: float) -> Dict[str, float]:
    """The compared and the reported numbers; nan where the program's are
    not finite."""
    p, r = objectives(prog.losses, lambda_a), objectives(ref.losses, lambda_a)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(p - r) / np.maximum(np.abs(r), 1e-30)
    out = {"loss_gap": float(np.max(rel))}
    grad = worst = change = 0.0
    for net, ref_g in ref.grad_norms.items():
        if sorted(prog.grad_norms[net]) != sorted(ref_g):
            raise ValueError(f"{net}: the program's leaves are not the "
                             "reference's")
        leaves = sorted(ref_g)
        med = float(np.median(list(ref_g.values())))
        g = _leaf_gaps(prog.grad_norms[net], ref_g, leaves, med)
        grad, worst = max(grad, float(np.median(g))), max(worst, g.max())
        moved = [k for k in leaves if ref_g[k] >= TINY_GRAD * med]
        ref_c = ref.change_norms[net]
        change = max(change, float(_leaf_gaps(
            prog.change_norms[net], ref_c, moved,
            float(np.median([ref_c[k] for k in moved])) if moved else 0.0
        ).max()))
    out.update(grad_gap=grad, change_gap=change,
               disc_grad_error=_median_leaf_error(prog.replay_grads["disc"],
                                                  ref.replay_grads["disc"]),
               gen_grad_error=_median_leaf_error(prog.replay_grads["gen"],
                                                 ref.replay_grads["gen"]),
               grad_gap_worst=float(worst))
    finite = (np.all(np.isfinite(prog.losses))
              and all(math.isfinite(x) for d in (prog.grad_norms,
                                                prog.change_norms)
                      for v in d.values() for x in v.values()))
    return {k: (v if finite else math.nan) for k, v in out.items()}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(values[k]) for k in values) and all(
        values[k] <= limits[k] for k in CHECKED)


def check_lines(values: Dict[str, float], limits: Dict[str, float]
                ) -> List[str]:
    return ([f"reading {k} {values[k]!r} (not compared)" for k in REPORTED]
            + [f"check {k} {values[k]!r} limit {limits[k]!r}"
               for k in CHECKED])


def checks(values: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, dict]:
    return {k: {"value": values[k], "limit": limits[k]} for k in CHECKED}


def first_grads(model, moments, beta1: float) -> Tensors:
    """leaf -> its first gradient, worked out from Adam's first moment
    after one step (``moments`` in ``model``'s parameter order)."""
    return {name: m.detach() / (1.0 - beta1)
            for (name, _), m in zip(model.named_parameters(), moments)}


def later_grads(before: Tensors, after: Tensors, beta1: float) -> Tensors:
    """leaf -> the gradient of the step between two readings of Adam's
    first moment (m2 = beta1 m1 + (1 - beta1) g)."""
    return {name: (after[name] - beta1 * before[name]) / (1.0 - beta1)
            for name in after}


def host_copy(named) -> Tensors:
    """name -> a float32 copy on the host of each (name, tensor)."""
    return {name: t.detach().to("cpu", torch.float32, copy=True)
            for name, t in named}
