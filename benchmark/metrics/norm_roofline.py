"""norm_roofline (layer "kernels A and C": ``ops/kernels/instance_norm.py``
-> ``csrc/instance_norm_act.cu``): the least time a step's instance norm +
ReLU forwards and backwards could take, over the time kernels A
(``in_act_fwd_kernel``) and C (``in_act_bwd_kernel``) took, in %.

Work, at the shapes of every instance norm in the generator's forward
(taken from the reference, ``reference/flops.py``), float32 activations:
a forward reads x and writes y, a backward reads x and the output gradient
and writes dx, each byte once (the pattern of ``chip_smoke.py``); the
bound is bytes / 3.35e12 B/s (the H100 SXM's HBM). Each norm runs one
forward and one backward a step. Moves ``train_img_per_s``.
"""

import math

from benchmark.core.trace import HBM_BYTES_PER_S
from benchmark.reference.flops import generator_norm_shapes

BYTES = 4  # float32 activations


def bound_s(config, batch) -> float:
    elems = sum(math.prod(s) for s in generator_norm_shapes(config, batch))
    return (2 + 3) * elems * BYTES / HBM_BYTES_PER_S


def read(reading):
    t = reading.trace
    ms = None if t is None else t.ms_per_step(["kernel_a", "kernel_c"])
    if not ms:
        return None
    bound = bound_s(reading.config, reading.traffic["batch_size"])
    return bound * 1e3 / ms * 100.0
