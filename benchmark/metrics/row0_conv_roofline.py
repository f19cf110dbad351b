"""row0_conv_roofline (layer "kernels B, B-dx and D":
``ops/kernels/conv3x3.py``, ``conv3x3_wgrad.py`` ->
``csrc/conv3x3_fwd_sm90.cu``, ``conv3x3_wgrad_sm90.cu``,
``conv3x3_wgrad.cu``): the least time UNet++'s full-resolution row's 3x3
convs could take a step, forward, input gradient and weight gradient, over
the time kernels B, B-dx and D (with D's reduce) took, in %.

Row 0 holds nine such convs: the stem's second (nf -> nf) and both of each
nested node (0, c), c = 1..4 (c nf + 2 nf -> nf, then nf -> nf). Each of
the three passes of each conv is bounded by the larger of its operations
(2 B H W Cin Co 9, at 989e12 FLOP/s) and its bytes (float32 activations
read or written once, bf16 weights, a float32 weight gradient, at
3.35e12 B/s), as ``chip_smoke.py`` counts them. UNet++ only. Moves
``train_img_per_s``.
"""

from benchmark.core.trace import HBM_BYTES_PER_S, PEAK_FLOPS


def row0_convs(config):
    """(cin, co) of the nine convs."""
    nf = config["nf"]
    convs = [(nf, nf)]
    for col in range(1, 5):
        convs += [(nf * col + 2 * nf, nf), (nf, nf)]
    return convs


def bound_s(config, batch) -> float:
    pixels = batch * config["image_size"] ** 2
    total = 0.0
    for cin, co in row0_convs(config):
        flops = 2 * pixels * cin * co * 9
        act = (pixels * cin + pixels * co) * 4
        for weight_bytes in (2, 2, 4):  # forward, dx, dk
            total += max(flops / PEAK_FLOPS,
                         (act + 9 * cin * co * weight_bytes)
                         / HBM_BYTES_PER_S)
    return total


def read(reading):
    if reading.config["gen"] != "UNet++":
        return None
    t = reading.trace
    ms = None if t is None else t.ms_per_step(["kernel_b", "kernel_b_dx",
                                              "kernel_d"])
    if not ms:
        return None
    bound = bound_s(reading.config, reading.traffic["batch_size"])
    return bound * 1e3 / ms * 100.0
