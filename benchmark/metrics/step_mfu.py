"""step_mfu (layer "train step": ``train/graph.py`` ``GraphedStep`` ->
``train/step.py``): the whole step's share of the card's peak, in %: the
floating-point operations of one step of the cell's configuration and mix,
counted by the benchmark over its reference step
(``reference/flops.py``), times the window's steps, over the window's
seconds and 989e12 (the H100 SXM's dense bf16 peak). The count is the
benchmark's, so no change to a kernel or to the program's counters moves
it. Moves ``train_img_per_s``.
"""

from benchmark.core.trace import PEAK_FLOPS
from benchmark.reference.flops import step_flops


def read(reading):
    w = reading.window
    if w.steps == 0:
        return None
    flops = step_flops(reading.config, reading.traffic)
    return flops * w.steps / w.seconds / PEAK_FLOPS * 100.0
