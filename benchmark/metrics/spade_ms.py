"""spade_ms (layer "SPADE layers": ``models/spade.py`` ``SPADE``, the
non-affine instance norm on kernel A, the three convs of the segmentation
map's branch and the modulation x_hat * (1 + gamma) + beta, and their
backward, kernel C included): device milliseconds a step inside the
generator's SPADE layers.

The port brackets each layer with marker kernels
(``tactile_gan_torch/csrc/phase_marks.cu``, launched by
``utils/profiling.py`` ``layer_mark`` and captured into the step's graph):
its entry and exit in the forward, and in the backward the exit's twin
where the layer's backward starts and the entry's where it ends. The
names are copied here, as ``core/phases.py`` copies the phases', so that
no change to the program moves how the benchmark counts.

A layer's window runs from an opening mark (``tg_mark_spade_in``,
``tg_mark_spade_bwd_out``) to the next closing mark (``tg_mark_spade_out``,
``tg_mark_spade_bwd_in``), the marks taken in order of start; an opening
mark inside an open window and a closing mark outside one open or close
nothing. The metric is the device's busy time inside the windows: the
union of the intervals of every device operation but the marks and the
copies between host and device (the prefetcher's, on a stream of its
own), clipped to the windows. Operations that run side by side count once,
so the metric cannot pass the windows' length. The sum is divided by the
window's steps. A window with no mark (a program without them, or another
generator) reads None. Moves ``train_img_per_s``.
"""

from typing import List, Optional, Tuple

from benchmark.core.phases import HOST_DEVICE_COPIES

OPENS = ("tg_mark_spade_in", "tg_mark_spade_bwd_out")
CLOSES = ("tg_mark_spade_out", "tg_mark_spade_bwd_in")


def windows(ops) -> List[Tuple[float, float]]:
    """The layers' (start, end) windows, in order, from the marks of
    ``ops`` (name, start, end)."""
    out, opened = [], None
    for name, s, e in sorted((op for op in ops if op[0] in OPENS + CLOSES),
                             key=lambda op: op[1]):
        if name in OPENS:
            if opened is None:
                opened = e
        elif opened is not None:
            out.append((opened, s))
            opened = None
    return out


def busy_inside(intervals, spans) -> float:
    """Length of the union of ``intervals`` inside the sorted, disjoint
    ``spans``."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total, i = 0.0, 0
    for a, b in spans:
        while i < len(merged) and merged[i][1] <= a:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < b:
            total += min(b, merged[j][1]) - max(a, merged[j][0])
            j += 1
    return total


def read(reading) -> Optional[float]:
    t = reading.trace
    if t is None or t.steps == 0:
        return None
    spans = windows(t.device_ops)
    if not spans:
        return None
    work = [(s, e) for name, s, e in t.device_ops
            if name not in OPENS + CLOSES
            and not name.startswith(HOST_DEVICE_COPIES)]
    return busy_inside(work, spans) / t.steps * 1e3
