"""device_idle_share (layer "device"): the share of the traced window, in
%, in which no operation ran on the card: 1 - the union of the device
operations' intervals over the window's length (the arithmetic of the
port's ``utils/profiling.py`` ``busy_us``). Moves ``train_img_per_s``.
"""


def read(reading):
    t = reading.trace
    if t is None or not t.device_ops:
        return None
    return (1.0 - t.busy_s() / t.window_s) * 100.0
