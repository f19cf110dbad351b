"""other_ms (layer "other device work": casts, elementwise ops, pooling,
concatenation, the losses, the gradient penalty's glue, Adam;
``models/*``, ``losses/*``, ``train/step.py``, ``train/state.py``): device
milliseconds a step of every operation that is neither one of the port's
own kernels nor a library conv (``core/trace.py``). Moves
``train_img_per_s``.
"""


def read(reading):
    t = reading.trace
    return None if t is None else t.ms_per_step(["other"])
