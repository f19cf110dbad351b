"""library_conv_ms (layer "library convs": ``ops/conv.py``'s convs and
transposed convs of G, the PatchGAN's and the VGG tower's): device
milliseconds a step of the library's convolution and GEMM kernels (cuDNN,
cuBLAS, CUTLASS by name), the port's own kernels matched first
(``core/trace.py``). Moves ``train_img_per_s``.
"""


def read(reading):
    t = reading.trace
    return None if t is None else t.ms_per_step(["library_conv"])
