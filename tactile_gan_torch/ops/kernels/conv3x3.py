"""Kernel B: 3x3 / stride 1 / padding 1 convolution for the full-resolution
row, NHWC in and out.

Replaces the Pallas kernel ``tactile_gan_tpu/ops/pallas/conv3x3.py``
``conv3x3_packed`` (reached through ``ops/packed_row.py``). Its packed
operand is NHWC memory, so on the card it is a plain channels-last conv;
the CUDA source is ``csrc/conv3x3.cu``. Bound on the card: operations
(2*9*Cin*Co flops a pixel against (Cin+Co) elements moved) at the tensor
cores' bf16 rate, or the bytes where a float32 input has few channels. The
design is an implicit GEMM: a block streams 16-channel slices of a haloed
8x32-pixel input tile and of the weights through a two-stage shared-memory
ring and runs mma.sync bf16 products with float32 accumulators; float32
compute runs on the CUDA cores. The wrapper re-lays each weight once (and
again only after an in-place update of it) into the layout the kernel reads.

Numerics, kernel and plain version alike: operands rounded to
``compute_dtype`` (bfloat16 or float32), products and sums in float32, the
output in the input's dtype. Cin is any multiple of 8 (the port convolves
the concatenated node input, up to 384 channels at nf=64); Co is 16, 32 or
64. On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from tactile_gan_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMPUTE = (torch.bfloat16, torch.float32)
_CO = (16, 32, 64)
_KC = 16  # Cin slice of the bf16 kernel (csrc kKC)

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("conv3x3")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_forward.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        lib.conv3x3_forward.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, *,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """The plain PyTorch version. x (N,H,W,Cin), weight (Co,Cin,3,3)."""
    xc = x.to(compute_dtype).float().permute(0, 3, 1, 2)
    wc = weight.to(compute_dtype).float()
    y = F.conv2d(xc, wc, padding=1).permute(0, 2, 3, 1).contiguous()
    return y.to(x.dtype)


def relayout_weight(weight: torch.Tensor,
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """OIHW -> the layout the kernel reads: [9][Co][Cin_pad] bfloat16 (Cin
    zero-padded to a multiple of 16) for bf16 compute, [9][Cin][Co] float32
    for float32 compute."""
    co, cin = weight.shape[:2]
    if compute_dtype == torch.bfloat16:
        w = weight.permute(2, 3, 0, 1).reshape(9, co, cin)
        if cin % _KC:
            w = F.pad(w, (0, _KC - cin % _KC))
    else:
        w = weight.permute(2, 3, 1, 0).reshape(9, cin, co)
    return w.to(compute_dtype).contiguous()


# The re-laid weights, kept while their source tensor lives, is not
# written in place (its version counter moves on every in-place update) and
# keeps its storage (``.data`` reassigned, as ``Module.to`` does).
_relaid = WeakIdKeyDictionary()


def _kernel_weight(weight: torch.Tensor,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    key = (weight._version, weight.data_ptr(), compute_dtype)
    hit = _relaid.get(weight)
    if hit is not None and hit[0] == key:
        return hit[1]
    wk = relayout_weight(weight.detach(), compute_dtype)
    _relaid[weight] = (key, wk)
    return wk


def conv3x3(x: torch.Tensor, weight: torch.Tensor, *,
            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """3x3/s1/p1 conv, no bias: (N,H,W,Cin) -> (N,H,W,Co) in x's dtype."""
    if compute_dtype not in _COMPUTE:
        raise ValueError(f"conv3x3: unsupported compute dtype {compute_dtype}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError("conv3x3 kernel takes a 4-d NHWC float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if (weight.dim() != 4 or weight.shape[1:] != (cin, 3, 3)
            or weight.shape[0] not in _CO or weight.device != x.device):
        raise ValueError(f"conv3x3 kernel needs a (Co, {cin}, 3, 3) weight "
                         f"with Co in {_CO} on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    if cin % 8 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3 kernel needs Cin % 8 == 0 and a contiguous, "
                         f"16-byte aligned NHWC tensor; got shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    co = weight.shape[0]
    bf16 = compute_dtype == torch.bfloat16
    wk = _kernel_weight(weight, compute_dtype)
    y = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    lib = _load()
    err = lib.conv3x3_forward(
        x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, w, cin,
        wk.shape[-1] if bf16 else cin, co, _DTYPES[x.dtype], int(bf16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv3x3 kernel launch failed: "
                           + lib.cuda_error_string(err).decode())
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
