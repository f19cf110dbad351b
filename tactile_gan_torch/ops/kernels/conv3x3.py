"""Kernel B: 3x3 / stride 1 / padding 1 convolution for the full-resolution
row, NHWC in and out, forward and input gradient (dx), behind a
``torch.autograd.Function`` whose weight gradient is kernel D
(``ops/kernels/conv3x3_wgrad.py``).

Replaces the Pallas kernel ``tactile_gan_tpu/ops/pallas/conv3x3.py``
``conv3x3_packed`` (reached through ``ops/packed_row.py``), in both of its
uses: the forward and dx, which is the same conv of the gradient with the
rotated-transposed weight (``_rot_t``). Its packed operand is NHWC memory,
so on the card it is a plain channels-last conv; the CUDA source is
``csrc/conv3x3.cu``. Bound on the card: operations
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
64. The dx conv has Co = the forward's Cin, walked in output-channel tiles
by one launch. On a CPU tensor the Function runs the plain versions; on a
CUDA tensor it launches the kernels or raises. It is first-order only: a
backward run while building a graph for a second derivative raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from tactile_gan_torch.ops.kernels import build
from tactile_gan_torch.ops.kernels.conv3x3_wgrad import conv3x3_wgrad

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
        lib.conv3x3_dgrad.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.conv3x3_dgrad.restype = i
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


def rot_t(weight: torch.Tensor) -> torch.Tensor:
    """The dx weight: rot180 + in/out swap, (Co,Cin,3,3) -> (Cin,Co,3,3)
    (the transpose of a zero-padded 3x3/s1 conv is this conv)."""
    return weight.flip(2, 3).transpose(0, 1)


def conv3x3_dgrad_plain(g: torch.Tensor, weight: torch.Tensor, *,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """The plain dx: the plain conv of g (N,H,W,Co) with ``rot_t(weight)``,
    (N,H,W,Cin) in g's dtype."""
    return conv3x3_plain(g, rot_t(weight), compute_dtype=compute_dtype)


def co_tile(co: int) -> int:
    """The output-channel tile the kernel walks: 64, or 16/32 for narrow
    outputs."""
    return 16 if co <= 16 else 32 if co <= 32 else 64


def relayout_weight(weight: torch.Tensor, compute_dtype: torch.dtype,
                    tile: int = 0) -> torch.Tensor:
    """OIHW -> the layout the kernel reads: [9][Co_pad][Cin_pad] bfloat16
    (Cin zero-padded to a multiple of 16) for bf16 compute, [9][Cin][Co_pad]
    float32 for float32 compute; Co is zero-padded to a multiple of
    ``tile`` (0: no padding)."""
    co, cin = weight.shape[:2]
    co_pad = (-co) % tile if tile else 0
    if compute_dtype == torch.bfloat16:
        w = weight.permute(2, 3, 0, 1).reshape(9, co, cin)
        w = F.pad(w, (0, (-cin) % _KC, 0, co_pad))
    else:
        w = F.pad(weight.permute(2, 3, 1, 0).reshape(9, cin, co), (0, co_pad))
    return w.to(compute_dtype).contiguous()


# The re-laid weights, kept while their source tensor lives, is not
# written in place (its version counter moves on every in-place update) and
# keeps its storage (``.data`` reassigned, as ``Module.to`` does): one entry
# per (compute dtype, use) of each weight, the forward's and the dx's.
_relaid = WeakIdKeyDictionary()


def _kernel_weight(weight: torch.Tensor, compute_dtype: torch.dtype,
                   dgrad: bool = False) -> torch.Tensor:
    key = (weight._version, weight.data_ptr())
    entries = _relaid.setdefault(weight, {})
    hit = entries.get((compute_dtype, dgrad))
    if hit is not None and hit[0] == key:
        return hit[1]
    w = weight.detach()
    if dgrad:
        wk = relayout_weight(rot_t(w), compute_dtype, co_tile(w.shape[1]))
    else:
        wk = relayout_weight(w, compute_dtype)
    entries[(compute_dtype, dgrad)] = (key, wk)
    return wk


def forward_kernel(x: torch.Tensor, weight: torch.Tensor,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """Kernel B's forward on a CUDA tensor."""
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


def dgrad_kernel(g: torch.Tensor, weight: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Kernel B's dx use on a CUDA tensor: g (N,H,W,Co) -> (N,H,W,Cin)."""
    if g.device.type != "cuda":
        raise ValueError(f"conv3x3 dgrad: unsupported device {g.device}")
    co, cin = weight.shape[:2]
    if (g.dim() != 4 or g.dtype not in _DTYPES or g.shape[-1] != co
            or co not in _CO or weight.shape[2:] != (3, 3)
            or weight.device != g.device):
        raise ValueError(f"conv3x3 dgrad kernel needs an NHWC float32 or "
                         f"bfloat16 gradient of {co} channels (Co in {_CO}) "
                         f"on the weight's device; got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    if cin % 8 or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("conv3x3 dgrad kernel needs Cin % 8 == 0 and a "
                         "contiguous, 16-byte aligned gradient; got Cin "
                         f"{cin}, strides {g.stride()}")
    n, h, w, _ = g.shape
    bf16 = compute_dtype == torch.bfloat16
    wk = _kernel_weight(weight, compute_dtype, dgrad=True)
    dx = torch.empty((n, h, w, cin), dtype=g.dtype, device=g.device)
    lib = _load()
    err = lib.conv3x3_dgrad(
        g.data_ptr(), wk.data_ptr(), dx.data_ptr(), n, h, w, co,
        wk.shape[-1] if bf16 else co, cin, co_tile(cin), _DTYPES[g.dtype],
        int(bf16), torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError("conv3x3 dgrad kernel launch failed: "
                           + lib.cuda_error_string(err).decode())
    dgrad_kernel.launches += 1
    return dx


dgrad_kernel.launches = 0  # kernel B launches for dx


class Conv3x3(torch.autograd.Function):
    """3x3/s1/p1 conv, no bias; kernels B (forward, dx) and D (weight
    gradient) on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, weight, compute_dtype):
        if x.device.type == "cpu":
            y = conv3x3_plain(x, weight, compute_dtype=compute_dtype)
        else:
            y = forward_kernel(x, weight, compute_dtype)
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "conv3x3: double backward is not supported (kernels B-dx and "
                "D are first-order only); keep this op out of graphs that are "
                "differentiated twice")
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        cd = ctx.compute_dtype
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if g.device.type == "cpu":
                dx = conv3x3_dgrad_plain(g, weight, compute_dtype=cd)
            else:
                dx = dgrad_kernel(g, weight, cd)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, g.to(x.dtype), compute_dtype=cd)
            dw = dw.to(weight.dtype)
        return dx, dw, None


def conv3x3(x: torch.Tensor, weight: torch.Tensor, *,
            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """3x3/s1/p1 conv, no bias: (N,H,W,Cin) -> (N,H,W,Co) in x's dtype,
    differentiable (first order)."""
    if compute_dtype not in _COMPUTE:
        raise ValueError(f"conv3x3: unsupported compute dtype {compute_dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    return Conv3x3.apply(x, weight, compute_dtype)


conv3x3.launches = 0  # kernel B launches for the forward
