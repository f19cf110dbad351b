"""Kernel D: the weight gradient of the 3x3 / stride 1 / padding 1 conv,
NHWC activations, OIHW float32 result.

Replaces the Pallas kernel ``tactile_gan_tpu/ops/pallas/conv3x3.py``
``conv3x3_packed_wgrad`` (reached from ``ops/packed_row.py``) together with
its fold ``_dk_from_db``; the CUDA source is ``csrc/conv3x3_wgrad.cu``. It
is a GEMM with M = 9*Cin, N = Co and K = N*H*W pixels; the pixels are split
over blocks and the partials summed by a second launch in a fixed order, so
the result is the same on every run.

Numerics, kernel and plain version alike: x and g rounded to
``compute_dtype`` (bfloat16 or float32), products and sums in float32. On a
CPU tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tactile_gan_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMPUTE = (torch.bfloat16, torch.float32)
_TILE = (8, 32)          # output pixels per tile (csrc kMH, kMW)
_CI = 32                 # input channels per block (csrc kCI)
_MAX_CO = 64
_TARGET_BLOCKS = 2 * 132  # two blocks per SM

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("conv3x3_wgrad")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_wgrad.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.conv3x3_wgrad.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor, *,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """The plain version, by formula: x (N,H,W,Cin), g (N,H,W,Co) ->
    dk (Co, Cin, 3, 3) float32 with
    dk[co, ci, ky, kx] = sum_p x[p + (ky-1, kx-1), ci] * g[p, co]."""
    n, h, w, cin = x.shape
    xc = F.pad(x.to(compute_dtype).float(), (0, 0, 1, 1, 1, 1))
    gc = g.to(compute_dtype).float().reshape(n * h * w, -1)
    taps = [xc[:, ky:ky + h, kx:kx + w].reshape(n * h * w, cin).T @ gc
            for ky in range(3) for kx in range(3)]      # each (Cin, Co)
    return torch.stack(taps, dim=-1).permute(1, 0, 2).reshape(
        g.shape[-1], cin, 3, 3).contiguous()


def launch_plan(n: int, h: int, w: int, cin: int) -> Tuple[int, int]:
    """(tiles_per_chunk, chunks): the split of the N*ceil(H/8)*ceil(W/32)
    pixel tiles so that ceil(Cin/32) * chunks blocks fill the card in one
    wave (two blocks an SM): a 270th block would run alone in a second."""
    tiles = n * -(-h // _TILE[0]) * -(-w // _TILE[1])
    want = max(1, _TARGET_BLOCKS // -(-cin // _CI))
    per = -(-tiles // min(want, tiles))
    return per, -(-tiles // per)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, *,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """dk (Co, Cin, 3, 3) float32 of the 3x3/s1/p1 conv y = conv(x, k) with
    upstream gradient g = dL/dy."""
    if compute_dtype not in _COMPUTE:
        raise ValueError(f"conv3x3_wgrad: unsupported compute dtype "
                         f"{compute_dtype}")
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_wgrad: unsupported device {x.device}")
    if (x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]
            or x.dtype not in _DTYPES or g.dtype != x.dtype
            or g.device != x.device):
        raise ValueError("conv3x3_wgrad kernel takes NHWC x and g of one "
                         f"dtype (float32 or bfloat16) and pixel grid, got "
                         f"{x.dtype} {tuple(x.shape)} and {g.dtype} "
                         f"{tuple(g.shape)}")
    n, h, w, cin = x.shape
    co = g.shape[-1]
    if cin % 8 or co % 8 or co > _MAX_CO:
        raise ValueError(f"conv3x3_wgrad kernel needs Cin % 8 == 0 and Co a "
                         f"multiple of 8 up to {_MAX_CO}; got Cin {cin}, "
                         f"Co {co}")
    for t in (x, g):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv3x3_wgrad kernel needs contiguous, 16-byte "
                             f"aligned tensors; got strides {t.stride()}")
    per, chunks = launch_plan(n, h, w, cin)
    part = torch.empty(chunks * 9 * cin * co, dtype=torch.float32,
                       device=x.device)
    dk = torch.empty((co, cin, 3, 3), dtype=torch.float32, device=x.device)
    lib = _load()
    err = lib.conv3x3_wgrad(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), dk.data_ptr(), n, h, w,
        cin, co, per, chunks, _DTYPES[x.dtype],
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv3x3_wgrad kernel launch failed: "
                           + lib.cuda_error_string(err).decode())
    conv3x3_wgrad.launches += 1
    return dk


conv3x3_wgrad.launches = 0
