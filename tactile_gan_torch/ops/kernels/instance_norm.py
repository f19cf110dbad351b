"""Kernel A: fused instance norm + affine + activation, forward.

Replaces the Pallas kernel ``tactile_gan_tpu/ops/pallas/instance_norm.py``
``instance_norm_act`` (``_norm_call`` -> ``_kernel``). The CUDA source is
``csrc/instance_norm_act.cu``. Bound on the card: memory (read x once,
write y once); the design splits the H*W reduction across blocks so the
full-resolution row at batch 1 (64 groups of 65,536 pixels) still fills the
132 SMs, merges Welford partials in a finalize launch, then normalizes.

Statistics: float32, biased variance, eps 1e-5. The kernel's Welford/Chan
merge gives the two-pass variance to rounding; the plain version is the
two-pass ``ops/norm.py``. The TPU kernel's single-pass E[x^2] - m^2 is not
copied: it cancels when |mean| >> std.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. Serving needs no gradient; the training
slice adds an autograd.Function around this with the backward kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tactile_gan_torch.ops.kernels import build
from tactile_gan_torch.ops.norm import instance_norm

EPS = 1e-5
_ACTS = {None: 0, "relu": 1, "leaky_relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_C = 64               # channels per statistics block (csrc kTileC)
_THREADS = 256
_TARGET_STATS_BLOCKS = 4 * 132   # about four blocks per SM
_MIN_CHUNK = 128                 # pixels per statistics block, at least
_MAX_APPLY_BLOCKS = 8 * 132

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("instance_norm_act")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.in_act_forward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                       i, f, f, i, p]
        lib.in_act_forward.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def instance_norm_act_plain(x: torch.Tensor,
                            weight: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None, *,
                            act: Optional[str] = None,
                            negative_slope: float = 0.2) -> torch.Tensor:
    """The plain PyTorch version: float32 throughout, one cast at the end."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    y = instance_norm(x.float(), weight, bias, eps=EPS)
    if act == "relu":
        y = torch.relu(y)
    elif act == "leaky_relu":
        y = torch.where(y >= 0, y, y * negative_slope)
    return y.to(x.dtype)


def launch_plan(n: int, hw: int, c: int):
    """(splits, chunk, apply_blocks): the H*W split of the statistics grid
    and the normalize grid, from the shape alone."""
    tiles = n * -(-c // _TILE_C)
    splits = max(1, min(-(-_TARGET_STATS_BLOCKS // tiles), -(-hw // _MIN_CHUNK)))
    chunk = -(-hw // splits)
    splits = -(-hw // chunk)
    apply_blocks = max(1, min(-(-(n * hw * c // 8) // _THREADS),
                              _MAX_APPLY_BLOCKS))
    return splits, chunk, apply_blocks


def _affine(v: Optional[torch.Tensor], c: int, fill: float,
            like: torch.Tensor) -> torch.Tensor:
    if v is None:
        return torch.full((c,), fill, dtype=torch.float32, device=like.device)
    if v.shape != (c,) or v.device != like.device:
        raise ValueError(f"affine parameter of shape {tuple(v.shape)} on "
                         f"{v.device} does not match C={c} on {like.device}")
    return v.float().contiguous()


def instance_norm_act(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None, *,
                      act: Optional[str] = None,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """y = act(instance_norm(x) * weight + bias) for x of shape (N,H,W,C).

    float32 or bfloat16 in, the same dtype out, float32 statistics."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, weight, bias, act=act,
                                       negative_slope=negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError("instance_norm_act kernel takes a 4-d NHWC float32 "
                         f"or bfloat16 tensor, got {x.dtype} {tuple(x.shape)}")
    n, h, w, c = x.shape
    if c % 8 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("instance_norm_act kernel needs C % 8 == 0 and a "
                         "contiguous, 16-byte aligned NHWC tensor; got "
                         f"shape {tuple(x.shape)}, strides {x.stride()}")
    wt = _affine(weight, c, 1.0, x)
    bs = _affine(bias, c, 0.0, x)
    hw = h * w
    splits, chunk, apply_blocks = launch_plan(n, hw, c)
    y = torch.empty_like(x)
    # One float32 scratch buffer: partial means, partial M2s, (mean, rstd).
    part = n * splits * c
    scratch = torch.empty(2 * part + 2 * n * c, dtype=torch.float32,
                          device=x.device)
    base = scratch.data_ptr()
    lib = _load()
    err = lib.in_act_forward(
        x.data_ptr(), y.data_ptr(), wt.data_ptr(), bs.data_ptr(),
        base, base + 4 * part, base + 8 * part, n, hw, c, splits,
        chunk, _DTYPES[x.dtype], _ACTS[act], negative_slope, EPS,
        apply_blocks, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("instance_norm_act kernel launch failed: "
                           + lib.cuda_error_string(err).decode())
    instance_norm_act.launches += 1
    return y


instance_norm_act.launches = 0
