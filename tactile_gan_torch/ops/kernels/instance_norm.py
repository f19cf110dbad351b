"""Kernels A and C: fused instance norm + affine + activation, forward and
backward, behind one ``torch.autograd.Function``.

Kernel A (forward) replaces the Pallas kernel
``tactile_gan_tpu/ops/pallas/instance_norm.py`` ``instance_norm_act``
(``_norm_call`` -> ``_kernel``); kernel C (backward) replaces its ``_bwd``
(``_bwd_call`` -> ``_bwd_kernel``). Both live in
``csrc/instance_norm_act.cu``. Bound on the card: memory. A reads x once and
writes y once; C reads x and g once and writes dx once. Both split the H*W
reduction across blocks so the full-resolution row (64 channels of 65,536
pixels per image) still fills the 132 SMs, merge the partials in a finalize
launch, then run an elementwise pass.

Both take any C. The kernels read channels in groups of 8: where C is not a
multiple of 8 (UNet++ at nf 12) the wrapper zero-pads x (and g) to one, with
scale 1 and offset 0 on the added channels, and drops them from what it
returns, at the cost of a copy of each padded tensor.

Statistics: float32, biased variance, eps 1e-5. The kernel's Welford/Chan
merge gives the two-pass variance to rounding; the plain version is the
two-pass ``ops/norm.py``. The TPU kernel's single-pass E[x^2] - m^2 is not
copied: it cancels when |mean| >> std. The forward keeps its (mean, rstd)
for the backward instead of sweeping x again; the Pallas backward recomputes
single-pass statistics.

On a CPU tensor the Function runs the plain PyTorch versions (forward and a
backward written out by formula); on a CUDA tensor it launches the kernels or
raises. It is first-order only: a backward run while building a graph for a
second derivative raises, as the Pallas op does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
        lib.in_act_backward.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                        i, i, i, i, f, i, p]
        lib.in_act_backward.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_act(act: Optional[str]) -> None:
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")


def _activate(z: torch.Tensor, act: Optional[str], slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.relu(z)
    if act == "leaky_relu":
        return torch.where(z >= 0, z, z * slope)
    return z


def instance_norm_act_plain(x: torch.Tensor,
                            weight: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None, *,
                            act: Optional[str] = None,
                            negative_slope: float = 0.2) -> torch.Tensor:
    """The plain PyTorch forward: float32 throughout, one cast at the end."""
    _check_act(act)
    y = instance_norm(x.float(), weight, bias, eps=EPS)
    return _activate(y, act, negative_slope).to(x.dtype)


def instance_norm_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, C, 2) float32 [mean, rstd] of x (N,H,W,C): the two-pass biased
    statistics, the layout kernel A leaves for the backward."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    var = (x32 - mean[:, None, None]).square().mean(dim=(1, 2))
    return torch.stack([mean, torch.rsqrt(var + EPS)], dim=-1)


def instance_norm_act_backward_plain(
        x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
        weight: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None, *, act: Optional[str] = None,
        negative_slope: float = 0.2
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain closed-form backward, by formula (float32):

      xhat = (x - mean) * rstd;  z = xhat*s + o;  dz = g * act'(z)
      dscale = sum(dz * xhat);   doffset = sum(dz)   (over H, W and N)
      dx = rstd * (dz*s - mean_hw(dz*s) - xhat * mean_hw(dz*s * xhat))

    act' is read from the sign of z, as the Pallas kernel does (relu: z > 0;
    leaky: z >= 0 ? 1 : slope). Returns (dx in g's dtype, dscale, doffset),
    the last two float32 of shape (C,)."""
    _check_act(act)
    c = x.shape[-1]
    s = torch.ones(c) if weight is None else weight.detach().float()
    o = torch.zeros(c) if bias is None else bias.detach().float()
    s, o = s.to(x.device), o.to(x.device)
    mean = stats[..., 0][:, None, None, :]
    rstd = stats[..., 1][:, None, None, :]
    xhat = (x.float() - mean) * rstd
    z = xhat * s + o
    gf = g.float()
    if act == "relu":
        dz = torch.where(z > 0, gf, torch.zeros_like(gf))
    elif act == "leaky_relu":
        dz = torch.where(z >= 0, gf, gf * negative_slope)
    else:
        dz = gf
    doffset = dz.sum(dim=(0, 1, 2))
    dscale = (dz * xhat).sum(dim=(0, 1, 2))
    dxhat = dz * s
    m1 = dxhat.mean(dim=(1, 2), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(1, 2), keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return dx.to(g.dtype), dscale, doffset


def launch_plan(n: int, hw: int, c: int):
    """(splits, chunk, apply_blocks): the H*W split of the reduction grid
    and the elementwise grid, from the shape alone (kernels A and C)."""
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
    return v.detach().float().contiguous()


def _check_kernel_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{what} kernel takes a 4-d NHWC float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs a contiguous, 16-byte aligned "
                         f"NHWC tensor; got shape {tuple(x.shape)}, strides "
                         f"{x.stride()}")


def _pad_channels(t: Optional[torch.Tensor], pad: int,
                  fill: float = 0.0) -> Optional[torch.Tensor]:
    """t with ``pad`` channels of ``fill`` added on its last axis."""
    if t is None:
        return None
    return torch.nn.functional.pad(t, (0, pad), value=fill)


def _raise_on_error(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.cuda_error_string(err).decode())


def forward_kernel(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], act: Optional[str],
                   negative_slope: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A on a CUDA tensor: (y, stats (N, C, 2) [mean, rstd])."""
    _check_act(act)
    _check_kernel_input(x, "instance_norm_act")
    n, h, w, c = x.shape
    if c % 8:
        pad = (-c) % 8
        y, stats = forward_kernel(
            _pad_channels(x, pad), _pad_channels(weight, pad, 1.0),
            _pad_channels(bias, pad), act, negative_slope)
        return y[..., :c].contiguous(), stats[:, :c].contiguous()
    wt = _affine(weight, c, 1.0, x)
    bs = _affine(bias, c, 0.0, x)
    hw = h * w
    splits, chunk, apply_blocks = launch_plan(n, hw, c)
    y = torch.empty_like(x)
    part = n * splits * c
    scratch = torch.empty(2 * part, dtype=torch.float32, device=x.device)
    stats = torch.empty((n, c, 2), dtype=torch.float32, device=x.device)
    base = scratch.data_ptr()
    lib = _load()
    err = lib.in_act_forward(
        x.data_ptr(), y.data_ptr(), wt.data_ptr(), bs.data_ptr(),
        base, base + 4 * part, stats.data_ptr(), n, hw, c, splits,
        chunk, _DTYPES[x.dtype], _ACTS[act], negative_slope, EPS,
        apply_blocks, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(lib, err, "instance_norm_act")
    instance_norm_act.launches += 1
    return y, stats


def backward_kernel(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                    weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], act: Optional[str],
                    negative_slope: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel C on CUDA tensors: (dx in g's dtype, dscale, doffset)."""
    _check_act(act)
    _check_kernel_input(x, "instance_norm_act backward")
    _check_kernel_input(g, "instance_norm_act backward")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"gradient {g.dtype} {tuple(g.shape)} does not match "
                         f"the input {x.dtype} {tuple(x.shape)}")
    n, h, w, c = x.shape
    if (stats.shape != (n, c, 2) or stats.dtype != torch.float32
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError(f"stats must be contiguous float32 (N, C, 2) on "
                         f"{x.device}, got {stats.dtype} {tuple(stats.shape)}")
    if c % 8:
        # The added channels: x and g zero, stats zero, so their dx is zero.
        pad = (-c) % 8
        dx, dscale, doffset = backward_kernel(
            _pad_channels(x, pad), _pad_channels(g, pad),
            torch.nn.functional.pad(stats, (0, 0, 0, pad)),
            _pad_channels(weight, pad, 1.0), _pad_channels(bias, pad), act,
            negative_slope)
        return dx[..., :c].contiguous(), dscale[:c], doffset[:c]
    wt = _affine(weight, c, 1.0, x)
    bs = _affine(bias, c, 0.0, x)
    hw = h * w
    splits, chunk, apply_blocks = launch_plan(n, hw, c)
    dx = torch.empty_like(g)
    part = n * splits * c
    # float32 scratch: partial sums of dz and dz*xhat, the per-(n, c)
    # (m1, m2) of the dx pass; dso holds per-(n, c) dscale and doffset.
    scratch = torch.empty(2 * part + 2 * n * c, dtype=torch.float32,
                          device=x.device)
    dso = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    base = scratch.data_ptr()
    lib = _load()
    err = lib.in_act_backward(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), stats.data_ptr(),
        wt.data_ptr(), bs.data_ptr(), base, base + 4 * part,
        base + 8 * part, dso.data_ptr(), n, hw, c, splits, chunk,
        _DTYPES[x.dtype], _ACTS[act], negative_slope, apply_blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(lib, err, "instance_norm_act backward")
    backward_kernel.launches += 1  # kernel C launches
    # Per-(n, c) partials summed over the batch, as the JAX package sums its
    # per-lane partials outside the kernel.
    dscale, doffset = dso.sum(dim=1)
    return dx, dscale, doffset


backward_kernel.launches = 0


class InstanceNormAct(torch.autograd.Function):
    """y = act(instance_norm(x) * weight + bias); kernels A and C on the
    card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, weight, bias, act, negative_slope):
        if x.device.type == "cpu":
            y = instance_norm_act_plain(x, weight, bias, act=act,
                                        negative_slope=negative_slope)
            stats = instance_norm_stats_plain(x)
        elif x.device.type == "cuda":
            y, stats = forward_kernel(x, weight, bias, act, negative_slope)
        else:
            raise ValueError(f"instance_norm_act: unsupported device {x.device}")
        ctx.act, ctx.slope = act, negative_slope
        ctx.affine = (weight is not None, bias is not None)
        ctx.save_for_backward(x, weight, bias, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "instance_norm_act: double backward is not supported (kernel "
                "C is first-order only); keep this op out of graphs that are "
                "differentiated twice")
        x, weight, bias, stats = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cpu":
            dx, dscale, doffset = instance_norm_act_backward_plain(
                x, g, stats, weight, bias, act=ctx.act,
                negative_slope=ctx.slope)
        else:
            dx, dscale, doffset = backward_kernel(
                x, g, stats, weight, bias, ctx.act, ctx.slope)
        dw = dscale.to(weight.dtype) if ctx.affine[0] else None
        db = doffset.to(bias.dtype) if ctx.affine[1] else None
        return dx, dw, db, None, None


def instance_norm_act(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None, *,
                      act: Optional[str] = None,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """y = act(instance_norm(x) * weight + bias) for x of shape (N,H,W,C),
    differentiable (first order).

    float32 or bfloat16 in, the same dtype out, float32 statistics."""
    _check_act(act)
    return InstanceNormAct.apply(x, weight, bias, act, negative_slope)


instance_norm_act.launches = 0  # kernel A launches
