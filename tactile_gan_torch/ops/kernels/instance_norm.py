"""Kernels A and C: fused instance norm + affine + activation, forward and
backward, behind one ``torch.autograd.Function``.

Kernel A (forward) replaces the Pallas kernel
``tactile_gan_tpu/ops/pallas/instance_norm.py`` ``instance_norm_act``
(``_norm_call`` -> ``_kernel``); kernel C (backward) replaces its ``_bwd``
(``_bwd_call`` -> ``_bwd_kernel``). Both live in
``csrc/instance_norm_act.cu``. Bound on the card: memory. A reads x once and
writes y once; C reads x and g once and writes dx once. Each is one
persistent, cooperative launch that walks the call's images in slabs of
whole images, keeps each block's share of a slab in shared memory between
the statistics and the output (so x, and g, are read once), and merges the
blocks' partials across two grid barriers. ``launch_plan`` sizes the slabs.

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
from typing import NamedTuple, Optional, Tuple

import torch

from tactile_gan_torch.ops.kernels import build
from tactile_gan_torch.ops.norm import instance_norm

EPS = 1e-5
_ACTS = {None: 0, "relu": 1, "leaky_relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 512           # one block an SM (csrc kThreads)
SMEM_MAX = 232448       # 227 KB: a block's dynamic shared memory at most
H100_SMS = 132

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("instance_norm_act")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.in_act_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                       i, i, i, i, f, f, p]
        lib.in_act_forward.restype = i
        lib.in_act_backward.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                        i, i, i, i, i, i, f, p]
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


class SlabPlan(NamedTuple):
    """How one call of kernel A or C walks its images (csrc ``Plan``)."""
    ips: int        # images a slab (every slab whole images)
    bpi: int        # blocks an image
    share: int      # pixels a block (the last block of an image may get fewer)
    resident: int   # of those, pixels kept in shared memory
    streamed: int   # the rest, read again from device memory to write
    lanes: int      # pixel lanes of a block (threads per channel group)
    grid: int       # blocks: ips * bpi, at most one an SM
    smem: int       # dynamic shared-memory bytes a block


def launch_plan(n: int, hw: int, c: int, dtype: torch.dtype, inputs: int,
                sms: int = H100_SMS) -> SlabPlan:
    """The slab plan of kernel A (``inputs`` 1: x) or C (2: x and g) on
    ``n`` images of ``hw`` pixels and ``c`` channels (c % 8 == 0), from the
    shape alone.

    A block's threads take 16 bytes of a pixel each (4 float32 or 8 bf16
    channels); their per-thread partials need (2 * vec + 1) floats each in
    shared memory, and the rest holds the block's share. A slab takes as
    many images as stay resident with the grid spread over them, evened
    over the slabs; where one image's share does not fit, a slab is one
    image and each block streams what does not fit."""
    itemsize = dtype.itemsize
    vec = 16 // itemsize
    red = _THREADS * (2 * vec + 1) * 4
    pixel_bytes = c * itemsize * inputs
    budget = SMEM_MAX - red

    def blocks_per_image(ips: int) -> int:
        return max(1, min(sms // ips, hw))

    ips = 1
    for k in range(min(n, sms), 0, -1):
        if -(-hw // blocks_per_image(k)) * pixel_bytes <= budget:
            ips = k
            break
    ips = -(-n // -(-n // ips))  # the same number of slabs, evened out
    share = -(-hw // blocks_per_image(ips))
    bpi = -(-hw // share)  # no block left without pixels
    resident = min(share, budget // pixel_bytes)
    groups = c // vec
    return SlabPlan(ips=ips, bpi=bpi, share=share, resident=resident,
                    streamed=share - resident,
                    lanes=_THREADS // min(groups, _THREADS), grid=ips * bpi,
                    smem=red + resident * pixel_bytes)


def _sms(x: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


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
    plan = launch_plan(n, hw, c, x.dtype, 1, _sms(x))
    y = torch.empty_like(x)
    # float32 scratch: each block's (mean, M2) of each channel.
    part = torch.empty(2 * n * plan.bpi * c, dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((n, c, 2), dtype=torch.float32, device=x.device)
    lib = _load()
    err = lib.in_act_forward(
        x.data_ptr(), y.data_ptr(), wt.data_ptr(), bs.data_ptr(),
        part.data_ptr(), stats.data_ptr(), n, hw, c, plan.ips, plan.bpi,
        plan.share, plan.resident, plan.smem, _DTYPES[x.dtype], _ACTS[act],
        negative_slope, EPS, torch.cuda.current_stream(x.device).cuda_stream)
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
    plan = launch_plan(n, hw, c, x.dtype, 2, _sms(x))
    dx = torch.empty_like(g)
    # float32 scratch: each block's sums of dz and dz*xhat of each channel;
    # dso receives per-(n, c) dscale and doffset.
    part = torch.empty(2 * n * plan.bpi * c, dtype=torch.float32,
                       device=x.device)
    dso = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    lib = _load()
    err = lib.in_act_backward(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), stats.data_ptr(),
        wt.data_ptr(), bs.data_ptr(), part.data_ptr(), dso.data_ptr(), n, hw,
        c, plan.ips, plan.bpi, plan.share, plan.resident, plan.smem,
        _DTYPES[x.dtype], _ACTS[act], negative_slope,
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
