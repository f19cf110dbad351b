"""Kernel B: 3x3 / stride 1 / padding 1 convolution for the full-resolution
row, NHWC in and out, forward and input gradient (dx), behind a
``torch.autograd.Function`` whose weight gradient is kernel D
(``ops/kernels/conv3x3_wgrad.py``).

Replaces the Pallas kernel ``tactile_gan_tpu/ops/pallas/conv3x3.py``
``conv3x3_packed`` (reached through ``ops/packed_row.py``), in both of its
uses: the forward and dx, which is the same conv of the gradient with the
rotated-transposed weight (``_rot_t``). Its packed operand is NHWC memory,
so on the card it is a plain channels-last conv. Every conv with bf16
operands at Cin % 8 == 0 runs the wgmma body of
``csrc/conv3x3_fwd_sm90.cu``: B's forward at Co 16/32/64 (every row-0 conv
of UNet++ at nf 16, 32 and 64, serving and training), B-dx (Co = the
forward's Cin, walked in tiles of ``co_tile``) and kernel E (below).
Float32 compute, and bf16 compute at other widths, run
``csrc/conv3x3.cu``. Bound on the card: operations (2*9*Cin*Co flops a
pixel against (Cin+Co) elements moved) at the tensor cores' bf16 rate, or
the bytes where the input is float32. The wgmma body is an implicit GEMM
that streams 16-channel slices of a haloed 4x64-pixel input tile and of the
weights through shared memory with float32 accumulators, each block
walking every output-channel tile of its pixels; float32 compute runs on
the CUDA cores. The wrapper re-lays each weight once per use (and again
only after an in-place update of it) into the layout the kernel reads.

Numerics, kernel and plain version alike: operands rounded to
``compute_dtype`` (bfloat16 or float32), products and sums in float32, the
output in the input's dtype. B takes any Cin (the port convolves the
concatenated node input, up to 384 channels at nf=64) and any Co up to 64,
the convs the JAX package gives its packed kernel (2 Co <= 128 lanes). Cin
a multiple of 8 with Co 16, 32 or 64 runs the entries above; any other
widths (UNet++ at nf 8, 12 or 24) run ``conv3x3.cu``'s tail instantiation,
which writes float32 (cast to a bfloat16 input's dtype after). The dx conv
takes the tail on the same condition. On a CPU tensor the Function runs the
plain versions; on a CUDA tensor it launches the kernels or raises. It is
first-order only: a backward run while building a graph for a second
derivative raises.

Kernel E: ``conv3x3_p1`` and ``conv3x3_p1_h`` replace the Pallas functions
of the same names (``ops/pallas/conv3x3.py``, W-pairs and H-pairs), whose
only caller is the conv probe (``cli/probe_conv.py``). Both compute the
function that B computes: the pairs were a way to fill the TPU's 128 MXU
lanes, so both names launch one kernel: the wgmma body with a float32
output at bf16 compute and Cin % 8 == 0 (any Co >= 1), else the tail
instantiation, which takes any Cin and Co >= 1. Both take any H, W >= 1
(the Pallas functions need an even W or H). They take NHWC x (float32 or
bfloat16) and an HWIO weight, as the Pallas functions do, and are forward
only: an input that requires grad under grad mode raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from tactile_gan_torch.ops.kernels import build
from tactile_gan_torch.ops.kernels.conv3x3_wgrad import (
    conv3x3_flops, conv3x3_wgrad,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMPUTE = (torch.bfloat16, torch.float32)
_CO = (16, 32, 64)  # Co of B's entries without the tail
MAX_CO = 64
_KC = 16  # Cin slice of the bf16 kernels (csrc kKC)
_KCF = 8  # Cin slice of the float32 kernel (csrc kKCF)

_lib: Optional[ctypes.CDLL] = None
_lib_sm90: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("conv3x3")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_forward.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.conv3x3_forward.restype = i
        lib.conv3x3_dgrad.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.conv3x3_dgrad.restype = i
        lib.conv3x3_p1_forward.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                           i, p]
        lib.conv3x3_p1_forward.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_sm90() -> ctypes.CDLL:
    global _lib_sm90
    if _lib_sm90 is None:
        lib = build.load("conv3x3_fwd_sm90")
        p, i = ctypes.c_void_p, ctypes.c_int
        for entry in _SM90_ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
            fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib_sm90 = lib
    return _lib_sm90


def supported(co: int) -> bool:
    """Whether kernel B takes a conv of Co output channels (any Cin): the
    model routes a wider conv to the library conv (``ops/conv.py``), as the
    JAX package routes it to XLA's conv."""
    return 1 <= co <= MAX_CO


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
    (Cin zero-padded to a multiple of 16) for bf16 compute,
    [9][Cin_pad][Co_pad] float32 (Cin zero-padded to a multiple of 8) for
    float32 compute; Co is zero-padded to a multiple of ``tile`` (0: no
    padding)."""
    co, cin = weight.shape[:2]
    co_pad = (-co) % tile if tile else 0
    if compute_dtype == torch.bfloat16:
        w = weight.permute(2, 3, 0, 1).reshape(9, co, cin)
        w = F.pad(w, (0, (-cin) % _KC, 0, co_pad))
    else:
        w = weight.permute(2, 3, 1, 0).reshape(9, cin, co)
        w = F.pad(w, (0, co_pad, 0, (-cin) % _KCF))
    return w.to(compute_dtype).contiguous()


def relayout_weight_sm90(weight: torch.Tensor) -> torch.Tensor:
    """OIHW -> the layout the wgmma kernel reads: [tiles * slices][9 taps]
    [2 chunks][tile][8] bfloat16, tile = ``co_tile(Co)``, Cin zero-padded to
    slices * 16 and Co to whole tiles. Step (co tile, 16-channel slice) =
    tile * slices + slice is contiguous and is copied into shared memory as
    it lies: per tap, two planes (channels 0-7 and 8-15 of the slice) of
    ``tile`` rows of 8 channels."""
    co, cin = weight.shape[:2]
    tile = co_tile(co)
    w = weight.permute(2, 3, 0, 1).reshape(9, co, cin)
    w = F.pad(w, (0, (-cin) % _KC, 0, (-co) % tile))
    w = w.reshape(9, -1, tile, w.shape[-1] // _KC, 2, 8)
    w = w.permute(1, 3, 0, 4, 2, 5).reshape(-1, 9, 2, tile, 8)
    return w.to(torch.bfloat16).contiguous()


def hwio_to_oihw(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Co) -> (Co, Cin, 3, 3), a view."""
    return k.permute(3, 2, 0, 1)


# How each use re-lays its weight, for conv3x3.cu's entries (float32
# compute, and the tail with Co padded to its tile) and for the wgmma
# body's (the _sm90 uses): B's forward (OIHW), B-dx (the rotated-transposed
# OIHW weight, Co = the forward's Cin walked in tiles) and kernel E (HWIO,
# any Co, walked in tiles).
_RELAYOUTS = {
    "forward": lambda w, cd: relayout_weight(w, cd),
    "forward_tail": lambda w, cd: relayout_weight(w, cd, co_tile(w.shape[0])),
    "forward_sm90": lambda w, cd: relayout_weight_sm90(w),
    "dgrad": lambda w, cd: relayout_weight(rot_t(w), cd, co_tile(w.shape[1])),
    "dgrad_sm90": lambda w, cd: relayout_weight_sm90(rot_t(w)),
    "p1": lambda k, cd: relayout_weight(hwio_to_oihw(k), cd,
                                        co_tile(k.shape[3])),
    "p1_sm90": lambda k, cd: relayout_weight_sm90(hwio_to_oihw(k)),
}

# The re-laid weights, kept while their source tensor lives, is not
# written in place (its version counter moves on every in-place update) and
# keeps its storage (``.data`` reassigned, as ``Module.to`` does): one entry
# per (compute dtype, use) of each weight. A CUDA graph breaks the version
# rule both ways, so under capture the relayout is always recorded into the
# graph (each replay re-lays the weights it finds) and never cached, and a
# replay, which updates weights without moving their version counter, is
# followed by ``invalidate_relayouts`` (``train/graph.py``).
_relaid = WeakIdKeyDictionary()


def _capturing(weight: torch.Tensor) -> bool:
    """Whether the current stream of ``weight``'s CUDA device is being
    captured into a graph (never for a CPU tensor)."""
    return weight.is_cuda and torch.cuda.is_current_stream_capturing()


def invalidate_relayouts() -> None:
    """Forget every cached relayout: the next eager call re-lays its
    weight."""
    _relaid.clear()


def _kernel_weight(weight: torch.Tensor, compute_dtype: torch.dtype,
                   use: str = "forward") -> torch.Tensor:
    if _capturing(weight):
        return _RELAYOUTS[use](weight.detach(), compute_dtype)
    key = (weight._version, weight.data_ptr())
    entries = _relaid.setdefault(weight, {})
    hit = entries.get((compute_dtype, use))
    if hit is not None and hit[0] == key:
        return hit[1]
    wk = _RELAYOUTS[use](weight.detach(), compute_dtype)
    entries[(compute_dtype, use)] = (key, wk)
    return wk


SM90_ENTRY = "conv3x3_fwd_sm90"
BODY_ENTRY = "conv3x3_forward"
DGRAD_SM90_ENTRY = "conv3x3_dgrad_sm90"
DGRAD_ENTRY = "conv3x3_dgrad"
P1_SM90_ENTRY = "conv3x3_p1_sm90"
TAIL_ENTRY = "conv3x3_p1_forward"
# The wgmma body's entries (csrc/conv3x3_fwd_sm90.cu), one per use.
_SM90_ENTRIES = (SM90_ENTRY, DGRAD_SM90_ENTRY, P1_SM90_ENTRY)


def in_body(cin: int, co: int) -> bool:
    """Whether B's forward (and its dx) at these widths runs the entries
    without the tail: the wgmma body for bf16 compute, ``conv3x3.cu``'s
    float32 body otherwise."""
    return cin % 8 == 0 and co in _CO


def forward_entry(cin: int, co: int, compute_dtype: torch.dtype) -> str:
    """The CUDA entry that runs B's forward: the wgmma body at Co 16/32/64
    with bf16 operands (either input dtype), the float32 body of
    ``csrc/conv3x3.cu`` at the same widths, and that file's tail
    instantiation elsewhere."""
    if not in_body(cin, co):
        return TAIL_ENTRY
    return SM90_ENTRY if compute_dtype == torch.bfloat16 else BODY_ENTRY


def dgrad_entry(cin: int, co: int, compute_dtype: torch.dtype) -> str:
    """The CUDA entry that runs B-dx of a forward of these widths (its
    output width is ``cin``, walked in tiles of ``co_tile(cin)``)."""
    if not in_body(cin, co):
        return TAIL_ENTRY
    return (DGRAD_SM90_ENTRY if compute_dtype == torch.bfloat16
            else DGRAD_ENTRY)


def p1_entry(cin: int, compute_dtype: torch.dtype) -> str:
    """The CUDA entry that runs kernel E (any Co): the wgmma body with a
    float32 output at bf16 compute and Cin % 8 == 0, else the tail."""
    if cin % 8 == 0 and compute_dtype == torch.bfloat16:
        return P1_SM90_ENTRY
    return TAIL_ENTRY


def _check_aligned(t: torch.Tensor, what: str) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous, 16-byte aligned NHWC "
                         f"tensor; got shape {tuple(t.shape)}, strides "
                         f"{t.stride()}")


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.cuda_error_string(err).decode())


def _tail_kernel(x: torch.Tensor, wk: torch.Tensor, co: int,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """``conv3x3.cu``'s tail on a CUDA tensor: any Cin and Co, float32 out;
    ``wk`` is laid out by ``relayout_weight`` with Co padded to
    ``co_tile(co)``. The caller counts the launch."""
    n, h, w, cin = x.shape
    bf16 = compute_dtype == torch.bfloat16
    y = torch.empty((n, h, w, co), dtype=torch.float32, device=x.device)
    lib = _load()
    _raise_on(lib.conv3x3_p1_forward(
        x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, w, cin,
        wk.shape[-1] if bf16 else wk.shape[1], co, co_tile(co),
        _DTYPES[x.dtype], int(bf16),
        torch.cuda.current_stream(x.device).cuda_stream), lib,
        "conv3x3 (tail)")
    return y


def _sm90_kernel(entry: str, x: torch.Tensor, wk: torch.Tensor, co: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """One of the wgmma body's entries on a CUDA tensor: x (N,H,W,Cin) ->
    (N,H,W,co) in ``out_dtype``; ``wk`` is laid out by
    ``relayout_weight_sm90`` with tiles of ``co_tile(co)``. The caller
    counts the launch."""
    n, h, w, cin = x.shape
    y = torch.empty((n, h, w, co), dtype=out_dtype, device=x.device)
    lib = _load_sm90()
    _raise_on(getattr(lib, entry)(
        x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, w, cin, co,
        co_tile(co), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream), lib, entry)
    return y


def forward_kernel(x: torch.Tensor, weight: torch.Tensor,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """Kernel B's forward on a CUDA tensor, through ``forward_entry``'s
    entry."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError("conv3x3 kernel takes a 4-d NHWC float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if (weight.dim() != 4 or weight.shape[1:] != (cin, 3, 3)
            or not supported(weight.shape[0]) or weight.device != x.device):
        raise ValueError(f"conv3x3 kernel needs a (Co, {cin}, 3, 3) weight "
                         f"with Co <= {MAX_CO} on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    _check_aligned(x, "conv3x3 kernel")
    co = weight.shape[0]
    entry = forward_entry(cin, co, compute_dtype)
    if entry == TAIL_ENTRY:
        wk = _kernel_weight(weight, compute_dtype, "forward_tail")
        y = _tail_kernel(x, wk, co, compute_dtype).to(x.dtype)
    elif entry == SM90_ENTRY:
        wk = _kernel_weight(weight, compute_dtype, "forward_sm90")
        y = _sm90_kernel(entry, x, wk, co, x.dtype)
    else:
        wk = _kernel_weight(weight, compute_dtype)
        y = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
        lib = _load()
        _raise_on(lib.conv3x3_forward(
            x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, w, cin, co,
            _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream), lib, "conv3x3")
    conv3x3.launches += 1
    conv3x3.bf16_launches += x.dtype == torch.bfloat16
    conv3x3.flops += conv3x3_flops(n, h, w, cin, co)
    return y


def dgrad_kernel(g: torch.Tensor, weight: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Kernel B's dx use on a CUDA tensor: g (N,H,W,Co) -> (N,H,W,Cin),
    through ``dgrad_entry``'s entry."""
    if g.device.type != "cuda":
        raise ValueError(f"conv3x3 dgrad: unsupported device {g.device}")
    co, cin = weight.shape[:2]
    if (g.dim() != 4 or g.dtype not in _DTYPES or g.shape[-1] != co
            or not supported(co) or weight.shape[2:] != (3, 3)
            or weight.device != g.device):
        raise ValueError(f"conv3x3 dgrad kernel needs an NHWC float32 or "
                         f"bfloat16 gradient of {co} channels (Co <= "
                         f"{MAX_CO}) on the weight's device; got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    _check_aligned(g, "conv3x3 dgrad kernel")
    n, h, w, _ = g.shape
    entry = dgrad_entry(cin, co, compute_dtype)
    if entry == DGRAD_SM90_ENTRY:
        wk = _kernel_weight(weight, compute_dtype, "dgrad_sm90")
        dx = _sm90_kernel(entry, g, wk, cin, g.dtype)
    else:
        # The rotated-transposed weight, its Co (the forward's Cin) padded
        # to its tile: the layout of both the float32 entry and the tail.
        wk = _kernel_weight(weight, compute_dtype, "dgrad")
        if entry == TAIL_ENTRY:
            dx = _tail_kernel(g, wk, cin, compute_dtype).to(g.dtype)
        else:
            dx = torch.empty((n, h, w, cin), dtype=g.dtype, device=g.device)
            lib = _load()
            _raise_on(lib.conv3x3_dgrad(
                g.data_ptr(), wk.data_ptr(), dx.data_ptr(), n, h, w, co, cin,
                co_tile(cin), _DTYPES[g.dtype],
                torch.cuda.current_stream(g.device).cuda_stream), lib,
                "conv3x3 dgrad")
    dgrad_kernel.launches += 1
    dgrad_kernel.bf16_launches += g.dtype == torch.bfloat16
    dgrad_kernel.flops += conv3x3_flops(n, h, w, cin, co)
    return dx


dgrad_kernel.launches = 0  # kernel B launches for dx
dgrad_kernel.bf16_launches = 0  # of those, on a bfloat16 gradient
dgrad_kernel.flops = 0  # of those launches (conv3x3_wgrad.py's docstring)


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
conv3x3.bf16_launches = 0  # of those, on a bfloat16 input
conv3x3.flops = 0  # of those launches (conv3x3_wgrad.py's docstring)


def conv3x3_p1_plain(x: torch.Tensor, k: torch.Tensor, *,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """The plain version of kernel E: x (N,H,W,C) float32 or bfloat16, k
    (3,3,C,Co) HWIO -> (N,H,W,Co) float32; operands rounded to
    ``compute_dtype``, float32 sums."""
    return conv3x3_plain(x.float(), hwio_to_oihw(k),
                         compute_dtype=compute_dtype)


def _check_p1(name: str, x: torch.Tensor, k: torch.Tensor,
              compute_dtype: torch.dtype) -> None:
    if compute_dtype not in _COMPUTE:
        raise ValueError(f"{name}: unsupported compute dtype {compute_dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or min(x.shape) < 1:
        raise ValueError(f"{name} takes a non-empty NHWC float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if (k.dim() != 4 or k.shape[:3] != (3, 3, x.shape[3]) or k.shape[3] < 1
            or not k.is_floating_point() or k.device != x.device):
        raise ValueError(f"{name} needs a (3, 3, {x.shape[3]}, Co) HWIO "
                         f"weight on {x.device}, got {k.dtype} "
                         f"{tuple(k.shape)} on {k.device}")
    if torch.is_grad_enabled() and (x.requires_grad or k.requires_grad):
        raise RuntimeError(
            f"{name} is forward only, like the Pallas function it ports: its "
            "output would have no gradient. Call it under torch.no_grad() or "
            "on tensors that do not require grad")


def _p1_kernel(x: torch.Tensor, k: torch.Tensor, compute_dtype: torch.dtype,
               counter) -> torch.Tensor:
    """Kernel E on a CUDA tensor, through ``p1_entry``'s entry;
    ``counter.launches`` counts the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel E: unsupported device {x.device}")
    _check_aligned(x, "kernel E")
    co = k.shape[3]
    if p1_entry(x.shape[3], compute_dtype) == P1_SM90_ENTRY:
        y = _sm90_kernel(P1_SM90_ENTRY, x,
                         _kernel_weight(k, compute_dtype, "p1_sm90"), co,
                         torch.float32)
    else:
        y = _tail_kernel(x, _kernel_weight(k, compute_dtype, "p1"), co,
                         compute_dtype)
    counter.launches += 1
    return y


def _p1(name: str, counter, x: torch.Tensor, k: torch.Tensor,
        compute_dtype: torch.dtype) -> torch.Tensor:
    _check_p1(name, x, k, compute_dtype)
    if x.device.type == "cpu":
        return conv3x3_p1_plain(x, k, compute_dtype=compute_dtype)
    return _p1_kernel(x, k, compute_dtype, counter)


def conv3x3_p1(x: torch.Tensor, k: torch.Tensor, *,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Port of the Pallas ``conv3x3_p1`` (W-pairs): 3x3/s1/p1 conv, x
    (N,H,W,C) float32 or bfloat16, k (3,3,C,Co) HWIO -> (N,H,W,Co) float32.
    Kernel E on a CUDA tensor, the plain version on a CPU tensor; forward
    only."""
    return _p1("conv3x3_p1", conv3x3_p1, x, k, compute_dtype)


conv3x3_p1.launches = 0  # kernel E launches through conv3x3_p1


def conv3x3_p1_h(x: torch.Tensor, k: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Port of the Pallas ``conv3x3_p1_h`` (H-pairs): the same function as
    ``conv3x3_p1``, through the same kernel E, counted on its own."""
    return _p1("conv3x3_p1_h", conv3x3_p1_h, x, k, compute_dtype)


conv3x3_p1_h.launches = 0  # kernel E launches through conv3x3_p1_h
