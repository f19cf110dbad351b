"""Kernel D: the weight gradient of the 3x3 / stride 1 / padding 1 conv,
NHWC activations, OIHW float32 result.

Replaces the Pallas kernel ``tactile_gan_tpu/ops/pallas/conv3x3.py``
``conv3x3_packed_wgrad`` (reached from ``ops/packed_row.py``) together with
its fold ``_dk_from_db``. It is a GEMM with M = 9*Cin, N = Co and K = N*H*W
pixels; the pixels are split over blocks, each writes its partial dk, and a
second launch sums the partials in a fixed order, so the result is the same
on every run. Two bodies write the partials: with bf16 operands the wgmma
kernel of ``csrc/conv3x3_wgrad_sm90.cu`` (``SM90_ENTRY``), with float32
operands the CUDA-core kernel of ``csrc/conv3x3_wgrad.cu`` (``F32_ENTRY``),
whose ``conv3x3_wgrad_reduce`` sums either's partials.

Numerics, kernel and plain version alike: x and g rounded to
``compute_dtype`` (bfloat16 or float32), products and sums in float32. It
takes any Cin and any Co up to 64, as kernel B does. The kernels read
channels in groups of 8: where Cin or Co is not a multiple of 8 (UNet++ at
nf 12) the wrapper zero-pads x or g to one (a copy of each padded tensor),
which adds zero rows to dk that it drops. On a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from tactile_gan_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMPUTE = (torch.bfloat16, torch.float32)
_MAX_CO = 64
_SMS = 132
SM90_ENTRY = "conv3x3_wgrad_sm90"
F32_ENTRY = "conv3x3_wgrad_f32"
SM90_COLS = 64           # columns of a strip (csrc conv3x3_wgrad_sm90 kCols)
SM90_CI = 64             # input channels per block (kCI there)
_F32_TILE = (8, 32)      # output pixels per tile (csrc conv3x3_wgrad kMH, kMW)
_F32_CI = 32             # input channels per block (kCI there)

# csrc source of each entry; conv3x3_wgrad.cu also holds the reduce.
_SOURCES = {SM90_ENTRY: "conv3x3_wgrad_sm90", F32_ENTRY: "conv3x3_wgrad"}
_libs: Dict[str, ctypes.CDLL] = {}


def _load(entry: str) -> ctypes.CDLL:
    """The library that holds ``entry``, built on first use."""
    lib = _libs.get(entry)
    if lib is None:
        lib = build.load(_SOURCES[entry])
        p, i = ctypes.c_void_p, ctypes.c_int
        getattr(lib, entry).argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        getattr(lib, entry).restype = i
        if entry == F32_ENTRY:
            lib.conv3x3_wgrad_reduce.argtypes = [p, p, i, i, i, p]
            lib.conv3x3_wgrad_reduce.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[entry] = lib
    return lib


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


def partial_entry(compute_dtype: torch.dtype) -> str:
    """The CUDA entry that writes D's partials: the wgmma kernel with bf16
    operands (either input dtype), the CUDA-core kernel in float32."""
    return SM90_ENTRY if compute_dtype == torch.bfloat16 else F32_ENTRY


def launch_plan(n: int, h: int, w: int, cin: int) -> Tuple[int, int]:
    """(rows_per_chunk, chunks) of the wgmma kernel: its N * ceil(W/64) * H
    (strip, output row) pairs, strip-major, cut into runs so that the
    ceil(Cin/64) * chunks blocks (one an SM) fill the 132 SMs in one wave.
    A run may cross into the next strip."""
    rows = n * -(-w // SM90_COLS) * h
    want = max(1, _SMS // -(-cin // SM90_CI))
    per = -(-rows // min(want, rows))
    return per, -(-rows // per)


def f32_launch_plan(n: int, h: int, w: int, cin: int) -> Tuple[int, int]:
    """(tiles_per_chunk, chunks) of the float32 kernel: the split of the
    N*ceil(H/8)*ceil(W/32) pixel tiles so that ceil(Cin/32) * chunks blocks
    fill the card in one wave (two blocks an SM)."""
    tiles = n * -(-h // _F32_TILE[0]) * -(-w // _F32_TILE[1])
    want = max(1, 2 * _SMS // -(-cin // _F32_CI))
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
    if not 1 <= co <= _MAX_CO:
        raise ValueError(f"conv3x3_wgrad kernel needs Co up to {_MAX_CO}; "
                         f"got Co {co}")
    if cin % 8 or co % 8:
        dk = conv3x3_wgrad(F.pad(x, (0, (-cin) % 8)), F.pad(g, (0, (-co) % 8)),
                           compute_dtype=compute_dtype)
        return dk[:co, :cin].contiguous()
    for t in (x, g):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv3x3_wgrad kernel needs contiguous, 16-byte "
                             f"aligned tensors; got strides {t.stride()}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = partial_entry(compute_dtype)
    plan = launch_plan if entry == SM90_ENTRY else f32_launch_plan
    per, chunks = plan(n, h, w, cin)
    part = torch.empty(chunks * 9 * cin * co, dtype=torch.float32,
                       device=x.device)
    dk = torch.empty((co, cin, 3, 3), dtype=torch.float32, device=x.device)
    lib = _load(entry)
    err = getattr(lib, entry)(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), n, h, w, cin, co, per,
        chunks, _DTYPES[x.dtype], stream)
    if not err:
        lib = _load(F32_ENTRY)
        err = lib.conv3x3_wgrad_reduce(part.data_ptr(), dk.data_ptr(), cin,
                                       co, chunks, stream)
    if err:
        raise RuntimeError("conv3x3_wgrad kernel launch failed: "
                           + lib.cuda_error_string(err).decode())
    conv3x3_wgrad.launches += 1
    return dk


conv3x3_wgrad.launches = 0
