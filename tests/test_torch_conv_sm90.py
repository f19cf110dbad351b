"""Host side of kernel B's forward entries: the wgmma kernel's
(csrc/conv3x3_fwd_sm90.cu) weight layout, emulated in plain torch as the
kernel reads it and held to the plain version at Co 16, 32 and 64; the
wrapper's choice of entry (wgmma body, float32 body, tail instantiation),
the tail uses' weight layouts, and the plain version the wgmma kernel is
held to on the card against the Pallas kernel it replaces (Mosaic
interpreter on the CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.ops.pallas.conv3x3 import conv3x3_packed, pack_w, unpack_w

from tactile_gan_torch.ops.kernels import conv3x3 as kb
from tactile_gan_torch.utils import profiling

torch.set_num_threads(2)


@pytest.mark.parametrize("cin", [8, 40, 64, 384])
def test_sm90_relayout_holds_the_weights_of_the_mma_sync_layout(cin):
    """[slices][9][2][Co][8] read back as [9][Co][Cin_pad] is
    ``relayout_weight``'s bf16 layout, zero past Cin (Cin 8 and 40 padded
    to 16 and 48)."""
    w = torch.from_numpy(np.random.default_rng(cin).normal(
        size=(64, cin, 3, 3)).astype(np.float32))
    wk = kb.relayout_weight_sm90(w)
    slices = -(-cin // 16)
    assert wk.shape == (slices, 9, 2, 64, 8) and wk.dtype == torch.bfloat16
    assert wk.is_contiguous()
    back = wk.permute(1, 3, 0, 2, 4).reshape(9, 64, 16 * slices)
    assert torch.equal(back, kb.relayout_weight(w, torch.bfloat16))
    for tap in range(9):
        assert torch.equal(back[tap, :, :cin],
                           w[:, :, tap // 3, tap % 3].to(torch.bfloat16))
    assert not back[:, :, cin:].any()


def emulate_sm90(x: torch.Tensor, wk: torch.Tensor, co: int) -> torch.Tensor:
    """The wgmma body's sum in plain torch, read as the kernel reads ``wk``
    ([tiles * slices][9][2][tile][8]): for each Co tile, each 16-channel
    slice of x (bf16, zero past Cin and outside the image) and each tap, one
    product of the shifted slice with the tile's [tile][16] weight rows
    (chunk c holds channels 8c..8c+7), float32 sums; the channels past Co
    are not stored. x (N,H,W,Cin) -> (N,H,W,co) float32."""
    n, h, w, cin = x.shape
    tile = wk.shape[3]
    tiles = -(-co // tile)
    slices = wk.shape[0] // tiles
    assert wk.shape == (tiles * slices, 9, 2, tile, 8) and slices * 16 >= cin
    xp = torch.zeros(n, h + 2, w + 2, slices * 16)
    xp[:, 1:h + 1, 1:w + 1, :cin] = x.to(torch.bfloat16).float()
    y = torch.zeros(n, h, w, tiles * tile)
    for t in range(tiles):
        for s in range(slices):
            step = wk[t * slices + s].float()  # [9][2][tile][8]
            for tap in range(9):
                dh, dw = divmod(tap, 3)
                b = step[tap].permute(1, 0, 2).reshape(tile, 16)
                a = xp[:, dh:dh + h, dw:dw + w, 16 * s:16 * s + 16]
                y[..., t * tile:(t + 1) * tile] += a @ b.T
    return y[..., :co]


@pytest.mark.parametrize("co", [16, 32, 64])
@pytest.mark.parametrize("cin", [24, 72])
def test_sm90_forward_layout_read_as_the_kernel_reads_it_is_the_conv(cin, co):
    """B's forward on the wgmma body at each Co tile width: the layout of
    ``forward_sm90`` read slice by slice, tap by tap, is the plain conv
    (one tile, Cin 24 and 72 padded to whole slices)."""
    rng = np.random.default_rng(cin + co)
    x = torch.from_numpy(rng.normal(size=(2, 5, 7, cin)).astype(np.float32))
    w = torch.from_numpy(
        (0.1 * rng.normal(size=(co, cin, 3, 3))).astype(np.float32))
    wk = kb._kernel_weight(w, torch.bfloat16, "forward_sm90")
    assert wk.shape == (-(-cin // 16), 9, 2, co, 8)
    # float32 sums of up to 9 * 80 products in another order.
    torch.testing.assert_close(emulate_sm90(x, wk, co), kb.conv3x3_plain(x, w),
                               atol=1e-4, rtol=1e-4)


def test_sm90_relayout_is_kept_per_use():
    w = torch.nn.Parameter(torch.randn(64, 24, 3, 3))
    first = kb._kernel_weight(w, torch.bfloat16, "forward_sm90")
    assert kb._kernel_weight(w, torch.bfloat16, "forward_sm90") is first
    assert kb._kernel_weight(w, torch.bfloat16).shape == (9, 64, 32)
    with torch.no_grad():
        w.mul_(2)
    again = kb._kernel_weight(w, torch.bfloat16, "forward_sm90")
    assert again is not first
    torch.testing.assert_close(again.float(), 2 * first.float())


@pytest.mark.parametrize("cin,co,cd,want", [
    (64, 64, torch.bfloat16, kb.SM90_ENTRY),
    (384, 64, torch.bfloat16, kb.SM90_ENTRY),
    (64, 64, torch.float32, kb.BODY_ENTRY),
    (64, 32, torch.bfloat16, kb.SM90_ENTRY),
    (8, 16, torch.bfloat16, kb.SM90_ENTRY),
    (64, 8, torch.bfloat16, kb.TAIL_ENTRY),
    (72, 24, torch.bfloat16, kb.TAIL_ENTRY),
    (12, 64, torch.bfloat16, kb.TAIL_ENTRY),
    (36, 12, torch.float32, kb.TAIL_ENTRY)])
def test_forward_entry_by_width_and_compute_dtype(cin, co, cd, want):
    """Cin % 8 == 0 with Co 16/32/64 and bf16 operands goes to the wgmma
    kernel whatever the input dtype; float32 compute at those widths to
    csrc/conv3x3.cu's forward entry; other widths (UNet++ at nf 8, 12, 24)
    take that file's tail instantiation."""
    assert kb.forward_entry(cin, co, cd) == want
    assert kb.in_body(cin, co) is (want != kb.TAIL_ENTRY)


@pytest.mark.parametrize("cin,co", [(8, 64), (12, 24), (64, 8)])
def test_forward_kernel_refuses_cpu_tensors_and_counts_nothing(cin, co):
    before = (kb.conv3x3.launches, kb.dgrad_kernel.launches)
    x, w = torch.randn(1, 4, 4, cin), torch.randn(co, cin, 3, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        kb.forward_kernel(x, w, torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        kb.dgrad_kernel(torch.randn(1, 4, 4, co), w, torch.bfloat16)
    assert (kb.conv3x3.launches, kb.dgrad_kernel.launches) == before


@pytest.mark.parametrize("cin,co", [(12, 12), (36, 24), (64, 8), (8, 40)])
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_tail_uses_read_the_layout_of_kernel_e(cin, co, cd):
    """Off the body's widths, B's forward and B-dx run kernel E's tail
    instantiation: the forward's weight is laid out as E lays out the same
    conv's HWIO weight, and B-dx's (the rotated-transposed weight, Co = the
    forward's Cin) as E lays out the dx conv's."""
    w = torch.from_numpy(np.random.default_rng(cin + co).normal(
        size=(co, cin, 3, 3)).astype(np.float32))
    hwio = w.permute(2, 3, 1, 0)
    assert torch.equal(kb._RELAYOUTS["forward_tail"](w, cd),
                       kb._RELAYOUTS["p1"](hwio, cd))
    assert torch.equal(kb._RELAYOUTS["dgrad"](w, cd),
                       kb._RELAYOUTS["p1"](kb.rot_t(w).permute(2, 3, 1, 0), cd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_packed_at_co_64(dtype):
    """The plain version that the wgmma kernel is held to on the card,
    against the Pallas conv3x3_packed forward at Co 64, bf16 operands, H not
    a multiple of the kernel's 4 rows."""
    n, h, w, c, co = 2, 6, 10, 32, 64
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, co)) * 0.1).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(tx.float().numpy(), jnp.dtype(dtype))
    want = unpack_w(conv3x3_packed(pack_w(xj), jnp.asarray(k), h=h,
                                   interpret=True,
                                   compute_dtype=jnp.bfloat16), h, co)
    oihw = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = kb.conv3x3_plain(tx, oihw, compute_dtype=torch.bfloat16)
    assert got.dtype == tx.dtype and got.shape == (n, h, w, co)
    # Same rounded operands and exact products, float32 sums in another
    # order; a bf16 output may round one ulp apart (2^-8 relative).
    tol = (dict(atol=1e-4, rtol=1e-4) if dtype == "float32"
           else dict(atol=1e-2, rtol=2.0 ** -7))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_profile_counts_the_wgmma_kernel_as_kernel_b():
    name = ("void (anonymous namespace)::conv3x3_fwd_sm90_kernel<float, 64>"
            "(const float *, ...)")
    assert profiling.kernel_family(name) == "kernel_b"
    tail = ("void (anonymous namespace)::conv3x3_p1_bf16_kernel<float, 16>"
            "(const float *, ...)")
    assert profiling.kernel_family(tail) == "conv3x3_tail"
