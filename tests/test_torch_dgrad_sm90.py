"""Host side of B-dx and kernel E on the wgmma body (csrc/conv3x3_fwd_sm90.cu):
their weight layouts (the rotated-transposed weight tiled over the
forward's Cin; the HWIO weight tiled over any Co), emulated in plain torch
as the kernel reads them and held to the plain versions; the wrappers'
choice of entry; the refusal of a CPU tensor; the profile families of the
new kernels; and the plain dx against the Pallas kernel it replaces (Mosaic
interpreter on the CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.ops.packed_row import _rot_t
from tactile_gan_tpu.ops.pallas.conv3x3 import conv3x3_packed, pack_w, unpack_w

from tactile_gan_torch.ops.kernels import conv3x3 as kb
from tactile_gan_torch.utils import profiling

from test_torch_conv_sm90 import emulate_sm90

torch.set_num_threads(2)


def _tensor(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))


@pytest.mark.parametrize("cin,co", [(64, 64), (192, 64), (384, 64), (40, 16)])
def test_dgrad_layout_read_as_the_kernel_reads_it_is_dx(cin, co):
    """B-dx: ``rot_t(w)`` laid out in Co tiles of ``co_tile(cin)`` over the
    forward's Cin (1, 3 and 6 tiles of 64; Cin 40 one partial tile), read
    Co tile by Co tile, slice by slice, tap by tap, is the plain dx."""
    rng = np.random.default_rng(cin)
    g = _tensor(rng, (2, 4, 6, co))
    w = _tensor(rng, (co, cin, 3, 3), 0.1)
    wk = kb._kernel_weight(w, torch.bfloat16, "dgrad_sm90")
    tiles, slices = -(-cin // 64), -(-co // 16)
    assert kb.co_tile(cin) == 64
    assert wk.shape == (tiles * slices, 9, 2, 64, 8) and wk.is_contiguous()
    rows = wk.permute(0, 1, 3, 2, 4).reshape(tiles, slices, 9, 64, 16)
    assert not rows[-1, :, :, cin - 64 * (tiles - 1):].any()  # Co padding
    # float32 sums of 9 * Co products in another order.
    torch.testing.assert_close(emulate_sm90(g, wk, cin),
                               kb.conv3x3_dgrad_plain(g, w),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cin,co", [(64, 64), (32, 64), (64, 32), (24, 40),
                                    (8, 96)])
def test_p1_layout_read_as_the_kernel_reads_it_is_the_conv(cin, co):
    """Kernel E: the HWIO weight laid out in Co tiles of ``co_tile(co)`` (the
    probe's three pairs; Co 40, one partial tile of 64; Co 96, a whole tile
    and a partial one), read as the kernel reads it, is the plain E."""
    rng = np.random.default_rng(cin + co)
    x = _tensor(rng, (2, 5, 9, cin))
    k = _tensor(rng, (3, 3, cin, co), 0.1)
    wk = kb._kernel_weight(k, torch.bfloat16, "p1_sm90")
    tile = kb.co_tile(co)
    assert wk.shape == (-(-co // tile) * -(-cin // 16), 9, 2, tile, 8)
    torch.testing.assert_close(emulate_sm90(x, wk, co),
                               kb.conv3x3_p1_plain(x, k),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cin,co,cd,want", [
    (64, 64, torch.bfloat16, kb.DGRAD_SM90_ENTRY),
    (384, 64, torch.bfloat16, kb.DGRAD_SM90_ENTRY),
    (40, 32, torch.bfloat16, kb.DGRAD_SM90_ENTRY),
    (8, 16, torch.bfloat16, kb.DGRAD_SM90_ENTRY),
    (192, 64, torch.float32, kb.DGRAD_ENTRY),
    (12, 16, torch.bfloat16, kb.TAIL_ENTRY),
    (64, 24, torch.bfloat16, kb.TAIL_ENTRY),
    (36, 12, torch.float32, kb.TAIL_ENTRY)])
def test_dgrad_entry_by_width_and_compute_dtype(cin, co, cd, want):
    """B-dx of a forward (Cin, Co): the wgmma body where the forward runs
    it (bf16, Cin % 8 == 0, Co 16/32/64), the float32 body at those widths,
    the tail elsewhere."""
    assert kb.dgrad_entry(cin, co, cd) == want
    if want != kb.TAIL_ENTRY:
        assert kb.forward_entry(cin, co, cd) != kb.TAIL_ENTRY


@pytest.mark.parametrize("cin,cd,want", [
    (64, torch.bfloat16, kb.P1_SM90_ENTRY),
    (32, torch.bfloat16, kb.P1_SM90_ENTRY),
    (8, torch.bfloat16, kb.P1_SM90_ENTRY),
    (136, torch.bfloat16, kb.P1_SM90_ENTRY),
    (64, torch.float32, kb.TAIL_ENTRY),
    (13, torch.bfloat16, kb.TAIL_ENTRY),
    (3, torch.float32, kb.TAIL_ENTRY)])
def test_p1_entry_by_width_and_compute_dtype(cin, cd, want):
    """Kernel E at any Co: the wgmma body at bf16 compute and Cin % 8 == 0,
    the tail at any other Cin or float32 compute."""
    assert kb.p1_entry(cin, cd) == want


@pytest.mark.parametrize("cin,co", [(64, 64), (384, 64), (40, 16)])
def test_sm90_wrappers_refuse_cpu_tensors_and_count_nothing(cin, co):
    counters = (kb.conv3x3, kb.dgrad_kernel, kb.conv3x3_p1, kb.conv3x3_p1_h)
    before = [c.launches for c in counters]
    w = torch.randn(co, cin, 3, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        kb.dgrad_kernel(torch.randn(1, 4, 4, co), w, torch.bfloat16)
    for counter in (kb.conv3x3_p1, kb.conv3x3_p1_h):
        with pytest.raises(ValueError, match="unsupported device"):
            kb._p1_kernel(torch.randn(1, 4, 4, cin), kb.rot_t(w).permute(
                2, 3, 0, 1), torch.bfloat16, counter)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::conv3x3_fwd_sm90_kernel<__nv_bfloat16, 32>"
     "(const __nv_bfloat16 *, ...)", "kernel_b"),
    ("void (anonymous namespace)::conv3x3_dgrad_sm90_kernel<float, 64>"
     "(const float *, ...)", "kernel_b_dx"),
    ("void (anonymous namespace)::conv3x3_p1_sm90_kernel<float, 16>"
     "(const float *, ...)", "kernel_e"),
    ("void (anonymous namespace)::conv3x3_p1_bf16_kernel<float, 64>"
     "(const float *, ...)", "conv3x3_tail"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32", "library_conv")])
def test_profile_families_of_the_wgmma_conv_kernels(name, family):
    """The port's families match before the library's "sm90_" substring."""
    assert profiling.kernel_family(name) == family


@pytest.mark.parametrize("cin,co", [(40, 16), (24, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dgrad_matches_pallas_packed_on_rot_t(cin, co, dtype):
    """The plain dx that the dgrad entry is held to on the card, against the
    Pallas conv3x3_packed of g with ``_rot_t(k)`` (ops/packed_row.py:310) at
    the entry's widths: dx Co 40 (a partial tile of 64) and 24 (of 32)."""
    n, h, w = 2, 6, 10
    rng = np.random.default_rng(cin * co)
    g = rng.normal(size=(n, h, w, co)).astype(np.float32)
    k = (0.1 * rng.normal(size=(3, 3, cin, co))).astype(np.float32)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    want = unpack_w(conv3x3_packed(
        pack_w(jnp.asarray(tg.float().numpy(), jnp.dtype(dtype))),
        _rot_t(jnp.asarray(k)), h=h, interpret=True,
        compute_dtype=jnp.bfloat16), h, cin)
    oihw = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = kb.conv3x3_dgrad_plain(tg, oihw, compute_dtype=torch.bfloat16)
    assert got.dtype == tg.dtype and got.shape == (n, h, w, cin)
    # Same rounded operands and exact products, float32 sums in another
    # order; a bf16 output may round one ulp apart (2^-8 relative).
    tol = (dict(atol=1e-4, rtol=1e-4) if dtype == "float32"
           else dict(atol=1e-2, rtol=2.0 ** -7))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
