"""Kernels A and C (instance norm + act, forward and backward) as the
persistent kernels of csrc/instance_norm_act.cu compute them: their slab plan
(``launch_plan``), and a torch emulation of their arithmetic over that plan
(per-thread Welford or sums over each pixel lane, the block's fixed merge
tree, the warp's fixed-order merge of the blocks' partials, the per-(n, c)
coefficients) held to the plain versions and, at one small shape, to the
Pallas kernel in interpret mode. The CUDA kernels themselves are held to the
plain versions on the card by chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.ops.pallas.instance_norm import (
    instance_norm_act as pallas_instance_norm_act,
)

from tactile_gan_torch.ops.kernels import instance_norm as ka
from tactile_gan_torch.utils import profiling

torch.set_num_threads(2)

# (H, W, C) of kernel A and C on the UNet++ nf=64 path at 256x256.
MAIN_SHAPES = [(256, 256, 64), (128, 128, 128), (64, 64, 256), (32, 32, 512),
               (16, 16, 1024)]
# chip_smoke.py's first EDGE_A shapes (N, H, W, C); C 12 and 20 reach the
# kernels padded to 16 and 24.
EDGE_SHAPES = [(3, 7, 5, 24), (2, 9, 13, 136), (1, 1, 1, 8), (2, 9, 13, 12),
               (3, 5, 7, 20)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DIRECTIONS = {"A": 1, "C": 2}  # inputs kept a pixel: x, or x and g


def _plan_cases():
    cases = []
    for n in (1, 4):
        for h, w, c in MAIN_SHAPES:
            cases.append((n, h * w, c))
    for n, h, w, c in EDGE_SHAPES:
        cases.append((n, h * w, c + (-c) % 8))
    # chip_smoke.py's slab edges: a share larger than shared memory in both
    # directions (512^2 x 64), several slabs (batch 8 at 128^2 x 128), a
    # batch of 1x1 images.
    cases += [(1, 512 * 512, 64), (8, 128 * 128, 128), (5, 1, 32)]
    return cases


def _check_plan(n, hw, c, dtype, inputs, sms=ka.H100_SMS):
    plan = ka.launch_plan(n, hw, c, dtype, inputs, sms)
    itemsize = dtype.itemsize
    vec = 16 // itemsize
    red = ka._THREADS * (2 * vec + 1) * 4
    assert plan.grid == plan.ips * plan.bpi <= sms
    assert plan.resident + plan.streamed == plan.share
    assert 0 <= plan.resident <= plan.share
    assert red + plan.resident * c * itemsize * inputs <= plan.smem
    assert plan.smem <= ka.SMEM_MAX == 227 * 1024
    assert plan.lanes * min(c // vec, ka._THREADS) <= ka._THREADS
    # Every (image, pixel) once: block (slot, j) of slab s takes pixels
    # [j * share, (j + 1) * share) of image s * ips + slot, never another
    # image's, and no block is left without pixels.
    assert (plan.bpi - 1) * plan.share < hw <= plan.bpi * plan.share
    seen = np.zeros((n, hw), np.int64)
    for s in range(-(-n // plan.ips)):
        for block in range(plan.grid):
            img = s * plan.ips + block // plan.bpi
            j = block % plan.bpi
            if img < n:
                seen[img, j * plan.share:(j + 1) * plan.share] += 1
    assert (seen == 1).all()
    return plan


@pytest.mark.parametrize("n,hw,c", _plan_cases())
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_slab_plan_covers_every_pixel_once(n, hw, c, dtype, direction):
    _check_plan(n, hw, c, DTYPES[dtype], DIRECTIONS[direction])


def test_slab_plan_streams_only_where_an_image_does_not_fit():
    """On the main path only C at 256^2 x 64 in float32 streams a part (its
    x and g need 254 KB a block); 512^2 x 64 streams in both directions."""
    streaming = set()
    for n in (1, 4):
        for h, w, c in MAIN_SHAPES:
            for dname, dt in DTYPES.items():
                for direction, inputs in DIRECTIONS.items():
                    plan = ka.launch_plan(n, h * w, c, dt, inputs)
                    if plan.streamed:
                        assert plan.ips == 1  # a slab is one image
                        streaming.add((direction, n, h, c, dname))
    assert streaming == {("C", 1, 256, 64, "float32"),
                         ("C", 4, 256, 64, "float32")}
    plan = ka.launch_plan(4, 256 * 256, 64, torch.float32, 2)
    assert (plan.share, plan.resident, plan.streamed) == (497, 418, 79)
    for inputs in (1, 2):
        assert ka.launch_plan(1, 512 * 512, 64, torch.float32,
                              inputs).streamed > 0


def test_slab_plan_takes_whole_images_and_evens_the_slabs():
    # The deep rows fit whole: one slab for the batch, one launch.
    assert ka.launch_plan(4, 16 * 16, 1024, torch.float32, 2).ips == 4
    # Three images of 128^2 x 128 would fit a slab, so six take two even
    # slabs of three; five take two slabs of three (the last one short).
    assert ka.launch_plan(6, 128 * 128, 128, torch.float32, 1).ips == 3
    assert ka.launch_plan(5, 128 * 128, 128, torch.float32, 1).ips == 3
    # A batch of 1x1 images: one block an image, one slab.
    plan = ka.launch_plan(5, 1, 32, torch.float32, 1)
    assert (plan.ips, plan.bpi, plan.share, plan.grid) == (5, 1, 1, 5)
    # Fewer SMs (an H100 PCIe part has 114) give a smaller grid.
    assert ka.launch_plan(1, 256 * 256, 64, torch.float32, 1, 114).grid == 114


# ---------------------------------------------------------------------------
# The kernels' arithmetic, emulated in float32 torch over the plan.
# ---------------------------------------------------------------------------

def _chan(na, ma, qa, nb, mb, qb):
    """Chan's merge of (nb, mb, qb) into (na, ma, qa), skipped where nb is
    0, as csrc chan_merge."""
    n = na + nb
    f = nb * (1.0 / torch.where(n > 0, n, torch.ones_like(n)))
    d = mb - ma
    keep = nb == 0
    return (torch.where(keep, na, n), torch.where(keep, ma, ma + d * f),
            torch.where(keep, qa, qa + (qb + d * d * na * f)))


def _lanes(x, plan):
    """x (N, HW, C) float32 -> (N, bpi, steps, lanes, C) and the valid
    mask (bpi, steps, lanes): pixel q = step * lanes + lane of block j is
    pixel j * share + q of the image, as a block's threads walk it."""
    n, hw, c = x.shape
    steps = -(-plan.share // plan.lanes)
    per = steps * plan.lanes
    pad = plan.bpi * plan.share - hw
    xp = torch.cat([x, x.new_zeros(n, pad, c)], 1).reshape(
        n, plan.bpi, plan.share, c)
    xp = torch.cat([xp, xp.new_zeros(n, plan.bpi, per - plan.share, c)], 2)
    q = torch.arange(per).reshape(steps, plan.lanes)
    j = torch.arange(plan.bpi)[:, None, None]
    valid = (q[None] < plan.share) & (j * plan.share + q[None] < hw)
    return xp.reshape(n, plan.bpi, steps, plan.lanes, c), valid


def _tree(vals, lanes, merge):
    """The block's merge tree: lane l takes lane l + s for s = P/2, ..., 1
    (P the power of two >= lanes); ``vals`` are (.., lanes, ..) tensors
    with the lane on axis 2."""
    pw = 1
    while pw < lanes:
        pw *= 2
    s = pw // 2
    while s > 0:
        k = min(s, lanes - s)
        if k > 0:
            merged = merge([v[:, :, :k] for v in vals],
                           [v[:, :, s:s + k] for v in vals])
            vals = [torch.cat([m, v[:, :, k:]], 2)
                    for m, v in zip(merged, vals)]
        s //= 2
    return [v[:, :, 0] for v in vals]


def _warp(parts, merge):
    """The warp per (image, channel): lane l takes the blocks l, l + 32, ...
    in order, then a butterfly over the 32 lanes; lane 0's result.
    ``parts``: (N, bpi, C) tensors."""
    n, bpi, c = parts[0].shape
    rounds = -(-bpi // 32)
    padded = [torch.cat([p, p.new_zeros(n, rounds * 32 - bpi, c)], 1)
              .reshape(n, rounds, 32, c) for p in parts]
    acc = [p[:, 0] * 0 for p in padded]
    for r in range(rounds):
        acc = merge(acc, [p[:, r] for p in padded])
    for o in (16, 8, 4, 2, 1):
        perm = torch.arange(32) ^ o
        acc = merge(acc, [a[:, perm] for a in acc])
    return [a[:, 0] for a in acc]


def emulate_forward(x, weight, bias, act, slope, sms=ka.H100_SMS):
    """Kernel A's arithmetic: (y, stats (N, C, 2))."""
    n, h, w, c = x.shape
    plan = ka.launch_plan(n, h * w, c, x.dtype, 1, sms)
    xb, valid = _lanes(x.float().reshape(n, h * w, c), plan)
    cnt = torch.zeros(1, plan.bpi, plan.lanes, 1)
    mean = torch.zeros(n, plan.bpi, plan.lanes, c)
    m2 = torch.zeros_like(mean)
    for s in range(xb.shape[2]):  # each thread's Welford over its pixels
        ok = valid[None, :, s, :, None]
        v = xb[:, :, s]
        c_new = cnt + ok.float()
        d = v - mean
        mean_new = mean + d * (1.0 / torch.where(ok, c_new, 1.0))
        m2 = torch.where(ok, m2 + d * (v - mean_new), m2)
        mean = torch.where(ok, mean_new, mean)
        cnt = c_new
    cnt = cnt.expand(n, -1, -1, c)
    bn, bm, bq = _tree([cnt, mean, m2], plan.lanes,
                       lambda a, b: list(_chan(*a, *b)))
    _, mu, q = _warp([bn, bm, bq], lambda a, b: list(_chan(*a, *b)))
    rstd = torch.rsqrt(q / (h * w) + ka.EPS)
    s = torch.ones(c) if weight is None else weight.float()
    o = torch.zeros(c) if bias is None else bias.float()
    z = (x.float() - mu[:, None, None]) * (rstd * s)[:, None, None] + o
    y = ka._activate(z, act, slope).to(x.dtype)
    return y, torch.stack([mu, rstd], -1)


def emulate_backward(x, g, stats, weight, bias, act, slope,
                     sms=ka.H100_SMS):
    """Kernel C's arithmetic: (dx, dscale, doffset)."""
    n, h, w, c = x.shape
    hw = h * w
    plan = ka.launch_plan(n, hw, c, x.dtype, 2, sms)
    s = torch.ones(c) if weight is None else weight.float()
    o = torch.zeros(c) if bias is None else bias.float()
    mean, rstd = stats[..., 0], stats[..., 1]

    def dz_xhat(xv, gv, mu, r):
        xh = (xv - mu) * r
        z = xh * s + o
        if act == "relu":
            dz = torch.where(z > 0, gv, torch.zeros_like(gv))
        elif act == "leaky_relu":
            dz = torch.where(z >= 0, gv, gv * slope)
        else:
            dz = gv
        return dz, xh

    xb, valid = _lanes(x.float().reshape(n, hw, c), plan)
    gb, _ = _lanes(g.float().reshape(n, hw, c), plan)
    sdz = torch.zeros(n, plan.bpi, plan.lanes, c)
    sdzx = torch.zeros_like(sdz)
    for st in range(xb.shape[2]):
        ok = valid[None, :, st, :, None]
        dz, xh = dz_xhat(xb[:, :, st], gb[:, :, st], mean[:, None, None],
                         rstd[:, None, None])
        sdz = torch.where(ok, sdz + dz, sdz)
        sdzx = torch.where(ok, sdzx + dz * xh, sdzx)
    add = lambda a, b: [u + v for u, v in zip(a, b)]  # noqa: E731
    bdz, bdzx = _tree([sdz, sdzx], plan.lanes, add)
    doff, dsc = _warp([bdz, bdzx], add)
    dz, xh = dz_xhat(x.float(), g.float(), mean[:, None, None],
                     rstd[:, None, None])
    m1 = (doff * s / hw)[:, None, None]
    m2 = (dsc * s / hw)[:, None, None]
    dx = rstd[:, None, None] * (dz * s - m1 - xh * m2)
    return dx.to(g.dtype), dsc.sum(0), doff.sum(0)


# (N, H, W, C, sms): several lanes a block, several blocks an image and
# several images a slab at the card's 132 SMs; with 4 or 7 SMs a lane walks
# many pixels and the warp merges fewer blocks than its lanes.
EMU_SHAPES = [(2, 12, 12, 16, ka.H100_SMS), (3, 9, 13, 24, ka.H100_SMS),
              (1, 16, 16, 136, 7), (2, 20, 20, 64, 4), (1, 1, 1, 8, 4)]


def _inputs(shape, seed, loc=0.5, scale=2.0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * scale + loc).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    s = (1 + 0.3 * rng.normal(size=(c,))).astype(np.float32)
    o = (0.3 * rng.normal(size=(c,))).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, g, s, o)]


# float32: the emulation's and the plain version's sums over at most 400
# pixels an (image, channel) in another order (a few float32 ulps of unit-
# scale values); bfloat16: one rounding of the output on each side.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-2, rtol=2.0 ** -6)}


@pytest.mark.parametrize("n,h,w,c,sms", EMU_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ["relu", "leaky_relu", None])
def test_emulated_forward_matches_plain(n, h, w, c, sms, dtype, act):
    x, _, s, o = _inputs((n, h, w, c), 5)
    x = x.to(DTYPES[dtype])
    y, stats = emulate_forward(x, s, o, act, 0.2, sms)
    want = ka.instance_norm_act_plain(x, s, o, act=act)
    assert y.dtype == x.dtype
    torch.testing.assert_close(y.float(), want.float(), **TOL[dtype])
    # (mean, rstd): float32 statistics of the same inputs whatever the
    # dtype; rstd reaches 1/sqrt(eps) at a single pixel (zero variance).
    torch.testing.assert_close(stats, ka.instance_norm_stats_plain(x),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,h,w,c,sms", EMU_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ["relu", "leaky_relu", None])
def test_emulated_backward_matches_plain(n, h, w, c, sms, dtype, act):
    x, g, s, o = _inputs((n, h, w, c), 6)
    x, g = x.to(DTYPES[dtype]), g.to(DTYPES[dtype])
    stats = ka.instance_norm_stats_plain(x)
    got = emulate_backward(x, g, stats, s, o, act, 0.2, sms)
    want = ka.instance_norm_act_backward_plain(x, g, stats, s, o, act=act)
    assert got[0].dtype == g.dtype
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    # dscale, doffset: float32 sums of up to 1,200 terms of unit scale.
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("sms", [ka.H100_SMS, 5])
def test_emulated_statistics_survive_a_large_mean(sms):
    """|mean| / std = 512: Welford per lane and Chan's merges keep the
    two-pass variance, where E[x^2] - mean^2 in float32 cancels to a few
    per cent of it."""
    x, _, s, o = _inputs((2, 24, 24, 16), 7, loc=256.0, scale=0.5)
    stats_plain = ka.instance_norm_stats_plain(x)
    y, stats = emulate_forward(x, s, o, "relu", 0.2, sms)
    var = stats[..., 1] ** -2 - ka.EPS
    var_plain = stats_plain[..., 1] ** -2 - ka.EPS
    torch.testing.assert_close(var, var_plain, atol=0.0, rtol=1e-4)
    torch.testing.assert_close(stats[..., 0], stats_plain[..., 0], atol=0.0,
                               rtol=1e-6)
    # The outputs: the two means may part by a few ulps of 256 (2^-15
    # each; sums in another order), which y scales by rstd * s.
    atol = 4 * 2.0 ** -15 * (stats_plain[..., 1, None] * s).abs().max().item()
    torch.testing.assert_close(y, ka.instance_norm_act_plain(
        x, s, o, act="relu"), atol=atol, rtol=1e-5)
    # The data really cancels single-pass: E[x^2] - m^2 misses by > 1%.
    x64 = x.reshape(2, -1, 16)
    single = (x64 * x64).mean(1) - x64.mean(1) ** 2
    assert ((single - var_plain).abs() / var_plain).max() > 1e-2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_emulated_kernels_match_pallas(dtype):
    """At one small shape (3 images of 10x10 x 24 channels, 3 per slab, 100
    blocks an image on 132 SMs... here 4 SMs: one block an image, many
    pixels a lane) the emulated A and C against the Pallas
    instance_norm_act forward and VJP in interpret mode."""
    x, g, s, o = _inputs((3, 10, 10, 24), 8, loc=1.0, scale=3.0)
    if dtype == "bfloat16":
        x, g = x.bfloat16().float(), g.bfloat16().float()
    tdt = DTYPES[dtype]
    jdt = jnp.dtype(dtype)
    jx, jg = jnp.asarray(x.numpy(), jdt), jnp.asarray(g.numpy(), jdt)
    want_y, vjp = jax.vjp(lambda a, b, d: pallas_instance_norm_act(
        a, b, d, act="relu", interpret=True), jx, jnp.asarray(s.numpy()),
        jnp.asarray(o.numpy()))
    want = [np.asarray(v, np.float32) for v in vjp(jg)]
    tx, tg = x.to(tdt), g.to(tdt)
    for sms in (ka.H100_SMS, 4):
        y, stats = emulate_forward(tx, s, o, "relu", 0.2, sms)
        got = emulate_backward(tx, tg, stats, s, o, "relu", 0.2, sms)
        # float32: the Pallas kernel's single-pass statistics (|mean| / std
        # 1/3) against the emulated two-pass ones, sums in another order;
        # bfloat16: one output rounding on each side. dscale and doffset are
        # float32 sums of 300 terms.
        tol = (TOL["bfloat16"] if dtype == "bfloat16"
               else dict(atol=5e-5, rtol=1e-4))
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want_y, np.float32), **tol)
        np.testing.assert_allclose(got[0].float().numpy(), want[0], **tol)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=1e-4)


def test_kernel_names_map_to_their_profile_families():
    names = {
        "void (anonymous namespace)::in_act_fwd_kernel<float>(...)":
            "kernel_a",
        "void (anonymous namespace)::in_act_fwd_kernel<__nv_bfloat16>(...)":
            "kernel_a",
        "void (anonymous namespace)::in_act_bwd_kernel<float>(...)":
            "kernel_c",
        "void (anonymous namespace)::in_act_bwd_kernel<__nv_bfloat16>(...)":
            "kernel_c",
        # whole identifiers only: PyTorch's own kernels stay "other"
        "void at::native::vectorized_elementwise_kernel<4, ...>(...)": "other",
        "void at::native::multi_tensor_apply_kernel<...>(...)": "other",
        "void my_in_act_fwd_kernel_v2<float>(...)": "other"}
    for name, family in names.items():
        assert profiling.kernel_family(name) == family, name
