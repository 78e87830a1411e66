"""The port's kernel modules (fabric_tpu_torch.ops) on the CPU: each plain
PyTorch version against the Pallas function it replaces (fabric_tpu,
interpret mode) in fp32, the double-conv gate, the weight packing and CPU
dispatch.  The kernels themselves are held against the plain versions on
the card by test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fabric_tpu.ops.pallas_conv import conv3x3_bias_relu as pallas_conv
from fabric_tpu.ops.pallas_double_conv import (
    double_conv3x3_bias_relu as pallas_double_conv)
from fabric_tpu.ops.pallas_fused import fused_mul_relu as pallas_fused

from fabric_tpu_torch.ops import conv, double_conv, fused
from fabric_tpu_torch.weights import block_channels

CONV_SHAPES = [
    (2, 16, 24, 8, 16),     # small, unaligned width/channels
    (1, 32, 33, 13, 64),    # first-layer channel count, odd width
    (1, 48, 128, 64, 64),
]
DOUBLE_SHAPES = [
    (2, 8, 8, 16, 32, 32),     # asymmetric channels
    (1, 12, 20, 8, 8, 16),     # non-square, non-pow2
    (5, 16, 16, 32, 32, 32),
    (3, 8, 8, 32, 32, 16),     # contracting output
    (1, 6, 6, 4, 4, 4),        # every pixel touches a border
]
FUSED_SHAPES = [(2, 17, 23, 64), (3, 7, 11, 5)]  # odd, not lane-aligned


def _conv_case(seed, n, h, w, cin, cout):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, cin).astype(np.float32),
            (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32),
            rng.randn(cout).astype(np.float32))


@pytest.mark.parametrize("n,h,w,cin,cout", CONV_SHAPES)
def test_conv_plain_matches_pallas(n, h, w, cin, cout):
    x, k, b = _conv_case(0, n, h, w, cin, cout)
    want = np.asarray(pallas_conv(jnp.asarray(x), jnp.asarray(k),
                                  jnp.asarray(b)))
    got = conv.conv3x3_bias_relu(*map(torch.from_numpy, (x, k, b)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", DOUBLE_SHAPES)
def test_double_conv_plain_matches_pallas(shape):
    n, h, w, cin, cmid, cout = shape
    rng = np.random.RandomState(0)
    args = [rng.randn(n, h, w, cin), rng.randn(3, 3, cin, cmid) * 0.1,
            rng.randn(cmid) * 0.1, rng.randn(3, 3, cmid, cout) * 0.1,
            rng.randn(cout) * 0.1]
    args = [a.astype(np.float32) for a in args]
    want = np.asarray(pallas_double_conv(*map(jnp.asarray, args)))
    got = double_conv.double_conv3x3_bias_relu(*map(torch.from_numpy, args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_plain_matches_pallas(shape):
    rng = np.random.RandomState(1)
    a, b = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    want = np.asarray(pallas_fused(jnp.asarray(a), jnp.asarray(b)))
    got = fused.fused_mul_relu(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# level: (N, side, Cin, Cout) of one 256-tile forward at patch 64, and the
# fused kernel's block plan there: (images per block, N split, ring slots)
LEVELS = {"inc": (512, 64, 13, 64), "down1": (512, 32, 64, 128),
          "down2": (512, 16, 128, 256), "down3": (512, 8, 256, 512),
          "down4": (512, 4, 512, 512), "up1": (256, 8, 1024, 256),
          "up2": (256, 16, 512, 128), "up3": (256, 32, 256, 64),
          "up4": (256, 64, 128, 64)}
PLANS = {"down2": (1, False, 3), "down3": (1, True, 4),
         "down4": (4, True, 3), "up1": (2, False, 4), "up2": (1, False, 4),
         "up3": (1, False, 4)}


def test_double_conv_gate_at_patch_64():
    """The fused kernel fits the deep blocks (a G x (H+2) x (W+2) x Cmid
    intermediate plus ring and patches within 227 KB) and not the full and
    half-resolution ones; the gate sends the blocks as planned."""
    for level, (_, side, cin, cout) in LEVELS.items():
        assert (block_channels(13, 64)[level]) == (cin, cout)
        p = double_conv.plan(side, side, cin, cout, cout)
        assert (p is not None) == (level in PLANS), level
        if p is not None:
            assert (p.group, p.split_n, p.stages) == PLANS[level], level
            assert p.smem == double_conv.smem_bytes(
                side, side, cout, cout, p.split_n, p.stages)
            assert p.smem <= double_conv.MAX_SMEM
            # one more ring slot would not fit
            if p.stages < 4:
                assert double_conv.smem_bytes(side, side, cout, cout,
                                              p.split_n, 4) > \
                    double_conv.MAX_SMEM
    fused_blocks = {level for level, (_, side, cin, cout) in LEVELS.items()
                    if double_conv.supports(side, side, cin, cout, cout)}
    # the measured gate: up3 (64 channels) runs faster as two conv launches
    assert fused_blocks == set(PLANS) - {"up3"}
    assert not double_conv.supports(8, 8, 8, 0, 8)


@pytest.mark.parametrize("h,w,rows,want", [
    (64, 64, 128, (6, 1, 0)), (32, 32, 128, (5, 2, 0)),
    (16, 16, 128, (4, 3, 0)), (8, 8, 128, (3, 3, 1)),
    (4, 4, 128, (2, 2, 3)), (4, 4, 64, (2, 2, 2)), (8, 8, 64, (3, 3, 0)),
    (1, 1, 128, (0, 0, 7)), (3, 5, 128, (3, 2, 2)), (7, 9, 128, (4, 3, 0)),
    (5, 300, 128, (7, 0, 0))])
def test_tile_width(h, w, rows, want):
    """An M chunk is NI whole images x TR rows x TW columns (log2s),
    TW >= W up to the chunk, TR >= H where it fits beside TW."""
    tw, tr, ni = conv.tile_geometry(h, w, rows)
    assert (tw, tr, ni) == want
    assert (1 << (tw + tr + ni)) == rows
    if ni:  # whole images: every row of the chunk is a pixel when H, W
        assert (1 << tw) >= w and (1 << tr) >= h  # are powers of two


def test_ragged_last_group():
    """N not a multiple of the images per tile: the last tile or block
    holds fewer images; the kernels mask the rest."""
    tw, tr, ni = conv.tile_geometry(4, 4)
    n = 13
    tiles = -(-n // (1 << ni))
    assert (1 << ni) == 8 and tiles == 2 and n - (tiles - 1) * 8 == 5
    p = double_conv.plan(4, 4, 512, 512, 512)
    assert p.group == 4 and -(-n // p.group) == 4


def test_conv_smem_at_main_path_shapes():
    """A conv block (4 ring slots of PN x 32 weights, two staged patches)
    leaves room for the blocks per SM the kernel asks for at every
    main-path shape: three at PN = 64, one at 128 (two would fit)."""
    for _, (_, side, _, cout) in LEVELS.items():
        per_sm = 3 if conv.n_tile(cout) == 64 else 2
        assert per_sm * conv.smem_bytes(side, side, cout) <= conv.MAX_SMEM
    assert conv.n_tile(2) == conv.n_tile(64) == 64
    assert conv.n_tile(65) == conv.n_tile(512) == 128


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: no build, no launch counted."""
    counts = (conv.conv3x3_bias_relu.launches,
              double_conv.double_conv3x3_bias_relu.launches,
              fused.fused_mul_relu.launches)
    x, k, b = map(torch.from_numpy, _conv_case(2, 1, 9, 7, 5, 6))
    conv.conv3x3_bias_relu(x, k, b)
    double_conv.double_conv3x3_bias_relu(x, k, b, torch.ones(3, 3, 6, 2),
                                         torch.ones(2))
    fused.fused_mul_relu(x, x)
    assert counts == (conv.conv3x3_bias_relu.launches,
                      double_conv.double_conv3x3_bias_relu.launches,
                      fused.fused_mul_relu.launches)


@pytest.mark.parametrize("cin,cout", [(13, 70), (64, 64), (40, 2),
                                       (48, 256)])
def test_packed_weight_layout(cin, cout):
    """pack_weight against the layout its docstring states, element by
    element, round-tripped to kernel.reshape(9, cin, cout); padding zero."""
    rng = np.random.RandomState(3)
    k = torch.from_numpy(rng.randn(3, 3, cin, cout).astype(np.float32))
    p = conv.pack_weight(k)
    pn = conv.n_tile(cout)
    cin16, coutp = -(-cin // 16) * 16, -(-cout // pn) * pn
    assert p.dtype == torch.bfloat16 and p.shape == (9 * cin16 * coutp,)
    tap, ci, co = np.meshgrid(np.arange(9), np.arange(cin), np.arange(cout),
                              indexing="ij")
    tile, n = co // pn, co % pn
    c0 = ci // conv.KC * conv.KC
    kc = np.minimum(conv.KC, cin16 - c0)
    kk = ci - c0
    idx = (tile * 9 * cin16 * pn + 9 * c0 * pn + tap * kc * pn
           + (n // 8) * kc * 8 + (kk // 8) * 64 + (n % 8) * 8 + kk % 8)
    got = p.float().numpy()[idx]
    want = k.reshape(9, cin, cout).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(idx)) == idx.size
    assert np.count_nonzero(np.delete(p.float().numpy(), idx.ravel())) == 0


def test_prepacked_call_matches_unpacked():
    """The packed weights change nothing on the CPU's plain path."""
    x, k, b = map(torch.from_numpy, _conv_case(4, 2, 6, 5, 16, 24))
    k2 = torch.from_numpy(_conv_case(5, 1, 1, 1, 24, 8)[1])
    b2 = torch.zeros(8)
    assert torch.equal(conv.conv3x3_bias_relu(x, k, b, conv.pack_weight(k)),
                       conv.conv3x3_bias_relu(x, k, b))
    packed = (conv.pack_weight(k), conv.pack_weight(k2))
    assert torch.equal(
        double_conv.double_conv3x3_bias_relu(x, k, b, k2, b2, packed),
        double_conv.double_conv3x3_bias_relu(x, k, b, k2, b2))


# ---- the float32 forms (rows 1 and 2 in fp32) ----

def _unpack_f32(p: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """pack_weight(k, float32) read back, element by element from the
    layout its docstring states: (plane, tap, Cin8, CoutP), plane 0 hi
    and 1 lo; block (tile, chunk, tap) at tile * 2*9*Cin8*PN + 2*9*c0*PN
    + tap * 2*kc*PN, its hi block then its lo block (kc*PN each), element
    (n, k) of a block at (n//8)*kc*8 + (k//4)*32 + (n%8)*4 + k%4."""
    pn = conv.n_tile(cout)
    cin8, coutp = -(-cin // 8) * 8, -(-cout // pn) * pn
    plane, tap, ci, co = np.meshgrid(np.arange(2), np.arange(9),
                                     np.arange(cin8), np.arange(coutp),
                                     indexing="ij")
    tile, n = co // pn, co % pn
    c0 = ci // 16 * 16
    kc = np.minimum(16, cin8 - c0)
    k = ci - c0
    idx = (tile * 2 * 9 * cin8 * pn + 2 * 9 * c0 * pn + tap * 2 * kc * pn
           + plane * kc * pn + (n // 8) * kc * 8 + (k // 4) * 32
           + (n % 8) * 4 + k % 4)
    assert p.numel() == idx.size and len(np.unique(idx)) == idx.size
    return p[torch.from_numpy(idx.reshape(-1))].reshape(2, 9, cin8, coutp)


@pytest.mark.parametrize("cin,cout", [(13, 70), (64, 64), (40, 2),
                                       (1024, 256)])
def test_f32_packed_weight_layout(cin, cout):
    """pack_weight(k, float32) is the split, padded block layout its
    docstring states: read back, the hi and lo planes are split_tf32 of
    the kernel bit for bit (hi + lo within 2^-21 of it), and the padding is
    zero."""
    rng = np.random.RandomState(4)
    k = torch.from_numpy(rng.randn(3, 3, cin, cout).astype(np.float32))
    p = conv.pack_weight(k, torch.float32)
    pn = conv.n_tile(cout)
    cin8, coutp = -(-cin // 8) * 8, -(-cout // pn) * pn
    assert p.dtype == torch.float32 and p.shape == (2 * 9 * cin8 * coutp,)
    assert torch.equal(p, conv.pack_weight_f32(k))
    conv.check_packed(p, k, torch.float32)
    grid = _unpack_f32(p, cin, cout)
    hi, lo = conv.split_tf32(k.reshape(9, cin, cout))
    assert torch.equal(grid[0, :, :cin, :cout], hi)
    assert torch.equal(grid[1, :, :cin, :cout], lo)
    whole = (grid[0] + grid[1])[:, :cin, :cout].double()
    assert ((whole - k.reshape(9, cin, cout).double()).abs()
            <= 2.0 ** -21 * k.reshape(9, cin, cout).double().abs()).all()
    pad = grid.clone()
    pad[:, :, :cin, :cout] = 0
    assert not pad.any()


# level: (images per cluster, conv1 N tiles per block, blocks per
# cluster, ring slots) of the fp32 fused kernel's plan at patch 64
F32_PLANS = {"down3": (2, 2, 2, 4), "down4": (8, 2, 2, 3),
             "up1": (2, 2, 1, 4)}


def test_f32_double_conv_gate_at_patch_64():
    """The fp32 fused kernel keeps a group of whole images (one 128-pixel
    M chunk: 8 of 4x4, 2 of 8x8) in a cluster of blocks, each holding 256
    of the intermediate's channels (two conv1 N tiles; four would not fit
    a chunk's images): it fits down3, down4 and up1 (228400-230720 B a
    block, under 227 KB), not the levels of 16x16 and larger images; the
    fp32 gate sends none of them to it (on the H100 it was slower than two
    conv launches at all three); the bf16 gate is unchanged."""
    for level, (_, side, cin, cout) in LEVELS.items():
        p = double_conv.plan_f32(side, side, cin, cout, cout)
        assert (p is not None) == (level in F32_PLANS), level
        assert double_conv.fits(side, side, cin, cout, cout,
                                torch.float32) == (p is not None)
        if p is None:
            continue
        assert (p.group, p.tiles1, p.cluster, p.stages) == F32_PLANS[level]
        assert p.group * side * side == 128 and p.pn1 == p.pn2 == 128
        assert p.cluster * p.tiles1 * p.pn1 == cout
        assert p.smem == double_conv.smem_bytes_f32(
            side, side, cout, cout, p.group, p.tiles1, p.stages)
        assert p.smem <= double_conv.MAX_SMEM
        # four tiles a block (down3, down4) would not hold the chunk's
        # images with 3 ring slots
        if cout >= 4 * 128:
            assert double_conv.smem_bytes_f32(
                side, side, cout, cout, p.group, 4, 3) > double_conv.MAX_SMEM
    assert double_conv.plan_f32(4, 4, 512, 512, 512).smem == 228400
    assert double_conv.plan_f32(8, 8, 1024, 256, 256).smem == 230720
    fused_blocks = {level for level, (_, side, cin, cout) in LEVELS.items()
                    if double_conv.supports(side, side, cin, cout, cout,
                                            torch.float32)}
    assert fused_blocks == set() and not double_conv.F32_FUSED_SHAPES
    assert double_conv.fits(4, 4, 64, 64, 64, torch.float32)
    assert not double_conv.supports(4, 4, 64, 64, 64, torch.float32)
    assert double_conv.plan_f32(16, 16, 8, 8, 8) is None  # 256 pixels
    # 4096 channels: a chunk's images in 8 blocks would need 4 tiles each
    assert double_conv.plan_f32(4, 4, 8, 4096, 8) is None


@pytest.mark.parametrize("n,h,w,cin,cout", CONV_SHAPES)
def test_conv_f32_form_matches_pallas(n, h, w, cin, cout):
    """The fp32 form's plain version (what a CPU tensor computes) against
    the Pallas kernel in fp32, at the bf16 form's tolerance."""
    x, k, b = _conv_case(6, n, h, w, cin, cout)
    want = np.asarray(pallas_conv(jnp.asarray(x), jnp.asarray(k),
                                  jnp.asarray(b)))
    got = conv.conv3x3_bias_relu(*map(torch.from_numpy, (x, k, b)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_f32_cpu_tensors_take_the_plain_versions():
    """fp32 CPU tensors compute the plain versions (no rounding but the
    fp32 sums) with or without fp32-packed weights, and count no launch;
    a packing of one dtype is refused as the other's."""
    counts = (conv.conv3x3_bias_relu.launches_f32,
              double_conv.double_conv3x3_bias_relu.launches_f32)
    x, k, b = map(torch.from_numpy, _conv_case(7, 2, 6, 5, 16, 24))
    k2, b2 = torch.ones(3, 3, 24, 8) / 50, torch.zeros(8)
    want = conv.conv3x3_bias_relu_reference(x, k, b)
    assert torch.equal(conv.conv3x3_bias_relu(x, k, b), want)
    assert torch.equal(conv.conv3x3_bias_relu(
        x, k, b, conv.pack_weight(k, torch.float32)), want)
    packed = (conv.pack_weight(k, torch.float32),
              conv.pack_weight(k2, torch.float32))
    two = conv.conv3x3_bias_relu_reference(want, k2, b2)
    assert torch.equal(double_conv.double_conv3x3_bias_relu(
        x, k, b, k2, b2, packed), two)
    assert torch.equal(double_conv.double_conv3x3_bias_relu_reference(
        x, k, b, k2, b2), two)
    assert counts == (conv.conv3x3_bias_relu.launches_f32,
                      double_conv.double_conv3x3_bias_relu.launches_f32)
    conv.check_packed(packed[0], k, torch.float32)
    with pytest.raises(ValueError):
        conv.check_packed(packed[0], k)
    with pytest.raises(ValueError):
        conv.check_packed(conv.pack_weight(k), k, torch.float32)
