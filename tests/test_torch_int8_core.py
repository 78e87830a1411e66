"""The int8 conv sites of the port (``ops/conv_s8.conv3x3_s8_q`` in every
mode, on the CPU its plain version) against ``fabric_tpu``'s own int8
helpers (``make_helpers``: ``conv_q``, ``enc_dc``, ``up_q``), the int8
core-matrix packing of the conv weights and of the GEMM's B, element by
element, and the int8 conv's tile planner.  Inputs from numpy seeds at
small shapes: 4x4 and 3x5 images, Cin 13, ragged Cout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.infer import quant as jq
from fabric_tpu.ops.resize import pad_to_match, upsample2x_align_corners

from fabric_tpu_torch.infer import quant as tq
from fabric_tpu_torch.ops import conv as conv_ops
from fabric_tpu_torch.ops import conv_s8
from fabric_tpu_torch.ops import int8_matmul as im

# the bf16 bound of test_torch_quant.test_int8_logits_match_fabric_tpu:
# XLA on the CPU may keep a chain of bf16 ops in float32 and round once
BF16_ATOL = 0.05
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (image side, H x W of the decoder's skip, Cin, Cout, skip channels)
CASES = [((4, 4), (8, 8), 13, 40, 13), ((3, 5), (7, 11), 16, 24, 24),
         ((4, 4), (9, 8), 64, 70, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _conv(rng, cin, cout):
    return {"kernel": (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin))
            .astype(np.float32),
            "bias": (rng.randn(cout) * 0.3).astype(np.float32)}


def _setup(seed, cin, cout, cs, dtype):
    """A folded tree of an encoder block (inc) and a decoder block (up1,
    conv1 split into skip / up halves of cs channels), activation scales
    that round and clip, fabric_tpu's helpers and the port's weights."""
    rng = np.random.RandomState(seed)
    folded = {"inc": {"conv1": _conv(rng, cin, cout),
                      "conv2": _conv(rng, cout, cout)},
              "up1": {"conv": {"conv1": _conv(rng, 2 * cs, cout),
                               "conv2": _conv(rng, cout, cout)}}}
    scales = {"inc.conv1": 0.021, "inc.conv2": 0.012, "up1.conv1": 0.037,
              "up1.conv2": 0.013, "f4": 0.017, "out": 0.031}
    qw = jq.quantize_weights(folded)
    helpers = jq.make_helpers(folded, qw, scales, DTYPES[dtype][0],
                              upsample2x=upsample2x_align_corners)
    w = {name: {f: torch.from_numpy(np.asarray(v)) for f, v in p.items()}
         for name, p in tq.quantize_weights(folded).items()}
    return helpers, w, scales, rng


def _s8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _site(w, name, x, sx, s_out, tdt, up=None, bias=None):
    p = w[name]
    return conv_s8.conv3x3_s8_q(torch.from_numpy(x), p["wq"], p["sw"] * sx,
                                p["bias"] if bias is None else bias, s_out,
                                None, up, tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side,skip,cin,cout,cs", CASES)
def test_site_matches_conv_q(side, skip, cin, cout, cs, dtype):
    """One site, int8 out (bit-equal to q(relu(conv_q))) and compute-dtype
    out (relu(conv_q), the end of up_q)."""
    H, w, s, rng = _setup(cin + cout, cin, cout, cs, dtype)
    tdt = DTYPES[dtype][1]
    x = _s8(rng, 3, *side, cin)
    sx, s_out = s["inc.conv1"], s["inc.conv2"]
    want_q = np.asarray(jax.jit(lambda x: H.q(jnp.maximum(
        H.conv_q(x, sx, "inc.conv1"), 0), s_out))(x))
    want_h = np.asarray(jax.jit(lambda x: jnp.maximum(
        H.conv_q(x, sx, "inc.conv1"), 0))(x)).astype(np.float32)
    got_q = _site(w, "inc.conv1", x, sx, s_out, tdt)
    got_h = _site(w, "inc.conv1", x, sx, None, tdt)
    assert got_q.dtype == torch.int8 and got_q.shape == (3, *side, cout)
    assert got_h.dtype == tdt and got_h.shape == (3, *side, cout)
    assert 0 < np.count_nonzero(want_q == 127) < want_q.size  # clips
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    err = np.abs(got_h.float().numpy() - want_h).max()
    assert err <= (0 if dtype == "float32" else BF16_ATOL), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side,skip,cin,cout,cs", CASES)
def test_two_sites_match_enc_dc(side, skip, cin, cout, cs, dtype):
    """The encoder block: two int8-out sites, bit-equal to enc_dc."""
    H, w, s, rng = _setup(cin * cout, cin, cout, cs, dtype)
    tdt = DTYPES[dtype][1]
    x = _s8(rng, 2, *side, cin)
    want = np.asarray(jax.jit(lambda x: H.enc_dc(
        x, s["inc.conv1"], "inc", s["inc.conv2"], s["out"]))(x))
    h = _site(w, "inc.conv1", x, s["inc.conv1"], s["inc.conv2"], tdt)
    got = _site(w, "inc.conv2", h.numpy(), s["inc.conv2"], s["out"], tdt)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side,skip,cin,cout,cs", CASES)
def test_split_site_matches_up_q(side, skip, cin, cout, cs, dtype):
    """The decoder block: the split form (skip x K_skip + q(u) x K_up, two
    scales) bit-equal to up_q's lines before its conv2, and the block's
    output (split site, then a compute-dtype site) against up_q."""
    H, w, s, rng = _setup(cin + 2 * cs, cin, cout, cs, dtype)
    jdt, tdt = DTYPES[dtype]
    skip_q = _s8(rng, 2, *skip, cs)
    y = jnp.asarray(rng.rand(2, *side, cs).astype(np.float32) * 3, jdt)
    # u as up_q forms it, handed to both sides
    u = np.array(pad_to_match(upsample2x_align_corners(y), *skip)
                   .astype(jnp.float32))
    s_skip, s_u, s_mid = s["f4"], s["up1.conv1"], s["up1.conv2"]

    def split_ref(skip_q, u):
        sw_s = np.asarray(w["up1.conv1.skip"]["sw"])
        sw_u = np.asarray(w["up1.conv1.up"]["sw"])
        bias = np.asarray(w["up1.conv1"]["bias"])
        h = (H.conv_raw(skip_q, "up1.conv1.skip").astype(jnp.float32)
             * (sw_s * s_skip)
             + H.conv_raw(H.q(u.astype(jdt), s_u), "up1.conv1.up")
             .astype(jnp.float32) * (sw_u * s_u) + bias)
        return H.q(jnp.maximum(h, 0.0).astype(jdt), s_mid)

    want = np.asarray(jax.jit(split_ref)(skip_q, u))
    up = (conv_s8.quantize(torch.from_numpy(u).to(tdt), s_u),
          w["up1.conv1.up"]["wq"], w["up1.conv1.up"]["sw"] * s_u, None)
    got = _site(w, "up1.conv1.skip", skip_q, s_skip, s_mid, tdt, up,
                w["up1.conv1"]["bias"])
    assert got.dtype == torch.int8 and got.shape == (2, *skip, cout)
    np.testing.assert_array_equal(got.numpy(), want)

    want_out = np.asarray(jax.jit(lambda y, k: H.up_q(y, k, s_skip, "up1"))(
        y, skip_q)).astype(np.float32)
    out = _site(w, "up1.conv2", got.numpy(), s_mid, None, tdt)
    err = np.abs(out.float().numpy() - want_out).max()
    assert err <= (1e-5 if dtype == "float32" else BF16_ATOL), err


@pytest.mark.parametrize("cin,cout", [(13, 70), (64, 64), (40, 2),
                                       (96, 256), (512, 128)])
def test_conv_s8_packed_weight_layout(cin, cout):
    """conv_s8.pack_weight against the layout its docstring states, element
    by element; padding zero."""
    rng = np.random.RandomState(cin + cout)
    wq = torch.from_numpy(_s8(rng, 3, 3, cin, cout))
    p = conv_s8.pack_weight(wq)
    pn = conv_ops.n_tile(cout)
    cin32, coutp = -(-cin // 32) * 32, -(-cout // pn) * pn
    assert p.dtype == torch.int8 and p.shape == (9 * cin32 * coutp,)
    tap, ci, co = np.meshgrid(np.arange(9), np.arange(cin), np.arange(cout),
                              indexing="ij")
    tile, n = co // pn, co % pn
    c0 = ci // conv_s8.KB * conv_s8.KB
    kc = np.minimum(conv_s8.KB, cin32 - c0)
    kk = ci - c0
    idx = (tile * 9 * cin32 * pn + 9 * c0 * pn + tap * kc * pn
           + (n // 8) * kc * 8 + (kk // 16) * 128 + (n % 8) * 16 + kk % 16)
    np.testing.assert_array_equal(p.numpy()[idx],
                                  wq.reshape(9, cin, cout).numpy())
    assert len(np.unique(idx)) == idx.size
    assert np.count_nonzero(np.delete(p.numpy(), idx.ravel())) == 0


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(512, 512), (13, 70), (200, 64),
                                 (130, 33)])
def test_matmul_packed_b_layout(k, n, dtype):
    """int8_matmul.pack_b against the layout its docstring states, element
    by element; padding zero."""
    rng = np.random.RandomState(k + n)
    b = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.float32)
                         ).to(dtype)
    p = im.pack_b(b)
    es = b.element_size()
    pn, chunk, v = conv_ops.n_tile(n), im.KB // es, 16 // es
    kpad, npad = im.kpad(k, es), -(-n // pn) * pn
    assert kpad % chunk == 0 and kpad >= k
    assert p.dtype == dtype and p.shape == (kpad * npad,)
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    tile, col = nn // pn, nn % pn
    c0, kr = kk // chunk * chunk, kk % chunk
    idx = (tile * kpad * pn + c0 * pn + (col // 8) * chunk * 8
           + (kr // v) * 8 * v + (col % 8) * v + kr % v)
    np.testing.assert_array_equal(p.float().numpy()[idx], b.float().numpy())
    assert len(np.unique(idx)) == idx.size
    assert np.count_nonzero(np.delete(p.float().numpy(), idx.ravel())) == 0


def _forward_shapes():
    """(site, N, side, Cin (of each segment), Cout, mode) of the 18 conv
    launches of one int8 forward of 256 tiles at patch 64, full width."""
    from fabric_tpu_torch.weights import block_channels
    side = {"inc": 1, "down1": 2, "down2": 4, "down3": 8, "down4": 16,
            "up1": 8, "up2": 4, "up3": 2, "up4": 1}
    out = []
    for level, (cin, cout) in block_channels(13, 64).items():
        s = 64 // side[level]
        if level.startswith("up"):
            out += [(f"{level}.conv1", 256, s, cin // 2, cout, "split"),
                    (f"{level}.conv2", 256, s, cout, cout, "bf16")]
        else:
            out += [(f"{level}.conv1", 512, s, cin, cout, "int8"),
                    (f"{level}.conv2", 512, s, cout, cout, "int8")]
    return out


def test_int8_planner_at_the_forward_shapes():
    """All 18 launches of a full-width forward fit 227 KB a block, their
    blocks per SM fit the SM's shared memory, and the plan packs whole
    small images: 8 of 4x4, 2 of 8x8 per 128-pixel tile."""
    shapes = _forward_shapes()
    assert [mode for *_, mode in shapes].count("split") == 4
    for site, _, s, _, cout, mode in shapes:
        p = conv_s8.plan(s, s, cout, mode)
        assert p.smem <= conv_ops.MAX_SMEM, site
        assert p.blocks_per_sm * (p.smem + 1024) <= 233472, site
        assert p.pn == (64 if cout <= 64 else 128), site
        assert p.blocks_per_sm == (1 if p.pn == 128 else
                                   2 if mode == "split" else 3), site
        assert (1 << p.tw) * (1 << p.tr) * p.images == 128, site
        assert p.images == {4: 8, 8: 2}.get(s, 1), site


def test_cpu_int8_sites_take_the_plain_versions():
    """On CPU tensors the wrappers compute the plain versions and count no
    launch."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(_s8(rng, 2, 4, 4, 13))
    wq = torch.from_numpy(_s8(rng, 3, 3, 13, 24))
    k = torch.from_numpy(rng.rand(24).astype(np.float32) * 1e-3)
    b = torch.from_numpy(rng.randn(24).astype(np.float32))
    before = (conv_s8.conv3x3_s8.launches, conv_s8.conv3x3_s8_q.launches)
    assert torch.equal(conv_s8.conv3x3_s8_q(x, wq, k, b, 0.05),
                       conv_s8.conv3x3_s8_q_reference(x, wq, k, b, 0.05))
    assert torch.equal(conv_s8.conv3x3_s8(x, wq),
                       conv_s8.conv3x3_s8_reference(x, wq))
    assert (conv_s8.conv3x3_s8.launches,
            conv_s8.conv3x3_s8_q.launches) == before


def test_cpu_int8_f32_sites_take_the_plain_versions():
    """The float32 compute dtype's sites (conv3x3_s8_q at float32) compute the
    plain version at float32 on CPU tensors, in every form (float32 out,
    int8 out, split), and count no launch; their launch plan is the bf16
    form's."""
    rng = np.random.RandomState(10)
    x = torch.from_numpy(_s8(rng, 2, 4, 4, 13))
    wq = torch.from_numpy(_s8(rng, 3, 3, 13, 24))
    k = torch.from_numpy(rng.rand(24).astype(np.float32) * 1e-3)
    b = torch.from_numpy(rng.randn(24).astype(np.float32))
    up = (x.flip(0).contiguous(), wq.flip(3).contiguous(), k * 0.5, None)
    before = (conv_s8.conv3x3_s8_q.launches,
              conv_s8.conv3x3_s8_q.launches_f32)
    for s_out, u in ((None, None), (0.05, None), (0.05, up)):
        got = conv_s8.conv3x3_s8_q(x, wq, k, b, s_out, None, u,
                                   torch.float32)
        want = conv_s8.conv3x3_s8_q_reference(x, wq, k, b, s_out, u,
                                              torch.float32)
        assert got.dtype == (torch.float32 if s_out is None else torch.int8)
        assert torch.equal(got, want)
    # no bf16 step: the float32 h is the epilogue's value itself
    h = conv_s8.conv3x3_s8_q(x, wq, k, b, dtype=torch.float32)
    a = conv_s8.conv3x3_s8_reference(x, wq).float()
    assert torch.equal(h, torch.relu(torch.addcmul(b, a, k)))
    assert (conv_s8.conv3x3_s8_q.launches,
            conv_s8.conv3x3_s8_q.launches_f32) == before
    for bf16, f32 in (("int8", "int8_f32"), ("bf16", "float32"),
                      ("split", "split_f32")):
        assert conv_s8.plan(4, 4, 64, f32) == conv_s8.plan(4, 4, 64, bf16)
