"""Space-to-depth lane packing in the port (fabric_tpu_torch/ops/s2d_conv.py
and cfg.lane_pack / lane_pack_bwd in the models and the loop) against
fabric_tpu's on the CPU, fp32, on seeded numpy inputs.  Tolerances are
tests/test_s2d_conv.py's: 2e-5 absolute / 1e-5 relative for the forwards,
5e-3 / 1e-4 for the gradients; the models' logits 5e-4 / 1e-4 (its
lane_pack against direct), one train step PR 10's 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabric_tpu import config as jax_config
from fabric_tpu import losses as jax_losses
from fabric_tpu.models import build_model as jax_build_model
from fabric_tpu.ops import s2d_conv as jax_s2d
from fabric_tpu.train.state import create_state as jax_create_state
from fabric_tpu.train.steps import make_train_step as jax_make_train_step

from fabric_tpu_torch import config, losses, weights
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.ops import s2d_conv
from fabric_tpu_torch.train.state import create_state
from fabric_tpu_torch.train.steps import make_train_step

BASE, SIDE = 8, 96   # the gate packs Cout < 128 at sides >= 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("cin,cout,h", [(13, 16, 8), (16, 16, 12),
                                        (32, 16, 10), (5, 8, 16)])
def test_s2d_conv3x3_matches_fabric_tpu(cin, cout, h):
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, h + 2 if h % 4 else h, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    want = jax_s2d.s2d_conv3x3(jnp.asarray(x), jnp.asarray(k),
                               jnp.asarray(b), relu=True)
    close(s2d_conv.s2d_conv3x3(t(x), t(k), t(b), relu=True), want,
          2e-5, 1e-5)


def test_layout_shuffles_equal_fabric_tpu():
    """s2d, reshift, d2s and the packed kernel move values only: equal."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 12, 3).astype(np.float32)
    k = rng.randn(3, 3, 3, 5).astype(np.float32)
    for got, want in (
            (s2d_conv.s2d(t(x)), jax_s2d.s2d(jnp.asarray(x))),
            (s2d_conv.reshift(t(x[:, :, :, :2].repeat(2, -1)), 1),
             jax_s2d.reshift(jnp.asarray(x[:, :, :, :2].repeat(2, -1)), 1)),
            (s2d_conv.d2s(t(x[..., :2].repeat(2, -1)), 1),
             jax_s2d.d2s(jnp.asarray(x[..., :2].repeat(2, -1)), 1)),
            (s2d_conv.pack_kernel(t(k)), jax_s2d.pack_kernel(
                jnp.asarray(k)))):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("split", [False, True])
def test_s2d_double_conv_matches_fabric_tpu(split):
    """The chained pair, and the split-concat form (``extra``)."""
    rng = np.random.RandomState(1 + split)
    cin = 16 if split else 9
    x = rng.randn(2, 12, 16, cin).astype(np.float32)
    k1 = (rng.randn(3, 3, 2 * cin if split else cin, 16) * 0.2).astype(
        np.float32)
    b1 = (rng.randn(16) * 0.1).astype(np.float32)
    k2 = (rng.randn(3, 3, 16, 16) * 0.2).astype(np.float32)
    b2 = (rng.randn(16) * 0.1).astype(np.float32)
    if split:
        up = rng.randn(2, 12, 16, cin).astype(np.float32)
        want = jax_s2d.s2d_double_conv(
            jnp.asarray(x), jnp.asarray(k1[:, :, :cin]), jnp.asarray(b1),
            jnp.asarray(k2), jnp.asarray(b2), extra=jnp.asarray(up),
            k1_extra=jnp.asarray(k1[:, :, cin:]))
        got = s2d_conv.s2d_double_conv(t(x), t(k1[:, :, :cin]), t(b1),
                                       t(k2), t(b2), extra=t(up),
                                       k1_extra=t(k1[:, :, cin:]))
    else:
        want = jax_s2d.s2d_double_conv(*map(jnp.asarray,
                                            (x, k1, b1, k2, b2)))
        got = s2d_conv.s2d_double_conv(*map(t, (x, k1, b1, k2, b2)))
    close(got, want, 2e-5, 1e-5)


@pytest.mark.parametrize("pack_bwd", [False, True])
def test_lane_packed_gradients_match_fabric_tpu(pack_bwd):
    """conv3x3_lane_packed's hand-written gradients (dgrad packed or
    direct, wgrad, db) against fabric_tpu's custom_vjp."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, SIDE, SIDE, 8).astype(np.float32)
    k = (rng.randn(3, 3, 8, 8) * 0.2).astype(np.float32)
    b = (rng.randn(8) * 0.1).astype(np.float32)

    def jax_loss(x, k, b):
        return (jax_s2d.conv3x3_lane_packed(x, k, b, pack_bwd) ** 2).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, k, b)))
    xs = [t(a).requires_grad_() for a in (x, k, b)]
    loss = (s2d_conv.conv3x3_lane_packed(*xs, pack_bwd) ** 2).sum()
    got = torch.autograd.grad(loss, xs)
    for g, w in zip(got, want):
        close(g, w, 5e-3, 1e-4)


def test_supports_equals_fabric_tpu():
    for h in (64, 94, 95, 96, 97, 128, 192):
        for w in (64, 96, 97, 128):
            for cin in (13, 64, 128):
                for cout in (32, 64, 127, 128, 256):
                    assert s2d_conv.supports(h, w, cin, cout) == \
                        jax_s2d.supports(h, w, cin, cout), (h, w, cin, cout)


def _variables():
    params, stats = weights.init_variables(13, 2, BASE,
                                           torch.Generator().manual_seed(3))
    rng = np.random.RandomState(3)
    for name in weights.LEVELS:
        st = stats[name] if "bn1" in stats[name] else stats[name]["conv"]
        for bn in ("bn1", "bn2"):
            c = st[bn]["mean"].shape[0]
            st[bn]["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
            st[bn]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return params, stats


def _configs(**kw):
    kw = {"model_base": BASE, "patch_size": SIDE, "batch_size": 2,
          "dtype": "float32", "learning_rate": 0.05, "lane_pack": True, **kw}
    return jax_config.Config(**kw), config.Config(**kw)


def _batch(n=2):
    rng = np.random.RandomState(7)
    img1 = rng.randn(n, SIDE, SIDE, 13).astype(np.float32)
    img2 = img1 + rng.randn(n, SIDE, SIDE, 13).astype(np.float32) * 0.3
    label = (rng.rand(n, SIDE, SIDE) < 0.3).astype(np.int32)
    return {"img1": img1, "img2": img2, "label": label,
            "weight": np.ones(n, np.float32)}


@pytest.mark.parametrize("train", [False, True])
def test_bidate_lane_pack_logits_match_fabric_tpu(train):
    """BiDateNet with lane_pack, unfolded, train and eval mode, at 96^2
    (inc and up4 pack: their convs have Cout 8 at 96^2)."""
    jcfg, pcfg = _configs()
    params, stats = _variables()
    b = _batch(1)
    want = jax_build_model(jcfg).apply(
        {"params": params, "batch_stats": stats}, b["img1"], b["img2"],
        train=train, **({"mutable": ["batch_stats"]} if train else {}))
    if train:
        want = want[0]
    model = build_model(pcfg, "cpu", fold_bn=False,
                        variables=(params, stats), train=train)
    assert model.inc.lane_pack and model.up4.conv.lane_pack
    with torch.set_grad_enabled(train):
        got = model(t(b["img1"]), t(b["img2"]), train=train)
    close(got, want, 5e-4, 1e-4)


@pytest.mark.parametrize("bwd", [False, True])
def test_lane_pack_train_step_matches_fabric_tpu(bwd):
    """One tversky + SGD step with lane_pack (and lane_pack_bwd) from the
    same variables and batch: loss within 1e-6 relative, parameters within
    1e-5 and running statistics within 1e-6 (PR 10's bounds)."""
    jcfg, pcfg = _configs(lane_pack_bwd=bwd)
    params, stats = _variables()
    b = _batch()
    jmodel = jax_build_model(jcfg)
    jstate = jax_create_state(jcfg, jmodel, variables={
        "params": params, "batch_stats": stats})
    jstate, jstats = jax_make_train_step(
        jmodel, jax_losses.get_loss_fn(jcfg), donate=False)(jstate, b)
    model = build_model(pcfg, "cpu", fold_bn=False,
                        variables=(params, stats), train=True)
    state = create_state(pcfg, model)
    state, stats_ = make_train_step(model, losses.get_loss_fn(pcfg))(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(stats_["loss"].item(), float(jstats["loss"]),
                               rtol=1e-6)
    got = weights.flatten_tree(dict(zip(("params", "batch_stats"),
                                        state.variables())))
    want = weights.flatten_tree({
        "params": jax.device_get(jstate.params),
        "batch_stats": jax.device_get(jstate.batch_stats)})
    assert got.keys() == want.keys()
    for k in want:
        tol = dict(atol=1e-5, rtol=0) if k.startswith("params") else \
            dict(atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_lane_pack_predictor_serves_the_kernels_mask():
    """A folded predictor serves on the conv kernels whatever lane_pack
    says (fabric_tpu's folded Pallas branch comes first too): the same
    mask as lane_pack=False, bit for bit."""
    rng = np.random.RandomState(2)
    d1, d2 = (rng.randn(SIDE, SIDE + 32, 13).astype(np.float32)
              for _ in range(2))
    masks = []
    for lane_pack in (False, True):
        cfg = config.Config(model_base=BASE, patch_size=SIDE,
                            eval_batch_size=4, lane_pack=lane_pack)
        pred = ScenePredictor(cfg, bucket=0, device="cpu")
        assert pred.model.inc.lane_pack == lane_pack
        masks.append(pred.predict(d1, d2))
    np.testing.assert_array_equal(masks[0], masks[1])
