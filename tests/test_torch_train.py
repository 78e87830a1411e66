"""The port's training pieces (fabric_tpu_torch: config, losses, metrics,
optimizer and schedules, train step, eval BatchNorm) against fabric_tpu on
shared seeded numpy inputs and weights, on the CPU at base 8, patch 16,
batch 4.  On the CPU the kernel wrappers compute their plain PyTorch
versions; the kernels are held against those on the card
(test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu import config as jax_config
from fabric_tpu import losses as jax_losses
from fabric_tpu import metrics as jax_metrics
from fabric_tpu.models import BiDateNet as JaxBiDateNet
from fabric_tpu.models import build_model as jax_build_model
from fabric_tpu.ops.pallas_fused import bn_relu_inference as jax_bn_relu
from fabric_tpu.train.state import create_state as jax_create_state
from fabric_tpu.train.state import make_optimizer as jax_make_optimizer
from fabric_tpu.train.state import make_schedule as jax_make_schedule
from fabric_tpu.train.steps import make_train_step as jax_make_train_step

from fabric_tpu_torch import config, losses, metrics, weights
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.ops import bn_relu, fused
from fabric_tpu_torch.train.state import (Optimizer, create_state,
                                          make_schedule)
from fabric_tpu_torch.train.steps import (make_eval_step, make_infer_step,
                                          make_train_step)

BASE, PATCH, BATCH = 8, 16, 4


def variables(seed=0):
    """A BiDateNet tree (base 8) with non-trivial BatchNorm params and
    running statistics, as numpy."""
    params, stats = weights.init_variables(
        13, 2, BASE, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    for name in weights.LEVELS:
        p, s = params[name], stats[name]
        if "conv1" not in p:
            p, s = p["conv"], s["conv"]
        for bn in ("bn1", "bn2"):
            c = p[bn]["scale"].shape[0]
            p[bn]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p[bn]["bias"] = (rng.randn(c) * 0.1).astype(np.float32)
            s[bn]["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
            s[bn]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return params, stats


def batch(seed, n=BATCH):
    rng = np.random.RandomState(seed)
    img1 = rng.randn(n, PATCH, PATCH, 13).astype(np.float32)
    img2 = img1 + rng.randn(n, PATCH, PATCH, 13).astype(np.float32) * 0.3
    label = (rng.rand(n, PATCH, PATCH) < 0.3).astype(np.int32)
    img2[label == 1] += 1.5
    return {"img1": img1, "img2": img2, "label": label,
            "weight": np.ones(n, np.float32)}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def configs(**kw):
    kw = {"model_base": BASE, "patch_size": PATCH, "batch_size": BATCH,
          "dtype": "float32", "learning_rate": 0.05, **kw}
    return jax_config.Config(**kw), config.Config(**kw)


def run_both(kw, n_steps, seed=0):
    """The same variables and batches through n steps of each package's
    train step; returns [(jax_state, jax_stats, port_state, port_stats)]
    after every step."""
    jcfg, pcfg = configs(**kw)
    params, stats = variables(seed)
    jstate = jax_create_state(jcfg, jax_build_model(jcfg), variables={
        "params": params, "batch_stats": stats})
    jstep = jax_make_train_step(jax_build_model(jcfg),
                                jax_losses.get_loss_fn(jcfg), donate=False)
    pmodel = build_model(pcfg, "cpu", fold_bn=False,
                         variables=(params, stats), train=True)
    pstate = create_state(pcfg, pmodel)
    pstep = make_train_step(pmodel, losses.get_loss_fn(pcfg))
    out = []
    for i in range(n_steps):
        b = batch(seed + i)
        jstate, jstats = jstep(jstate, b)
        pstate, pstats = pstep(pstate, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        out.append((jstate, jax.device_get(jstats),
                    {k: v.copy() for k, v in flat(dict(zip(
                        ("params", "batch_stats"),
                        pstate.variables()))).items()},
                    {k: v.numpy() for k, v in pstats.items()}))
    return out, (jstate, jstep, pstate, pstep)


def assert_params_close(jstate, port_flat, atol, stats_rtol=None):
    want = flat({"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)})
    assert want.keys() == port_flat.keys()
    for k in want:
        if k.startswith("batch_stats") and stats_rtol is not None:
            np.testing.assert_allclose(port_flat[k], want[k], rtol=stats_rtol,
                                       atol=stats_rtol, err_msg=k)
        elif k.startswith("params"):
            np.testing.assert_allclose(port_flat[k], want[k], rtol=0,
                                       atol=atol, err_msg=k)


# --- config -----------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--augmentation", "yes"], ["--augmentation", "off"],
    ["--augmentation", "1", "--shuffle_train", "false"],
    ["--learning_rate", "0.01", "--momentum", "1"],
    ["--validation_cities", '["a", "b"]', "--stretch_8bit", "[1, 99]"],
    ["--compat_reference", "on", "--batch_size", "8"],
    ["--config", "{json}", "--epochs", "3"],
])
def test_config_parses_like_fabric_tpu(argv, tmp_path):
    """The same argv (and JSON file) gives the same config in both
    packages, field for field."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"learning_rate": 0.2, "per_date_batchnorm":
                                True, "_comment": "ignored"}))
    argv = [str(path) if a == "{json}" else a for a in argv]
    got = config.load_config(argv, overrides={"seed": 4}).to_dict()
    want = jax_config.load_config(argv, overrides={"seed": 4}).to_dict()
    assert got == want
    assert [f.name for f in dataclasses.fields(config.Config)] == list(want)


def test_config_rejects_a_bad_bool():
    for load in (config.load_config, jax_config.load_config):
        with pytest.raises(SystemExit):
            load(["--augmentation", "maybe"])


# --- losses and metrics -----------------------------------------------------

LOSSES = ["bce", "wbce", "focal", "dice", "jaccard", "tversky"]


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_fabric_tpu(name, compat, weighted):
    """fp32 logits; weights include zeros (padded rows).  Within 1e-6
    relative: the two sides sum in another order."""
    rng = np.random.RandomState(LOSSES.index(name))
    logits = (rng.randn(4, 8, 6, 2) * 2).astype(np.float32)
    labels = (rng.rand(4, 8, 6) < 0.3).astype(np.int32)
    w = np.array([1.0, 0.0, 1.0, 0.0], np.float32) if weighted else None
    kw = dict(loss_function=name, compat_reference_losses=compat,
              bce_pos_weight=3.0, focal_gamma=1.5)
    jcfg, pcfg = jax_config.Config(**kw), config.Config(**kw)
    want = float(jax_losses.get_loss_fn(jcfg)(
        jnp.asarray(logits), jnp.asarray(labels),
        weights=None if w is None else jnp.asarray(w)))
    got = losses.get_loss_fn(pcfg)(
        torch.from_numpy(logits), torch.from_numpy(labels),
        weights=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_confusion_counts_and_accumulator_match_fabric_tpu():
    rng = np.random.RandomState(5)
    jacc, pacc = jax_metrics.MetricAccumulator(), metrics.MetricAccumulator()
    for i in range(3):
        preds = rng.randint(0, 2, (4, 6, 6))
        labels = rng.randint(0, 2, (4, 6, 6))
        w = np.array([1, 0, 1, 1], np.float32) if i else None
        want = jax_metrics.confusion_counts(
            jnp.asarray(preds), jnp.asarray(labels),
            None if w is None else jnp.asarray(w))
        got = metrics.confusion_counts(
            torch.from_numpy(preds), torch.from_numpy(labels),
            None if w is None else torch.from_numpy(w))
        assert {k: int(v) for k, v in got.items()} == {
            k: int(v) for k, v in want.items()}
        assert all(v.dtype == torch.int32 for v in got.values())
        jacc.update(0.5 + i, want)
        pacc.update(0.5 + i, got)
    assert pacc.means() == jacc.means()
    assert pacc.global_prf1() == jacc.global_prf1()
    assert len(pacc) == len(jacc) == 3


# --- optimizer schedules ----------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(lr_schedule="constant"),
    dict(lr_schedule="cosine", lr_decay_steps=10),
    dict(lr_schedule="cosine", lr_decay_steps=10, lr_warmup_steps=3),
    dict(lr_schedule="linear", lr_decay_steps=8, lr_warmup_steps=2),
])
def test_schedules_match_optax(kw):
    jcfg, pcfg = configs(**kw)
    want = jax_make_schedule(jcfg)
    got = make_schedule(pcfg)
    for step in range(14):
        w = want if isinstance(want, float) else float(want(step))
        np.testing.assert_allclose(got(step), w, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(momentum=0.9),
    dict(momentum=0.5, lr_schedule="cosine", lr_decay_steps=5),
    dict(optimizer="adam", lr_schedule="cosine", lr_decay_steps=5,
         lr_warmup_steps=2),
    dict(optimizer="adamw", weight_decay=0.01, lr_schedule="linear",
         lr_decay_steps=4, lr_warmup_steps=1),
])
def test_optimizer_matches_optax(kw):
    """Four updates from the same gradients: params within 1e-6 relative
    (float32 arithmetic in another order), and the state tree in optax's
    layout (the keys, shapes and dtypes flax serialises) with equal
    values."""
    from flax import serialization
    import optax
    rng = np.random.RandomState(1)
    params = {"a": {"kernel": rng.randn(3, 4).astype(np.float32),
                    "bias": rng.randn(4).astype(np.float32)},
              "b": {"scale": rng.rand(4).astype(np.float32)}}
    jcfg, pcfg = configs(**kw)
    tx = jax_make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = tx.init(jparams)
    named = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in flat(params).items()}
    opt = Optimizer(pcfg, named.items())
    for _ in range(4):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in flat(params).items()}
        jgrads = {"a": {"kernel": grads["a.kernel"], "bias": grads["a.bias"]},
                  "b": {"scale": grads["b.scale"]}}
        updates, jopt = tx.update(jgrads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in named.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    want = flat(jax.device_get(jparams))
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    got_state = flat(opt.state_tree())
    want_state = flat(serialization.to_state_dict(jax.device_get(jopt)))
    assert got_state.keys() == want_state.keys()
    for k in want_state:
        assert got_state[k].dtype == want_state[k].dtype, k
        np.testing.assert_allclose(got_state[k], want_state[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# --- eval BatchNorm kernel's plain version ----------------------------------

def _bn_inputs(dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 9, 32).astype(np.float32)
    vecs = [(rng.rand(32) + 0.5), rng.randn(32), rng.randn(32),
            (rng.rand(32) + 0.1)]
    return x, [v.astype(np.float32) for v in vecs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_relu_plain_matches_pallas_interpret(dtype):
    """Against fabric_tpu's Pallas kernel in interpret mode.  fp32: atol
    1e-5.  bf16: the Pallas kernel rounds s, t, x*s and the sum to bf16
    where the port rounds once from fp32 (the documented rounding
    difference), so they may differ by 2 bf16 ulps (2 x 2^-7 relative) of
    the largest magnitude in the sum, max(|x*s|, |t|, |y|)."""
    x, vecs = _bn_inputs(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax_bn_relu(jnp.asarray(x, jdt),
                                  *map(jnp.asarray, vecs)), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = bn_relu.bn_relu_inference(tx, *map(torch.from_numpy, vecs))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    s = vecs[0] / np.sqrt(vecs[3] + 1e-5)
    t = vecs[1] - vecs[2] * s
    xs = tx.float().numpy() * s
    scale = np.maximum(np.maximum(np.abs(xs), np.abs(t)), np.abs(want))
    assert (np.abs(got - want) <= 2 * 2.0 ** -7 * scale).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_relu_conv_bias_plain_matches_conv_then_bn(dtype):
    """The conv-bias form, as the unfolded eval forward calls it (the conv
    without its bias, then the bias in the kernel's prologue), is
    bit-equal to Conv.forward followed by the form without it."""
    from fabric_tpu_torch.models.blocks import Conv
    x, vecs = _bn_inputs(dtype)
    rng = np.random.RandomState(4)
    conv = Conv(32, 32)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(rng.randn(3, 3, 32, 32) * 0.1))
        conv.bias.copy_(torch.from_numpy(rng.randn(32) * 0.5))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tvecs = list(map(torch.from_numpy, vecs))
    want = bn_relu.bn_relu_inference_reference(conv(tx), *tvecs)
    got = bn_relu.bn_relu_inference_reference(conv.conv(tx), *tvecs,
                                              conv_bias=conv.bias)
    assert got.dtype == tx.dtype and torch.equal(got, want)
    assert torch.equal(bn_relu.bn_relu_inference(  # the CPU wrapper
        conv.conv(tx), *tvecs, conv_bias=conv.bias), want)


def test_fused_function_gradients_equal_autograd():
    rng = np.random.RandomState(3)
    a0, b0 = (torch.from_numpy(rng.randn(2, 5, 7, 8).astype(np.float32))
              for _ in range(2))
    a0[0, 0, 0, :4] = 0.0  # ties at 0: jax.nn.relu's zero gradient
    g = torch.from_numpy(rng.randn(2, 5, 7, 8).astype(np.float32))
    a1, b1 = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    fused.FusedMulRelu.apply(a1, b1).backward(g)
    a2, b2 = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    torch.relu(a2 * b2).backward(g)
    assert torch.equal(a1.grad, a2.grad) and torch.equal(b1.grad, b2.grad)


# --- forward and train steps ------------------------------------------------

@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 0.05)])
def test_eval_forward_unfolded_matches_fabric_tpu(dtype, atol):
    """Eval BatchNorm through the kernel wrapper against fabric_tpu's
    fold_bn=False eval; the tolerances of test_torch_model.py (fp32: sum
    order; bf16: a few bf16 ulps of the logit scale over 19 layers)."""
    params, stats = variables(1)
    b = batch(7, n=2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    model = JaxBiDateNet(base=BASE, dtype=jdt)
    want = np.asarray(jax.jit(lambda v, a, c: model.apply(
        v, a, c, train=False))({"params": params, "batch_stats": stats},
                               b["img1"], b["img2"]))
    _, pcfg = configs(dtype=dtype)
    pmodel = build_model(pcfg, "cpu", fold_bn=False,
                         variables=(params, stats))
    with torch.inference_mode():
        got = pmodel(torch.from_numpy(b["img1"]),
                     torch.from_numpy(b["img2"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


RUNS = {
    "sgd": dict(),
    "per_date": dict(per_date_batchnorm=True),
    "momentum": dict(momentum=0.9, lr_schedule="cosine", lr_decay_steps=6,
                     lr_warmup_steps=1),
    "adam": dict(optimizer="adam", learning_rate=0.003, lr_schedule="cosine",
                 lr_decay_steps=6, lr_warmup_steps=1),
    "bf16": dict(dtype="bfloat16"),
    "local_upsample": dict(local_upsample=True),
}


@pytest.fixture(scope="module")
def runs():
    """run_both(RUNS[name], 3) per name, computed once per module (one
    compile of fabric_tpu's train step per config)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_both(RUNS[name], 3)
        return cache[name]
    return get


def assert_trajectory_close(name, jparams, pflat, atol, n_steps):
    """Params within ``atol``.  For Adam, the bias of a conv that feeds a
    train-mode BatchNorm has a zero gradient in exact arithmetic (BN
    removes any per-channel constant), so both sides compute rounding
    noise there, and Adam, which divides by the gradient's own RMS, moves
    such a coordinate by up to lr_t per step whatever the noise's size (at
    most 1.01 lr_t for t <= 3): those biases are held to 2.02 x the summed
    learning rate instead."""
    want = flat({"params": jparams})
    noise_atol = atol
    if name == "adam":
        schedule = make_schedule(configs(**RUNS[name])[1])
        noise_atol = 2.02 * sum(schedule(t) for t in range(n_steps))
    for k in want:
        tol = noise_atol if k.endswith(("conv1.bias", "conv2.bias")) else atol
        np.testing.assert_allclose(pflat[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["sgd", "per_date", "local_upsample"])
def test_one_train_step_matches_fabric_tpu(runs, name):
    """tversky + SGD, fp32, joint and per-date BatchNorm, and with the
    decoder's shift-invariant local upsample, from identical variables.  Tolerances: loss 1e-6 relative, params 1e-5, BatchNorm
    running stats 1e-6 (sums and convolutions in another order),
    confusion counts equal."""
    (jstate, jstats, pflat, pstats) = runs(name)[0][0]
    np.testing.assert_allclose(pstats["loss"], jstats["loss"], rtol=1e-6)
    for k in ("tp", "fp", "fn", "tn"):
        assert int(pstats[k]) == int(jstats[k]), k
    assert_params_close(jstate, pflat, atol=1e-5, stats_rtol=1e-6)
    assert int(jstate.step) == 1


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_three_steps_match_fabric_tpu(runs, name):
    """fp32 trajectories of SGD with momentum and of Adam under a cosine
    warmup schedule: params within 1e-4 after step 3."""
    jstate, _, pflat, _ = runs(name)[0][-1]
    assert int(jstate.step) == 3
    assert_trajectory_close(name, jax.device_get(jstate.params), pflat,
                            1e-4, 3)


def test_bf16_train_step_loss_matches_fabric_tpu(runs):
    """bf16 compute: the two sides round at other places (the port rounds
    each conv once after the fp32 bias), so the loss agrees within 1e-2
    relative."""
    (_, jstats, _, pstats) = runs("bf16")[0][0]
    np.testing.assert_allclose(pstats["loss"], jstats["loss"], rtol=1e-2)


def _trees(params, batch_stats, opt_state, step):
    return flat({"params": params, "batch_stats": batch_stats,
                 "opt_state": opt_state, "step": np.asarray(step)})


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_checkpoints_restore_both_ways(runs, name, tmp_path):
    """After 3 steps: the port's save restores in fabric_tpu.checkpoint
    into create_state's template, fabric_tpu's save restores in the port,
    with params, batch_stats, opt_state (optax's layout) and step equal;
    the next train step from each restored state matches the other
    package's step from its own state (the one-step tolerances)."""
    from flax import serialization
    from fabric_tpu import checkpoint as jax_ckpt
    from fabric_tpu_torch import checkpoint

    _, (jstate, jstep, pstate, pstep) = runs(name)
    jcfg, pcfg = configs(**RUNS[name])
    params, stats = variables(0)

    def jax_trees(s):
        return _trees(*jax.device_get((s.params, s.batch_stats)),
                      serialization.to_state_dict(jax.device_get(
                          s.opt_state)), int(s.step))

    def port_trees(s):
        return _trees(*s.variables(), s.opt_state, s.step)

    def assert_equal(a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    path = checkpoint.save(pstate, str(tmp_path / "port"), epoch=3)
    template = jax_create_state(jcfg, jax_build_model(jcfg), variables={
        "params": params, "batch_stats": stats})
    j_restored = jax_ckpt.restore(template, path)
    assert_equal(jax_trees(j_restored), port_trees(pstate))

    jpath = jax_ckpt.save(jstate, str(tmp_path / "jax"), epoch=3)
    p_restored = create_state(pcfg, build_model(
        pcfg, "cpu", fold_bn=False, variables=(params, stats), train=True))
    p_restored, meta = checkpoint.restore(p_restored, jpath)
    assert_equal(port_trees(p_restored), jax_trees(jstate))
    assert meta["epoch"] == 3 and meta["step"] == 3

    b = batch(99)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    # the restored values in the compiled step's own state object (a new
    # template's optimizer object would only force a recompile)
    j_restored = jstate.replace(
        params=j_restored.params, batch_stats=j_restored.batch_stats,
        opt_state=j_restored.opt_state, step=j_restored.step)
    for js, ps in ((j_restored, pstate), (jstate, p_restored)):
        js, jstats = jstep(js, b)
        ps, pstats = pstep(ps, tb)
        np.testing.assert_allclose(pstats["loss"].item(), jstats["loss"],
                                   rtol=1e-6)
        assert_trajectory_close(name, jax.device_get(js.params),
                                flat({"params": ps.variables()[0]}), 1e-5, 4)


def test_eval_and_infer_steps():
    _, pcfg = configs()
    params, stats = variables(2)
    model = build_model(pcfg, "cpu", fold_bn=False,
                        variables=(params, stats), train=True)
    state = create_state(pcfg, model)
    b = {k: torch.from_numpy(v) for k, v in batch(4).items()}
    b["weight"][1:] = 0.0
    out = make_eval_step(model, losses.get_loss_fn(pcfg))(state, b)
    assert out["preds"].shape == (BATCH, PATCH, PATCH)
    assert sum(int(out[k]) for k in ("tp", "fp", "fn", "tn")) == PATCH ** 2
    mask = make_infer_step(model)(state, b["img1"], b["img2"])
    assert mask.dtype == torch.uint8 and torch.equal(mask.long(),
                                                     out["preds"])
    # eval leaves the running statistics alone
    assert weights.variables_of(model)[1]["inc"]["bn1"]["mean"].tolist() \
        == stats["inc"]["bn1"]["mean"].tolist()
