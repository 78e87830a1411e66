"""Gradient accumulation (grad_accum_steps, optax MultiSteps) and
rematerialisation (remat) in the port against fabric_tpu on the CPU, at
base 8, patch 16, batch 4, fp32: the optimizer's updates and state, a
MultiSteps checkpoint in both packages, and remat's gradients and
BatchNorm statistics."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu import config as jax_config
from fabric_tpu import losses as jax_losses
from fabric_tpu.models import build_model as jax_build_model
from fabric_tpu.train.state import create_state as jax_create_state
from fabric_tpu.train.state import make_optimizer as jax_make_optimizer
from fabric_tpu.train.steps import make_train_step as jax_make_train_step

from fabric_tpu_torch import checkpoint, config, losses, weights
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.train.state import Optimizer, create_state
from fabric_tpu_torch.train.steps import make_train_step

torch.set_num_threads(1)

BASE, PATCH, BATCH = 8, 16, 4


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


def batch(seed):
    rng = np.random.RandomState(seed)
    img1 = rng.randn(BATCH, PATCH, PATCH, 13).astype(np.float32)
    img2 = img1 + rng.randn(BATCH, PATCH, PATCH, 13).astype(np.float32) * .3
    label = (rng.rand(BATCH, PATCH, PATCH) < 0.3).astype(np.int32)
    img2[label == 1] += 1.5
    return {"img1": img1, "img2": img2, "label": label,
            "weight": np.ones(BATCH, np.float32)}


def variables(seed=0):
    return weights.init_variables(13, 2, BASE,
                                  torch.Generator().manual_seed(seed))


# --- the optimizer alone --------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(momentum=0.9, lr_schedule="cosine", lr_decay_steps=5),
    dict(optimizer="adam", lr_schedule="cosine", lr_decay_steps=5,
         lr_warmup_steps=1),
    dict(optimizer="adamw", weight_decay=0.01, lr_schedule="linear",
         lr_decay_steps=4),
])
def test_grad_accum_matches_multisteps(kw):
    """grad_accum_steps=2, four micro steps from the same gradients: the
    parameters hold still after micro steps 1 and 3, and after each step
    equal optax MultiSteps' within 1e-6 relative; the state tree has
    MultiStepsState's layout (the keys, shapes and dtypes flax
    serialises) with equal values, the inner and schedule counts at 2."""
    from flax import serialization
    import optax
    rng = np.random.RandomState(1)
    params = {"a": {"kernel": rng.randn(3, 4).astype(np.float32),
                    "bias": rng.randn(4).astype(np.float32)},
              "b": {"scale": rng.rand(4).astype(np.float32)}}
    jcfg, pcfg = configs(grad_accum_steps=2, **kw)
    tx = jax_make_optimizer(jcfg)
    assert isinstance(tx, optax.MultiSteps)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = tx.init(jparams)
    named = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in flat(params).items()}
    opt = Optimizer(pcfg, named.items())
    for micro in range(4):
        before = {k: p.detach().clone() for k, p in named.items()}
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
            if micro % 2 == 0:
                assert torch.equal(p.detach(), before[k]), k
            np.testing.assert_allclose(p.detach().numpy(), want[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    got_state = flat(opt.state_tree())
    want_state = flat(serialization.to_state_dict(jax.device_get(jopt)))
    assert got_state.keys() == want_state.keys()
    assert int(got_state["gradient_step"]) == 2
    for k in want_state:
        assert got_state[k].dtype == want_state[k].dtype, k
        np.testing.assert_allclose(got_state[k], want_state[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# --- whole train steps: remat + accumulation ---------------------------------

KW = dict(grad_accum_steps=2, momentum=0.9, remat=True)


@pytest.fixture(scope="module")
def runs():
    """Three micro steps of fabric_tpu's remat=True, grad_accum_steps=2
    train step and the port's, from the same variables and batches:
    [(jax_state, port variables)] after each, and the final states and
    steps."""
    jcfg, pcfg = configs(**KW)
    params, stats = variables()
    jmodel = jax_build_model(jcfg)
    jstate = jax_create_state(jcfg, jmodel, variables={
        "params": params, "batch_stats": stats})
    jstep = jax_make_train_step(jmodel, jax_losses.get_loss_fn(jcfg),
                                donate=False)
    pmodel = build_model(pcfg, "cpu", fold_bn=False,
                         variables=(params, stats), train=True)
    pstate = create_state(pcfg, pmodel)
    pstep = make_train_step(pmodel, losses.get_loss_fn(pcfg))
    out = []
    for i in range(3):
        b = batch(i)
        jstate, _ = jstep(jstate, b)
        pstate, _ = pstep(pstate, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        out.append((jax.device_get(jstate), flat(dict(zip(
            ("params", "batch_stats"), pstate.variables())))))
    return out, (jstate, jstep, pstate, pstep)


def test_remat_accum_steps_match_fabric_tpu(runs):
    """After each micro step: BatchNorm running statistics within 1e-6
    (they move every micro step), parameters unchanged after step 1 and
    within 1e-5 of fabric_tpu's after the update at step 2 (the one-step
    tolerances of test_torch_train.py); step counts advance per micro
    step."""
    params0 = flat({"params": variables()[0]})
    for i, (js, pflat) in enumerate(runs[0]):
        want = flat({"params": js.params, "batch_stats": js.batch_stats})
        assert want.keys() == pflat.keys()
        for k in want:
            if k.startswith("batch_stats"):
                np.testing.assert_allclose(pflat[k], want[k], rtol=1e-6,
                                           atol=1e-6, err_msg=k)
            elif i == 0:
                np.testing.assert_array_equal(pflat[k], params0[k],
                                              err_msg=k)
            else:
                np.testing.assert_allclose(pflat[k], want[k], rtol=0,
                                           atol=1e-5, err_msg=k)
        assert int(js.step) == i + 1
    assert runs[1][2].step == 3 and runs[1][2].tx.mini_step == 1


def test_multisteps_checkpoints_restore_both_ways(runs, tmp_path):
    """Mid-accumulation (micro step 3 of 4: mini_step 1, the mean
    gradient held): the port's save restores in fabric_tpu.checkpoint and
    fabric_tpu's in the port, params, batch_stats, opt_state and step
    equal; the next micro step from each restored state matches the
    other package's."""
    from flax import serialization
    from fabric_tpu import checkpoint as jax_ckpt

    _, (jstate, jstep, pstate, pstep) = runs
    jcfg, pcfg = configs(**KW)
    params, stats = variables()

    def trees(p, s, o, step):
        return flat({"params": p, "batch_stats": s, "opt_state": o,
                     "step": np.asarray(step)})

    def jax_trees(s):
        return trees(*jax.device_get((s.params, s.batch_stats)),
                     serialization.to_state_dict(jax.device_get(
                         s.opt_state)), int(s.step))

    def port_trees(s):
        return trees(*s.variables(), s.opt_state, s.step)

    def assert_equal(a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    path = checkpoint.save(pstate, str(tmp_path / "port"), epoch=0)
    template = jax_create_state(jcfg, jax_build_model(jcfg), variables={
        "params": params, "batch_stats": stats})
    j_restored = jax_ckpt.restore(template, path)
    assert_equal(jax_trees(j_restored), port_trees(pstate))
    assert int(port_trees(pstate)["opt_state.mini_step"]) == 1

    jpath = jax_ckpt.save(jstate, str(tmp_path / "jax"), epoch=0)
    p_restored = create_state(pcfg, build_model(
        pcfg, "cpu", fold_bn=False, variables=(params, stats), train=True))
    p_restored, _ = checkpoint.restore(p_restored, jpath)
    assert_equal(port_trees(p_restored), jax_trees(jstate))

    b = batch(99)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    j_restored = jstate.replace(
        params=j_restored.params, batch_stats=j_restored.batch_stats,
        opt_state=j_restored.opt_state, step=j_restored.step)
    for js, ps in ((j_restored, pstate), (jstate, p_restored)):
        js, _ = jstep(js, b)
        ps, _ = pstep(ps, tb)
        want = flat({"params": jax.device_get(js.params)})
        got = flat({"params": ps.variables()[0]})
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        assert ps.tx.mini_step == 0 and ps.tx.gradient_step == 2


@pytest.mark.parametrize("per_date", [False, True])
def test_remat_gradients_and_statistics_equal_plain(per_date):
    """The same train forward and backward with and without remat on the
    CPU: every gradient, the loss and every BatchNorm running statistic
    bit-equal (the rematerialised forward leaves the statistics alone)."""
    params, stats = variables(2)
    b = {k: torch.from_numpy(v) for k, v in batch(5).items()}
    out = {}
    for remat in (False, True):
        _, pcfg = configs(remat=remat, per_date_batchnorm=per_date)
        model = build_model(pcfg, "cpu", fold_bn=False,
                            variables=(params, stats), train=True)
        loss = losses.get_loss_fn(pcfg)(
            model(b["img1"], b["img2"], train=True), b["label"])
        loss.backward()
        out[remat] = (loss.detach(),
                      {n: p.grad for n, p in model.named_parameters()},
                      dict(model.named_buffers()))
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    moved = 0
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
        moved += not np.array_equal(s0[k].numpy(), flat(
            {"batch_stats": stats})[f"batch_stats.{k}"])
    assert moved == len(s0)  # every statistic moved, once
