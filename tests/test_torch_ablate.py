"""tools/ablate and tools/ablate_train in the port against fabric_tpu's
on the CPU (the kernels are their plain versions here).  Stage 11 is the
port's folded forward bit for bit; every stage's last output matches
fabric_tpu's build_functional at fp32 within 1e-5; a prefix's gradient
matches jax.grad of build_functional(pool_impl="reshape") within 1e-5 of
its largest magnitude; the variants and microbenches run and report
fabric_tpu's keys, and the int8 shift conv is exact."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabric_tpu.ops.fold_bn import fold_batchnorm
from fabric_tpu.tools import ablate as jax_ablate
from fabric_tpu.tools import ablate_train as jax_ablate_train

from fabric_tpu_torch import config, weights
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.tools import ablate, ablate_train

BASE, SIDE = 8, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def folded():
    """(port folded fp32 model, fabric_tpu's folded params) of one seeded
    base-8 tree with non-trivial BatchNorm."""
    params, stats = weights.init_variables(13, 2, BASE,
                                           torch.Generator().manual_seed(2))
    rng = np.random.RandomState(2)
    for name in weights.LEVELS:
        p, s = params[name], stats[name]
        if "conv1" not in p:
            p, s = p["conv"], s["conv"]
        for bn in ("bn1", "bn2"):
            c = p[bn]["scale"].shape[0]
            p[bn]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            s[bn]["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
            s[bn]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    cfg = config.Config(model_base=BASE, dtype="float32")
    model = build_model(cfg, "cpu", variables=(params, stats))
    return model, fold_batchnorm(params, stats)


def _pair(n=2, seed=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(n, SIDE, SIDE, 13).astype(np.float32)
                 for _ in range(2))


def test_verify_stage_11_is_the_folded_forward(capsys):
    """--verify at full width (bf16, base 64, seed-0 weights): stage 11's
    mask equals the folded forward's, bit for bit."""
    assert ablate.main(["--verify", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"verify_mask_agreement": 1.0}


@pytest.mark.parametrize("stage", range(12))
def test_stage_outputs_match_fabric_tpu(folded, stage):
    """Each stage's last output (the mask at 11) against fabric_tpu's
    build_functional(return_last=True) at fp32: within 1e-5, the mask
    equal; the kernel form and the differentiable form agree likewise."""
    model, jparams = folded
    a, b = _pair()
    want = np.asarray(jax_ablate.build_functional(jparams, jnp.float32)(
        jnp.asarray(a), jnp.asarray(b), stage, return_last=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with torch.no_grad():
        got = [ablate.build_functional(model, impl)(ta, tb, stage,
                                                    return_last=True).numpy()
               for impl in ("reduce_window", "reshape")]
        if stage == 11:
            forward = model(ta, tb).argmax(-1).to(torch.uint8).numpy()
    for g in got:
        assert g.shape == want.shape
        if stage == 11:
            np.testing.assert_array_equal(g, want)
        else:
            np.testing.assert_allclose(g, want, atol=1e-5, rtol=0)
    if stage == 11:
        np.testing.assert_array_equal(got[0], forward)


def test_stage_timing_runs(capsys):
    assert ablate.main(["--stage", "2", "--batch", "2", "--patch", "32",
                        "--iters", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["stage"] == 2 and out["ms"] > 0
    assert set(out) == {"stage", "ms", "compile_s", "batch", "patch",
                        "backend"}


def test_prefix_gradient_matches_jax_grad(folded):
    """The gradient of the sum of every stage's output up to +down2 with
    respect to the folded weights, against jax.grad of fabric_tpu's
    objective (build_functional(pool_impl="reshape"), fp32)."""
    model, jparams = folded
    stage = 3
    a, b = _pair(1, seed=3)
    data = {"img1": torch.from_numpy(a), "img2": torch.from_numpy(b)}
    got = weights.flatten_tree(weights.unflatten_tree(
        {k: g.numpy() for k, g in ablate_train.stage_grad_fn(
            model, data, stage)().items()}))

    def objective(p):
        return jax_ablate.build_functional(p, jnp.float32,
                                           pool_impl="reshape")(
            jnp.asarray(a), jnp.asarray(b), stage).sum()

    want = {k: v for k, v in weights.flatten_tree(
        jax.device_get(jax.grad(objective)(jparams))).items()
        if np.any(v)}
    assert got.keys() == want.keys()
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale,
                                   rtol=0, err_msg=k)


def test_variants_run_and_step_counts():
    """Only the full step advances the optimizer (fabric_tpu's test)."""
    cfg = config.Config(dtype="float32", patch_size=16, batch_size=2,
                        model_base=8)
    batch = ablate_train._data(2, 16, "cpu")
    for variant in ("full", "grad", "fwd", "eval_fwd"):
        carry, fn = ablate_train.build_variant(variant, cfg, "cpu")
        carry, leaf = fn(carry, batch)
        carry, leaf = fn(carry, batch)
        assert torch.isfinite(leaf).all(), variant
        assert carry.step == (2 if variant == "full" else 0), variant


def test_records_carry_fabric_tpus_keys():
    """time_variant (no_donate's note included), the stage grad and the
    microbenches at toy sizes: fabric_tpu's keys, positive times, the
    space-to-depth form within fp32 rounding of the direct conv."""
    rec = ablate_train.time_variant("no_donate", 2, 16, 1, "float32",
                                    device="cpu")
    # the keys of fabric_tpu's time_variant record
    # (fabric_tpu/tools/ablate_train.py:158-162)
    assert {"variant", "patch", "batch", "iters", "step_ms",
            "examples_per_sec", "compile_s", "dtype"} <= set(rec)
    assert rec["step_ms"] > 0
    assert rec["variant"] == "no_donate" and "donates no" in rec["note"]
    rec = ablate_train.time_stage_grad(11, 1, 32, 1, "float32", "cpu")
    assert rec["stage"] == 10 and rec["grad_step_ms"] > 0
    assert set(rec) == {"stage", "patch", "batch", "iters", "grad_step_ms",
                        "compile_s", "dtype"}
    rec = ablate_train.microbench_group_conv(2, 32, 1, "float32", "cpu")
    assert rec["batched_2n_c64_ms"] > 0 and rec["grouped_n_c128_ms"] > 0
    rec = ablate_train.microbench_space_to_depth(2, 16, 1, "float32",
                                                 device="cpu")
    assert rec["max_abs_err"] < 1e-5 and rec["s2d_2x2_ms"] > 0
    with pytest.raises(SystemExit):
        ablate_train.main(["--variant", "full", "--xla_opt", "a=b",
                           "--device", "cpu"])


def test_int8_shift_conv_is_exact():
    rec = ablate_train.microbench_int8_shift_conv(2, 16, 1, 32, 32, "cpu")
    want = jax_ablate_train.microbench_int8_shift_conv(2, 16, 1, 32, 32)
    assert set(rec) == set(want)
    assert rec["exact"] is True and want["exact"] is True
    assert rec["gflop"] == want["gflop"]
    assert rec["direct_conv_ms"] > 0 and rec["shifted_dot_ms"] > 0
