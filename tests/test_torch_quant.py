"""The port's int8 serving (fabric_tpu_torch.infer.quant, ScenePredictor
quant="int8", tools.validate_int8, cli.infer, the int8 microbench) against
fabric_tpu on the CPU, at model_base 8 and patch 32, inputs from numpy
seeds.  On the CPU the int8 conv and matmul wrappers compute their plain
versions, which are exact integer products, so a conv has no rounding
freedom: the two sides can differ only in the float32 dequantize (where
XLA fuses a multiply-add), the bf16 roundings of the compute-dtype ops
(upsample matmuls, the 1x1 head) and the summation order of the float
calibration forward."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.infer import quant as jq
from fabric_tpu.infer.device_tiling import make_scene_infer as jax_scene_infer
from fabric_tpu.models import BiDateNet as JaxBiDateNet
from fabric_tpu.ops.fold_bn import fold_batchnorm

from fabric_tpu_torch import Config
from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch.infer import quant as tq
from fabric_tpu_torch.infer.device_tiling import (_gather_tiles, _plan_grid,
                                                  _stitch)
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.models import BiDateNet, build_model
from fabric_tpu_torch.ops.conv_s8 import conv3x3_s8, conv3x3_s8_reference
from fabric_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference
from fabric_tpu_torch.weights import load_variables

BASE, PATCH, BATCH = 8, 32, 4
# float32: the int32 convs are exact on both sides; what is left is XLA's
# fused multiply-adds and summation order in the float ops (~1e-7 seen)
FP32_ATOL = 1e-5
# bf16: XLA on the CPU keeps chains of bf16 elementwise ops in float32 and
# rounds once, where PyTorch rounds after each op; a dequantized value one
# bf16 ulp off may requantize one int8 quantum off.  Held to the bf16 bound
# of the exact forward's parity test (tests/test_torch_model.py): a few
# ulps at the logit scale (0.002-0.006 seen at scales of 0.7-2).
BF16_ATOL = 0.05
# A mask pixel may differ only where the port's fp32 logit margin |l1 - l0|
# is within twice the logit tolerance.
FLIP_MARGIN = 2 * BF16_ATOL
# calibration scales: absmax / 127 of the float forward's conv inputs.  In
# float32 the sums are taken in another order (1e-5 relative, 4e-7 seen);
# in bf16 the port's conv kernel rounds once after the float32 bias where
# XLA rounds the conv and then adds a bf16 bias, so a tap may move by a
# few bf16 ulps (4 ulps = 2^-5 relative; 0.007-0.013 seen)
SCALE_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small PyTorch ops, which take far longer with
    a thread pool per op when several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturb_bn(params, stats, rng):
    """Non-trivial BatchNorm affine params and running statistics."""
    for key, value in params.items():
        if key.startswith("bn"):
            c = value["scale"].shape[0]
            value["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            value["bias"] = (rng.randn(c) * 0.1).astype(np.float32)
            stats[key]["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
            stats[key]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif isinstance(value, dict):
            _perturb_bn(value, stats.get(key, {}), rng)


@pytest.fixture(scope="module")
def variables():
    """fabric_tpu's variable tree at base 8, from ``model.init``'s shapes
    (``jax.eval_shape``; compiling the init itself costs ~10 s on a CPU)
    with values from numpy: lecun-scaled kernels, small biases, non-trivial
    BatchNorm."""
    model = JaxBiDateNet(base=BASE)
    x = jnp.zeros((1, PATCH, PATCH, 13), jnp.float32)
    shapes = jax.eval_shape(lambda k: model.init(k, x, x, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def value(path, leaf):
        shape, name = leaf.shape, path[-1].key
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(
                np.float32)
        if name == "bias" and path[-2].key.startswith("conv"):
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        return np.ones(shape, np.float32)  # BatchNorm, set below

    v = jax.tree_util.tree_map_with_path(value, shapes)
    params, stats = v["params"], v["batch_stats"]
    _perturb_bn(params, stats, rng)
    return params, stats


@pytest.fixture(scope="module")
def folded(variables):
    """(fabric_tpu's folded tree, the port's folded bf16 model)."""
    model = BiDateNet(13, 2, BASE, fold_bn=True, dtype=torch.bfloat16)
    load_variables(model, *variables)
    return fold_batchnorm(*variables), model.eval()


def _pair(seed, *shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, 13).astype(np.float32),
            rng.randn(*shape, 13).astype(np.float32))


@pytest.fixture(scope="module")
def scales(folded):
    """The port's bf16 scales on two 32x32 pairs: what both sides serve."""
    return tq.calibrate(tq.folded_params(folded[1]),
                        [_pair(1, 2, PATCH, PATCH)])


def test_quantize_weights_bit_equal(folded):
    want = jq.quantize_weights(folded[0])
    got = tq.quantize_weights(tq.folded_params(folded[1]))
    assert sorted(got) == sorted(want)
    assert {"up1.conv1.skip", "up4.conv1.up"} <= set(got)
    for site, fields in want.items():
        assert sorted(got[site]) == sorted(fields), site
        for f, v in fields.items():
            v = np.asarray(v)
            assert got[site][f].dtype == v.dtype, (site, f)
            np.testing.assert_array_equal(got[site][f], v, err_msg=site)
    assert [n for n, _ in tq.derive_conv_sites(tq.folded_params(
        folded[1]))] == [n for n, _ in tq._SITES]


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 6, 7, 13, 64), (2, 5, 9, 32, 16), (1, 4, 4, 512, 256),
    (3, 8, 8, 64, 8)])
def test_conv3x3_s8_reference_bit_equal_xla(n, h, w, cin, cout):
    """Cin 13, odd widths, N = 1 and the 512 -> 256 site of up1."""
    rng = np.random.RandomState(n + h + cin)
    x = rng.randint(-127, 128, (n, h, w, cin)).astype(np.int8)
    k = rng.randint(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    got = conv3x3_s8_reference(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(conv3x3_s8(torch.from_numpy(x),
                                             torch.from_numpy(k)).numpy(),
                                  want)


@pytest.mark.parametrize("m,k,n", [(37, 100, 24), (64, 512, 64), (5, 13, 7)])
def test_int8_matmul_reference_bit_equal_xla(m, k, n):
    rng = np.random.RandomState(m)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (k, n)).astype(np.int8)
    want = np.asarray(jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int8_matmul_reference(
        torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibrate_scales_agree(folded, dtype):
    jdt, tdt = DTYPES[dtype]
    batches = [_pair(2, 2, PATCH, PATCH), _pair(3, 1, PATCH, PATCH)]
    want = jq.calibrate(folded[0], batches, jdt)
    model = BiDateNet(13, 2, BASE, fold_bn=True, dtype=tdt)
    model.load_state_dict(folded[1].state_dict())
    got = tq.calibrate(tq.folded_params(model), batches, tdt)
    assert sorted(got) == sorted(want)
    assert {"enc.x5", "f1", "f4", "up4.conv2"} <= set(got)
    rel = max(abs(got[k] - want[k]) / want[k] for k in want)
    print(f"{dtype}: largest relative scale difference {rel:.3g}")
    assert rel <= SCALE_RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_match_fabric_tpu(folded, scales, dtype):
    """Both sides serve the same scales."""
    jdt, tdt = DTYPES[dtype]
    a, b = _pair(4, 2, PATCH, PATCH)
    apply_q = jq.make_int8_apply(folded[0], scales, jdt)
    want = np.asarray(jax.jit(lambda a, b: apply_q(None, a, b))(a, b))
    fwd = tq.make_int8_apply(tq.folded_params(folded[1]), scales, tdt)
    got = fwd(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, PATCH, PATCH, 2)
    err = np.abs(got - want).max()
    print(f"{dtype}: int8 logits max abs diff {err:.3g} at scale "
          f"{np.abs(want).max():.3g}")
    assert err <= (FP32_ATOL if dtype == "float32" else BF16_ATOL)
    flips = got.argmax(-1) != want.argmax(-1)
    assert (np.abs(got[..., 1] - got[..., 0])[flips] < FLIP_MARGIN).all()


@pytest.fixture(scope="module")
def checkpoint_dir(variables, tmp_path_factory):
    """The variables in a checkpoint written by the port."""
    from fabric_tpu_torch.train.state import create_state
    cfg = Config(model_base=BASE, patch_size=PATCH)
    state = create_state(cfg, build_model(cfg, "cpu", fold_bn=False,
                                          variables=variables, train=True))
    path = tmp_path_factory.mktemp("ckpt")
    ckpt.save(state, str(path), epoch=0)
    return str(path)


def test_int8_scene_mask_matches_fabric_tpu(folded, checkpoint_dir):
    """A 70x140 scene (edge row, column and corner tiles; 15 tiles in
    chunks of 4, the last zero-padded) served by ScenePredictor(quant=
    "int8") on the CPU, which calibrates on it, against fabric_tpu's
    make_scene_infer over make_int8_apply with the port's scales."""
    _int8_scene_mask_matches(folded, checkpoint_dir, "bfloat16")


def test_int8_f32_scene_mask_matches_fabric_tpu(folded, checkpoint_dir):
    """The same with the float32 compute dtype (no bf16 step in the int8
    forward's epilogues or its calibration forward), against fabric_tpu's
    int8 forward at dtype float32: flips only under the same margin rule
    (the two round the fp32 calibration absmaxes and the epilogues'
    multiply-adds alike, so in practice none)."""
    _int8_scene_mask_matches(folded, checkpoint_dir, "float32")


def _int8_scene_mask_matches(folded, checkpoint_dir, dtype: str):
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    d1, d2 = _pair(5, 70, 140)
    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype=dtype,
                 model_base=BASE)
    pred = ScenePredictor(cfg, checkpoint=checkpoint_dir, bucket=0,
                          device="cpu", quant="int8")
    got = pred.predict(d1, d2)
    assert pred._scales is not None and pred.last_clip_report is None
    apply_q = jq.make_int8_apply(folded[0], pred._scales, jdtype)
    run = jax_scene_infer(apply_q, PATCH, (70, 140), batch_size=BATCH,
                          dtype=jdtype)
    want = np.asarray(run({}, jnp.asarray(d1), jnp.asarray(d2)))
    assert got.shape == (70, 140) and got.dtype == np.uint8
    ys, xs, k, _, _ = _plan_grid(70, 140, PATCH, PATCH, BATCH)
    t1, t2 = (_gather_tiles(torch.from_numpy(d), ys, xs, PATCH)
              for d in (d1, d2))
    logits = pred._forward(t1, t2)
    margin = _stitch((logits[..., 1] - logits[..., 0]).abs(), ys, xs, k, 70,
                     140, PATCH).numpy()
    flips = got != want
    print(f"int8 {dtype} scene: {int(flips.sum())} of {flips.size} pixels "
          f"flipped")
    assert (margin[flips] < FLIP_MARGIN).all() and flips.mean() < 0.01


# --- the serving cadence, as fabric_tpu's tests/test_service.py pins it ---

def _small(**kw):
    cfg = Config(patch_size=16, eval_batch_size=8, dtype="float32",
                 model_base=8)
    return ScenePredictor(cfg, bucket=32, device="cpu", quant="int8", **kw)


def _scene(rng, h=32, w=32):
    return (rng.randn(h, w, 13).astype(np.float32),
            rng.randn(h, w, 13).astype(np.float32))


def test_int8_predictor_self_calibrates_once():
    pred = _small()
    d1, d2 = _scene(np.random.RandomState(2), 45, 53)
    mask = pred.predict(d1, d2)
    assert mask.shape == (45, 53) and set(np.unique(mask)) <= {0, 1}
    assert pred._forward is not pred.model  # the int8 forward serves
    scales, runners = dict(pred._scales), len(pred._runners)
    pred.predict(d1, d2)  # not due: no recalibration, the runner is kept
    assert pred._scales == scales and len(pred._runners) == runners
    assert pred.last_clip_report is not None


def test_clip_report(folded):
    """Ratios <= 1 on the calibration data itself, > 1.5 on data 4x
    hotter."""
    tree = tq.folded_params(folded[1])
    batch = _pair(6, 2, PATCH, PATCH)
    scales = tq.calibrate(tree, [batch])
    same = tq.clip_report(tree, scales, [batch])
    assert sorted(same) == sorted(scales)
    assert all(v <= 1.0 + 1e-6 for v in same.values())
    hot = tq.clip_report(tree, scales, [(batch[0] * 4, batch[1] * 4)])
    assert max(hot.values()) > 1.5


def test_int8_requires_fold_bn():
    with pytest.raises(ValueError, match="fold_bn"):
        ScenePredictor(Config(patch_size=16, model_base=8, dtype="float32"),
                       fold_bn=False, device="cpu", quant="int8")


def test_int8_clip_guardrail_and_recalibration(caplog):
    pred = _small()
    d1, d2 = _scene(np.random.RandomState(3))
    pred.predict(d1, d2)  # calibrates on this scene
    first = dict(pred._scales)
    with caplog.at_level(logging.WARNING, logger="fabric_tpu_torch"):
        pred.predict(d1 * 0.5, d2 * 0.5)
    assert max(pred.last_clip_report.values()) <= 1.0 + 1e-3
    assert not any("clipping" in r.message for r in caplog.records)
    with caplog.at_level(logging.WARNING, logger="fabric_tpu_torch"):
        pred.predict(d1 * 8.0, d2 * 8.0)
    assert max(pred.last_clip_report.values()) > 1.5
    assert any("clipping" in r.message for r in caplog.records)
    assert pred._scales == first  # a probe never moves the scales
    pred2 = _small(recalibrate_every=1)
    pred2.predict(d1, d2)
    s1 = dict(pred2._scales)
    pred2.predict(d1 * 8.0, d2 * 8.0)
    assert any(pred2._scales[k] > s1[k] * 2 for k in s1)
    assert pred2.last_clip_report is None  # a recalibration clears it


def test_recalibration_cadence_spares_preset_scales():
    pred = _small(recalibrate_every=2, clip_warn_ratio=0)
    rng = np.random.RandomState(5)
    c1 = rng.randn(4, 16, 16, 13).astype(np.float32)
    pred.calibrate([(c1, c1 * 0.9)])
    preset = dict(pred._scales)
    d1 = (rng.randn(32, 32, 13) * 4).astype(np.float32)
    pred.predict(d1, d1)  # scene 0: the preset scales survive
    assert pred._scales == preset
    pred.predict(d1, d1)  # scene 1: not due
    assert pred._scales == preset
    pred.predict(d1, d1)  # scene 2: due, re-derived from the data
    assert pred._scales != preset
    assert pred.last_clip_report is None  # probing is off


def test_predict_many_int8_matches_sequential():
    pred = _small()
    rng = np.random.RandomState(8)
    pairs = [_scene(rng, 33, 40) for _ in range(3)]
    seq = [pred.predict(*p) for p in pairs]  # scene 0 calibrates
    scales = dict(pred._scales)
    for window in (2, 1):
        piped = pred.predict_many(pairs, window=window)
        assert len(piped) == 3
        for a, b in zip(piped, seq):
            np.testing.assert_array_equal(a, b)
    assert pred._scenes_predicted == 9 and pred._scales == scales
    assert pred.last_clip_report is not None


def _records(tracker):
    tracker.close()
    with open(f"{tracker.dir}/metrics.jsonl") as fin:
        return [json.loads(line) for line in fin]


@pytest.mark.parametrize("pipelined", [False, True])
def test_serve_records_carry_only_their_own_clip_probe(tmp_path, pipelined):
    """Scenes 0 and 2 (re)calibrate and ran no probe: no clip fields (not
    the previous scene's); scenes 1 and 3 carry their own probe's."""
    from fabric_tpu_torch.track import Tracker
    tracker = Tracker(str(tmp_path), run_name="serve")
    pred = _small(recalibrate_every=2, tracker=tracker)
    rng = np.random.RandomState(16)
    pairs = [_scene(rng, 30, 30) for _ in range(4)]
    if pipelined:
        pred.predict_many(pairs, scene_ids=list("abcd"))
    else:
        for sid, p in zip("abcd", pairs):
            pred.predict(*p, scene_id=sid)
    recs = _records(tracker)
    assert [r["serve_scene"] for r in recs] == list("abcd")
    assert all(r["serve_quant"] == "int8" and r["serve_mode"] == "grid"
               for r in recs)
    assert all(r.get("serve_pipelined", False) == pipelined for r in recs)
    for i in (0, 2):
        assert "serve_clip_worst_site" not in recs[i], i
    for i in (1, 3):
        assert recs[i]["serve_clip_worst_site"] in pred._scales, i
        assert recs[i]["serve_clip_worst_ratio"] > 0, i


def test_serve_records_exact(tmp_path):
    from fabric_tpu_torch.track import Tracker
    tracker = Tracker(str(tmp_path), run_name="serve")
    pred = ScenePredictor(Config(patch_size=16, eval_batch_size=8,
                                 dtype="float32", model_base=8),
                          bucket=32, device="cpu", tracker=tracker)
    rng = np.random.RandomState(11)
    pred.predict(*_scene(rng, 45, 53), scene_id="alpha")
    pred.predict(*_scene(rng, 40, 50))
    first, second = _records(tracker)
    assert first["serve_scene"] == "alpha"
    assert (first["serve_height"], first["serve_width"]) == (45, 53)
    assert (first["serve_bucket_h"], first["serve_bucket_w"]) == (64, 64)
    assert first["serve_compiled"] and not second["serve_compiled"]
    assert first["serve_quant"] == "none"
    assert first["serve_wall_ms"] > 0 and first["serve_mpx_per_sec"] > 0


# --- the tools and the CLI, end to end on a tiny synthetic dataset ---

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 64x48 synthetic city (served in the 512^2 bucket) and a
    checkpoint of fresh base-4 weights."""
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    from fabric_tpu_torch.train.state import create_state
    root = tmp_path_factory.mktemp("v8")
    cfg = Config(dataset_dir=str(root / "data"), weight_dir=str(root / "w"),
                 log_dir=str(root / "logs"), patch_size=16, dtype="float32",
                 model_base=4, validation_cities=["alpha"],
                 resume=str(root / "w"))
    generate_synthetic_dataset(cfg.dataset_dir, cfg, cities=["alpha"],
                               sizes=[(64, 48)])
    state = create_state(cfg, build_model(cfg, "cpu", fold_bn=False,
                                          train=True))
    ckpt.save(state, cfg.weight_dir, epoch=0)
    return cfg


def _cli_args(cfg):
    return ["--dataset_dir", cfg.dataset_dir, "--resume", cfg.weight_dir,
            "--patch_size", "16", "--dtype", "float32", "--model_base", "4",
            "--validation_cities", '["alpha"]', "--log_dir", cfg.log_dir,
            "--device", "cpu"]


def test_validate_int8_gate(dataset, capsys):
    from fabric_tpu_torch.tools.validate_int8 import main, validate
    # the same city twice: the first calibrates, the second is probed
    args = _cli_args(dataset) + ["--city", "alpha", "--city", "alpha"]
    assert main(args + ["--max_f1_drop", "1.0"]) == 0
    first, second, summary = [
        json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert first["city"] == "alpha" and 0.0 <= first["mask_agreement"] <= 1
    assert {"f1_bf16", "f1_int8", "f1_delta"} <= set(first)
    assert "clip_overflow_ratio" not in first  # it calibrated
    assert second["clip_overflow_ratio"] > 0  # it was probed
    assert first["verdict"] == second["verdict"] == "ok"
    assert summary == {"summary": "ok", "cities": 2, "max_f1_drop": 1.0,
                       "min_agreement": 0.95}
    # an impossible budget takes the FAIL exit
    assert main(_cli_args(dataset) + ["--max_f1_drop", "-1.0"]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["verdict"] == lines[-1]["summary"] == "FAIL"
    # a serving bundle of the same checkpoint gives both predictors
    from fabric_tpu_torch.tools.export import export_bundle
    bundle = os.path.join(dataset.weight_dir, "..", "gate_bundle.npz")
    export_bundle(dataset, dataset.weight_dir, bundle, device="cpu")
    reports, ok = validate(dataset, bundle=bundle, max_f1_drop=1.0,
                           min_agreement=0.0, device="cpu")
    assert ok and [r["city"] for r in reports] == ["alpha"]
    assert {"f1_bf16", "f1_int8", "mask_agreement"} <= set(reports[0])


@pytest.mark.parametrize("quant", ["int8", None])
def test_cli_infer_writes_masks_and_records(dataset, tmp_path, quant):
    from fabric_tpu_torch.cli.infer import main
    from fabric_tpu_torch.data.image import read_png_gray
    out = tmp_path / "masks"
    args = _cli_args(dataset) + ["--output_dir", str(out), "--log_dir",
                                 str(tmp_path / "logs")]
    assert main(args + (["--quant", quant] if quant else [])) == 0
    mask = read_png_gray(str(out / "alpha_mask.png"))
    assert mask.shape == (64, 48) and set(np.unique(mask)) <= {0, 255}
    run = next((tmp_path / "logs").iterdir())
    (rec,) = [json.loads(x) for x in (run / "metrics.jsonl").read_text()
              .splitlines()]
    assert rec["serve_scene"] == "alpha"
    assert rec["serve_quant"] == (quant or "none")
    assert rec["serve_mode"] == ("grid" if quant else "reference_grid")
    assert json.loads((run / "status.json").read_text())["status"] == \
        "succeeded"


@pytest.mark.parametrize("flag", [["--bundle", "b.npz"],
                                  ["--aot_dir", "a"],
                                  ["--shard_scene", "--mesh_spatial", "2"]])
def test_cli_infer_unported_options_raise(flag, dataset, tmp_path):
    """--mesh_spatial > 1 is ported (item 10c): on a CPU mesh of matching
    size the scene is sharded over the data axis, the spatial axis holding
    replicas, and the mask is the data-only mesh's; --bundle and
    --aot_dir are (item 11): they reach the serving path, which here finds
    no bundle and no artifact there (tests/test_torch_export.py and
    tests/test_torch_aot.py serve real ones)."""
    from fabric_tpu_torch.cli.infer import main
    from fabric_tpu_torch.data.image import read_png_gray
    if "--mesh_spatial" in flag:
        masks = []
        for run, extra in (("spatial", flag), ("data", flag[:1])):
            out = tmp_path / run
            assert main(_cli_args(dataset) + [
                "--log_dir", str(tmp_path / "logs"), "--no_tracker",
                "--output_dir", str(out)] + extra) == 0
            masks.append(read_png_gray(str(out / "alpha_mask.png")))
        np.testing.assert_array_equal(masks[0], masks[1])
        return
    args = _cli_args(dataset) + ["--log_dir", str(tmp_path / "logs"),
                                 flag[0], str(tmp_path / flag[1])]
    with pytest.raises(FileNotFoundError,
                       match="b.npz" if flag[0] == "--bundle"
                       else "aot_meta.json"):
        main(args)


def test_unported_int8_families_raise(folded):
    """An unknown family has no int8 forward (the multi-date ones are
    ported: tests/test_torch_quant_multidate.py; int8 with local_upsample
    is held to fabric_tpu's in tests/test_torch_fullconv.py)."""
    tree = tq.folded_params(folded[1])
    with pytest.raises(ValueError, match="no int8 forward"):
        tq.make_int8_apply(tree, {}, model="fullconv_net")


def test_microbench_int8_matmul_on_cpu():
    from fabric_tpu_torch.tools.ablate_train import microbench_int8_matmul
    out = microbench_int8_matmul(64, 96, 40, iters=1, device="cpu")
    assert out["kernel_int8_exact"] is True and out["device"] == "cpu"
    for form in ("torch_bf16", "torch_int8", "kernel_bf16", "kernel_int8"):
        assert out[f"{form}_ms"] > 0, form
