"""Ahead-of-time serving artifacts in the port (fabric_tpu_torch.infer.aot,
ScenePredictor(aot_dir=...)), case by case as tests/test_aot.py holds
fabric_tpu's: scene runners frozen with torch.export, written beside an
aot_meta.json and served with masks bit-identical to the in-process
runners.  On the CPU the programs' kernel ops run their plain versions;
the graphs hold the ops, which the card runs as its kernels.  Patch 16,
base 8, eval batch 8, 40x56 scenes in 64x64 buckets; each artifact is
exported once, in a module-scoped fixture."""

import logging

import numpy as np
import pytest
import torch

from fabric_tpu.infer.aot import params_fingerprint as jax_fingerprint
from fabric_tpu.config import Config as JaxConfig
from fabric_tpu.infer.service import ScenePredictor as JaxPredictor

from fabric_tpu_torch import Config
from fabric_tpu_torch.infer import aot
from fabric_tpu_torch.infer.aot import (export_aot, export_runners, load_aot,
                                        load_serialized_runner, read_meta,
                                        save_aot)
from fabric_tpu_torch.infer.service import ScenePredictor
from test_torch_export import save_checkpoint

SHAPE = (40, 56)  # the 64x64 bucket at bucket 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    return Config(**{"patch_size": 16, "dtype": "float32", "model_base": 8,
                     "eval_batch_size": 8, **kw})


def _pred(cfg=None, **kw):
    return ScenePredictor(cfg or _cfg(), bucket=32, device="cpu", **kw)


def _scene(shape, seed):
    return np.random.RandomState(seed).randn(*shape, 13).astype(np.float32)


def _calib(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(4, 16, 16, 13).astype(np.float32),
             rng.randn(4, 16, 16, 13).astype(np.float32))]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(predictor, artifact dir): grid bf16 runners of the 64x64 bucket,
    single and packed by 2."""
    base = _pred()
    d = str(tmp_path_factory.mktemp("grid"))
    export_aot(base, d, [SHAPE], platforms=("cpu",), packs=[2])
    return base, d


@pytest.fixture(scope="module")
def int8(tmp_path_factory):
    """(calibrated int8 predictor, artifact dir), single and packed by 2."""
    base = _pred(quant="int8")
    base.calibrate(_calib(6))
    d = str(tmp_path_factory.mktemp("int8"))
    export_aot(base, d, [SHAPE], platforms=("cpu",), packs=[2])
    return base, d


def test_roundtrip_and_bit_identity(tmp_path):
    """Grid mode: export -> save -> serve via aot_dir, masks equal to the
    in-process predictor's byte for byte."""
    d1, d2 = _scene(SHAPE, 0), _scene(SHAPE, 1)
    base = _pred()
    runners = export_runners(base, [SHAPE], platforms=("cpu",))
    assert list(runners) == [(64, 64)]  # keyed by the padded bucket
    save_aot(str(tmp_path), runners, {"model": "bidate", "quant": "none",
                                      "fullconv_band_rows": 0})
    assert load_aot(str(tmp_path), 64, 64, device="cpu") is not None
    assert load_aot(str(tmp_path), 96, 96, device="cpu") is None
    served = _pred(aot_dir=str(tmp_path))
    np.testing.assert_array_equal(served.predict(d1, d2),
                                  base.predict(d1, d2))
    assert served._aot_keys == {(64, 64)}


def test_export_aot_meta_and_fallback(grid, caplog, tmp_path):
    """export_aot writes the frozen configuration; a bucket the artifact
    lacks falls back to the in-process runner with a warning, with the
    in-process masks; each scene's record says whether its runner came
    from the artifact."""
    from fabric_tpu_torch.track import Tracker
    base, d = grid
    meta = read_meta(d)
    assert meta["model"] == "bidate" and meta["quant"] == "none"
    assert meta["shapes"] == [[64, 64]]
    assert meta["packed_shapes"] == [[64, 64, 2]]
    assert meta["platforms"] == ["cpu"] and meta["bucket"] == 32
    assert meta["dtype"] == "float32" and meta["num_dates"] == 0
    assert len(meta["weights_sha256"]) == 64
    assert set(meta["ops"]) == {"runner_64x64.pt2", "runner_64x64_pack2.pt2"}
    tracker = Tracker(str(tmp_path), run_name="serve")
    served = _pred(aot_dir=d, tracker=tracker)
    d1, d2 = _scene((90, 90), 2), _scene((90, 90), 3)  # 96x96: not exported
    with caplog.at_level(logging.WARNING, logger="fabric_tpu_torch"):
        got = served.predict(d1, d2)
    assert any("falling back" in r.message for r in caplog.records)
    np.testing.assert_array_equal(got, base.predict(d1, d2))
    served.predict(_scene(SHAPE, 4), _scene(SHAPE, 5))
    tracker.close()
    import json
    with open(f"{tracker.dir}/metrics.jsonl") as fin:
        recs = [json.loads(line) for line in fin]
    assert [r["serve_aot"] for r in recs] == [False, True]


def test_int8_aot_bit_identity_and_scale_pinning(int8):
    """int8: the artifact pins the calibration scales; serving from it
    gives the calibrated in-process masks bit for bit, seeds the scales
    from the meta (no first-scene calibration), and refuses calibrate and
    recalibrate_every."""
    base, d = int8
    assert read_meta(d)["int8_scales"] == base._scales
    served = _pred(quant="int8", aot_dir=d)
    assert served._scales == base._scales  # seeded, not recalibrated
    d1, d2 = _scene(SHAPE, 4), _scene(SHAPE, 5)
    np.testing.assert_array_equal(served.predict(d1, d2),
                                  base.predict(d1, d2))
    assert served._scales == base._scales
    with pytest.raises(ValueError, match="pinned"):
        served.calibrate(_calib(6))
    with pytest.raises(ValueError, match="recalibrate_every"):
        _pred(quant="int8", aot_dir=d, recalibrate_every=2)


def test_int8_export_guards():
    """Export refuses an int8 predictor whose scales could still move:
    uncalibrated, or recalibrate_every > 0."""
    with pytest.raises(ValueError, match="calibrated"):
        export_runners(_pred(quant="int8"), [SHAPE], platforms=("cpu",))
    cal = _pred(quant="int8", recalibrate_every=3)
    cal.calibrate(_calib(7))
    with pytest.raises(ValueError, match="recalibrate_every"):
        export_runners(cal, [SHAPE], platforms=("cpu",))


def test_config_mismatch_rejected(grid):
    """An artifact frozen from another serving configuration is refused."""
    _, d = grid
    with pytest.raises(ValueError, match="quant"):
        _pred(quant="int8", aot_dir=d)
    with pytest.raises(ValueError, match="model"):
        _pred(_cfg(model="unet_lstm", num_dates=3), aot_dir=d)
    with pytest.raises(ValueError, match="dtype"):
        _pred(_cfg(dtype="bfloat16"), aot_dir=d)


def test_weights_mismatch_rejected(grid, tmp_path):
    """The programs hold the export-time weights: a predictor of other
    weights is refused at start; the same weights pass."""
    _, d = grid
    run = save_checkpoint(_cfg(), str(tmp_path / "run"), seed=1)
    with pytest.raises(ValueError, match="different weights"):
        _pred(checkpoint=run, aot_dir=d)
    _pred(aot_dir=d)


def test_platform_mismatch_rejected(tmp_path):
    """An artifact for the card, exported on this CPU host (its tensors
    kept on the CPU, moved to the card when it loads there), is refused
    by a predictor serving on the CPU."""
    base = _pred()
    meta = export_aot(base, str(tmp_path), [SHAPE], platforms=("cuda",))
    assert meta["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="platforms"):
        _pred(aot_dir=str(tmp_path))
    with pytest.raises(ValueError, match="platforms"):
        export_runners(base, [SHAPE], platforms=("tpu",))


def test_fingerprint_checkpoint_vs_bundle_and_fabric_tpu(tmp_path):
    """The weights' digest is the same from a checkpoint (folded here) and
    from its bundle (folded at export), run to run, and equal to
    fabric_tpu's params_fingerprint of the same weights."""
    from fabric_tpu_torch.tools.export import export_bundle
    cfg = _cfg()
    run = save_checkpoint(cfg, str(tmp_path / "run"))
    export_bundle(cfg, run, str(tmp_path / "b.npz"))
    p_ck = _pred(checkpoint=run)
    p_bn = _pred(bundle=str(tmp_path / "b.npz"))
    digest = aot.params_fingerprint(p_ck.variables())
    assert digest == aot.params_fingerprint(p_bn.variables())
    assert digest == aot.params_fingerprint(_pred(checkpoint=run).variables())
    jax_pred = JaxPredictor(JaxConfig(patch_size=16, dtype="float32",
                                      model_base=8),
                            bundle=str(tmp_path / "b.npz"), bucket=32)
    assert digest == jax_fingerprint(jax_pred.variables)
    # unfolded: the params and the BatchNorm statistics
    unfolded = _pred(checkpoint=run, fold_bn=False)
    assert aot.params_fingerprint(unfolded.variables()) != digest


def test_bucket_mismatch_rejected(grid):
    """Another bucket would miss every artifact key: refused at start."""
    _, d = grid
    with pytest.raises(ValueError, match="bucket"):
        ScenePredictor(_cfg(), bucket=64, device="cpu", aot_dir=d)


def test_streamed_and_sharded_rejected(grid):
    from fabric_tpu_torch.parallel.mesh import make_mesh
    _, d = grid
    with pytest.raises(ValueError, match="in-process"):
        _pred(aot_dir=d, fullconv_band_rows=160, fullconv_stream=True)
    streamed = _pred(fullconv_band_rows=160, fullconv_stream=True)
    with pytest.raises(ValueError, match="in-process"):
        export_runners(streamed, [SHAPE], platforms=("cpu",))
    mesh = make_mesh(2, devices=["cpu"] * 2)
    sharded = _pred(mesh=mesh, shard_scene=True)
    with pytest.raises(ValueError, match="in-process"):
        export_runners(sharded, [SHAPE], platforms=("cpu",))
    with pytest.raises(ValueError, match="in-process"):
        _pred(mesh=mesh, shard_scene=True, aot_dir=d)


def test_fullconv_aot_bit_identity(tmp_path):
    """The in-device-memory fullconv runner freezes too: masks equal to
    the in-process fullconv predictor's; its band rows are pinned."""
    d1, d2 = _scene((200, 64), 8), _scene((200, 64), 9)
    base = _pred(fullconv_band_rows=160)
    export_aot(base, str(tmp_path), [(200, 64)], platforms=("cpu",))
    served = _pred(fullconv_band_rows=160, aot_dir=str(tmp_path))
    np.testing.assert_array_equal(served.predict(d1, d2),
                                  base.predict(d1, d2))
    assert served._aot_keys == {(224, 64)}
    with pytest.raises(ValueError, match="fullconv_band_rows"):
        _pred(aot_dir=str(tmp_path))


@pytest.mark.parametrize("banded", [False, True])
def test_overlap_aot_bit_identity(tmp_path, banded):
    """Overlap (probabilities averaged over overlapping tiles) and banded
    overlap freeze: masks equal to the in-process runner's."""
    cfg = _cfg(infer_overlap=8)
    kw = dict(overlap_band_rows=2) if banded else {}
    base = _pred(cfg, **kw)
    export_aot(base, str(tmp_path), [SHAPE], platforms=("cpu",))
    served = _pred(cfg, aot_dir=str(tmp_path), **kw)
    d1, d2 = _scene(SHAPE, 14), _scene(SHAPE, 15)
    np.testing.assert_array_equal(served.predict(d1, d2),
                                  base.predict(d1, d2))
    assert served._aot_keys == {(64, 64)}


def test_export_cli_emits_aot(tmp_path):
    """tools.export --aot_dir: one command writes the bundle and the frozen
    runners; serving from both matches serving the bundle in process;
    --aot_fullconv freezes the fullconv runner instead."""
    from fabric_tpu_torch.tools.export import main
    run = save_checkpoint(_cfg(), str(tmp_path / "run"))
    common = ["--resume", run, "--patch_size", "16", "--model_base", "8",
              "--dtype", "float32", "--eval_batch_size", "8", "--device",
              "cpu", "--aot_platform", "cpu", "--aot_bucket", "32"]
    out, d = str(tmp_path / "bundle.npz"), str(tmp_path / "aot")
    assert main(common + ["--out", out, "--aot_dir", d, "--aot_scene",
                          "40x56"]) == 0
    assert read_meta(d)["shapes"] == [[64, 64]]
    d1, d2 = _scene(SHAPE, 10), _scene(SHAPE, 11)
    served = _pred(bundle=out, aot_dir=d)
    np.testing.assert_array_equal(served.predict(d1, d2),
                                  _pred(bundle=out).predict(d1, d2))
    assert served._aot_keys == {(64, 64)}

    out_fc, d_fc = str(tmp_path / "bundle_fc.npz"), str(tmp_path / "aot_fc")
    assert main(common + ["--out", out_fc, "--aot_dir", d_fc,
                          "--aot_scene", "200x64", "--aot_fullconv",
                          "160"]) == 0
    assert read_meta(d_fc)["fullconv_band_rows"] == 160
    s1, s2 = _scene((200, 64), 12), _scene((200, 64), 13)
    served = _pred(bundle=out_fc, fullconv_band_rows=160, aot_dir=d_fc)
    np.testing.assert_array_equal(
        served.predict(s1, s2),
        _pred(bundle=out_fc, fullconv_band_rows=160).predict(s1, s2))


def test_cli_infer_bundle_and_aot(tmp_path):
    """cli.infer --bundle --aot_dir (no --resume) serves a city from the
    artifact: its mask is the in-process one and its record says aot."""
    import json

    from fabric_tpu_torch.cli.infer import main
    from fabric_tpu_torch.data.image import read_png_gray
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    from fabric_tpu_torch.infer.runner import load_scene
    from fabric_tpu_torch.tools.export import export_bundle
    cfg = _cfg(dataset_dir=str(tmp_path / "data"),
               validation_cities=["alpha"])
    generate_synthetic_dataset(cfg.dataset_dir, cfg, cities=["alpha"],
                               sizes=[SHAPE])
    run = save_checkpoint(_cfg(), str(tmp_path / "run"))
    out, d = str(tmp_path / "b.npz"), str(tmp_path / "aot")
    export_bundle(cfg, run, out)
    export_aot(_pred(bundle=out), d, [SHAPE], platforms=("cpu",))
    assert main(["--bundle", out, "--aot_dir", d, "--bucket", "32",
                 "--dataset_dir", cfg.dataset_dir, "--patch_size", "16",
                 "--model_base", "8", "--dtype", "float32",
                 "--eval_batch_size", "8", "--validation_cities",
                 '["alpha"]', "--output_dir", str(tmp_path / "masks"),
                 "--log_dir", str(tmp_path / "logs"), "--device",
                 "cpu"]) == 0
    mask = read_png_gray(str(tmp_path / "masks" / "alpha_mask.png"))
    scene = load_scene(cfg, "alpha")
    want = _pred(bundle=out).predict(scene[0], scene[1])
    np.testing.assert_array_equal(mask, want * 255)
    run_log = next((tmp_path / "logs").iterdir())
    (rec,) = [json.loads(x) for x in
              (run_log / "metrics.jsonl").read_text().splitlines()]
    assert rec["serve_aot"] is True and rec["serve_mode"] == "grid"


def test_packed_aot_bit_identity_and_fallback(grid, caplog):
    """export_aot(packs=[2]) freezes the fleet-packed runner: predict_many
    (pack=2) from the artifact gives the in-process packed masks; pack 3
    falls back with a warning; packs= is refused outside grid mode."""
    base, d = grid
    assert load_aot(d, 64, 64, pack=2, device="cpu") is not None
    assert load_aot(d, 64, 64, pack=3, device="cpu") is None
    pairs = [(_scene(SHAPE, 20 + i), _scene(SHAPE, 30 + i))
             for i in range(3)]  # 3 scenes: one full pack and one partial
    served = _pred(aot_dir=d)
    for a, b in zip(served.predict_many(pairs, pack=2),
                    base.predict_many(pairs, pack=2)):
        np.testing.assert_array_equal(a, b)
    assert (64, 64, 2, "packed") in served._aot_keys
    with caplog.at_level(logging.WARNING, logger="fabric_tpu_torch"):
        got = served.predict_many(pairs, pack=3)
    assert any("falling back" in r.message for r in caplog.records)
    for a, b in zip(got, base.predict_many(pairs, pack=3)):
        np.testing.assert_array_equal(a, b)
    fc = _pred(fullconv_band_rows=160)
    with pytest.raises(ValueError, match="grid"):
        export_runners(fc, [SHAPE], platforms=("cpu",), packs=[2])


def test_packed_aot_int8(int8):
    """int8 packed artifacts pin the scales too: fleet serving from the
    artifact matches the calibrated in-process packed masks."""
    base, d = int8
    served = _pred(quant="int8", aot_dir=d)
    pairs = [(_scene(SHAPE, 40 + i), _scene(SHAPE, 50 + i))
             for i in range(2)]
    for a, b in zip(served.predict_many(pairs, pack=2),
                    base.predict_many(pairs, pack=2)):
        np.testing.assert_array_equal(a, b)
    assert (64, 64, 2, "packed") in served._aot_keys


@pytest.mark.parametrize("model", ["unet_lstm", "unet3d"])
def test_multidate_aot_bit_identity(tmp_path, model):
    """Multi-date runners freeze (the (T, H, W, C) signature): masks equal
    to the in-process predictor's."""
    cfg = _cfg(model=model, num_dates=3)
    stack = np.random.RandomState(12).randn(3, *SHAPE, 13).astype(
        np.float32)
    base = _pred(cfg)
    meta = export_aot(base, str(tmp_path), [SHAPE], platforms=("cpu",))
    assert meta["num_dates"] == 3
    served = _pred(cfg, aot_dir=str(tmp_path))
    np.testing.assert_array_equal(served.predict_multidate(stack),
                                  base.predict_multidate(stack))


def _call_targets(program) -> list:
    return [n.target for n in program.graph.nodes
            if n.op == "call_function"]


def test_graph_holds_the_kernel_ops(grid, int8):
    """An artifact is the forward of one chunk (8 tiles; the 64x64
    bucket's runner makes 2): the folded bf16 model makes 18 conv launches
    (9 DoubleConvs, none passing the fused gate at base 8) and 5 fusions,
    the int8 forward 18 conv sites and 5 fusions.  No aten convolution
    stands in for a folded conv, and the packing is not in the graph; the
    unfolded model's eval-BatchNorm kernel is an op too (18 a forward,
    beside its convs)."""
    assert read_meta(grid[1])["ops"]["runner_64x64.pt2"] == {
        "conv3x3_bias_relu": 18, "fused_mul_relu": 5}
    assert read_meta(int8[1])["ops"]["runner_64x64.pt2"] == {
        "conv3x3_s8_q": 18, "siamese_fuse_s8": 5}
    assert read_meta(grid[1])["ops"]["runner_64x64_pack2.pt2"] == {
        "conv3x3_bias_relu": 18, "fused_mul_relu": 5}
    for d, packed_arg in ((grid[1], 3), (int8[1], 5)):
        program = torch.export.load(f"{d}/runner_64x64.pt2")
        names = {str(t) for t in _call_targets(program)}
        assert not {n for n in names if "conv" in n and "aten" in n}, names
        # each conv's packed weights are a constant of the program, not
        # packed in its graph
        convs = [n for n in program.graph.nodes if n.op == "call_function"
                 and str(n.target).startswith("fabric_tpu_torch.conv3x3")]
        assert len(convs) == 18
        assert all(n.args[packed_arg].op == "placeholder" for n in convs)
    unfolded = _pred(fold_bn=False)
    (program,) = export_runners(unfolded, [SHAPE],
                                platforms=("cpu",)).values()
    assert aot.kernel_ops(program) == {"bn_relu_inference": 18,
                                       "fused_mul_relu": 5}
    # a bf16 model at base 64 takes the fused double conv where its gate
    # holds (down2-4, up2 at patch 64 are 4 of its 9 blocks)
    from fabric_tpu_torch.ops import double_conv
    assert double_conv.supports(16, 16, 128, 256, 256)


def test_load_aot_refuses_graph_without_ops(grid, tmp_path):
    """A program whose kernels were traced as plain PyTorch must not
    serve: a file the meta records no ops for is refused, and so is a
    graph whose ops differ from the meta's record."""
    import json
    import shutil

    class Plain(torch.nn.Module):
        def forward(self, s1, s2):
            return ((s1 * s2).sum(-1) > 0).to(torch.uint8)

    scene = torch.zeros(64, 64, 13)
    plain = torch.export.export(Plain(), (scene, scene), strict=False)
    d = tmp_path / "art"
    shutil.copytree(grid[1], d)
    torch.export.save(plain, str(d / "runner_64x64.pt2"))
    with pytest.raises(ValueError, match="holds kernel ops"):
        load_aot(str(d), 64, 64, device="cpu")
    meta = json.loads((d / "aot_meta.json").read_text())
    del meta["ops"]["runner_64x64.pt2"]
    (d / "aot_meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="records no kernel ops"):
        load_aot(str(d), 64, 64, device="cpu")


def test_loaders_default_to_the_card(grid):
    """load_aot and load_serialized_runner without a device load onto the
    card: on a host without one they raise rather than serve on the CPU
    (with device="cpu" the same artifact loads)."""
    if torch.cuda.is_available():
        pytest.skip("holds the refusal on a host without a card")
    d = grid[1]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_aot(d, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_serialized_runner(f"{d}/runner_64x64.pt2")
    assert load_aot(d, 64, 64, device="cpu") is not None
