"""tools/import_torch in the port against fabric_tpu's on the CPU: a
reference-layout torch checkpoint (OIHW, ``inc.conv.conv.0.weight``, ...)
built here from seeded weights, bare, with DataParallel's ``module.``
prefix and as a whole pickled module, imported by both packages.  The
trees restore bit-equal across packages either way round, and the port's
predictor serves fabric_tpu's mask from it (fp32: equal, the serving
tests' rule at fp32)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabric_tpu import checkpoint as jax_ckpt
from fabric_tpu.config import Config as JaxConfig
from fabric_tpu.infer.device_tiling import make_scene_infer as jax_scene_infer
from fabric_tpu.models import BiDateNet as JaxBiDateNet
from fabric_tpu.ops.fold_bn import fold_batchnorm
from fabric_tpu.tools import import_torch as jax_import
from fabric_tpu.train.state import create_state as jax_create_state

from fabric_tpu_torch import checkpoint, weights
from fabric_tpu_torch.config import Config
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.tools import import_torch

BASE = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(n_channels=13):
    params, stats = weights.init_variables(
        n_channels, 2, BASE, torch.Generator().manual_seed(4))
    rng = np.random.RandomState(4)
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
    params["outc"]["conv"]["bias"] = np.float32([0.05, -0.05])
    return params, stats


def reference_state_dict(params, stats, prefix=""):
    """The reference BiDateNet's state_dict for a variable tree, written
    out here key by key (independent of the tool's mapping)."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(p["kernel"].transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(p["bias"].copy())

    def bn(name, p, s):
        sd[f"{name}.weight"] = torch.from_numpy(p["scale"].copy())
        sd[f"{name}.bias"] = torch.from_numpy(p["bias"].copy())
        sd[f"{name}.running_mean"] = torch.from_numpy(s["mean"].copy())
        sd[f"{name}.running_var"] = torch.from_numpy(s["var"].copy())
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    def double(name, p, s):
        conv(f"{name}.0", p["conv1"])
        bn(f"{name}.1", p["bn1"], s["bn1"])
        conv(f"{name}.3", p["conv2"])
        bn(f"{name}.4", p["bn2"], s["bn2"])

    double("inc.conv.conv", params["inc"], stats["inc"])
    for name in ("down1", "down2", "down3", "down4"):
        double(f"{name}.mpconv.1.conv", params[name]["conv"],
               stats[name]["conv"])
    for name in ("up1", "up2", "up3", "up4"):
        double(f"{name}.conv.conv", params[name]["conv"],
               stats[name]["conv"])
    conv("outc.conv", params["outc"]["conv"])
    return {prefix + k: v for k, v in sd.items()}


def _module_of(sd):
    """A whole module holding ``sd`` under its names, as the reference's
    ``torch.save(model, ...)`` pickles one."""
    root = torch.nn.Module()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        node = root
        for name in path:
            if not hasattr(node, name):
                node.add_module(name, torch.nn.Module())
            node = getattr(node, name)
        node.register_buffer(leaf, value)
    return root


def _flat(tree):
    return weights.flatten_tree(tree)


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """The reference checkpoint (bare) imported by each package."""
    root = tmp_path_factory.mktemp("import_torch")
    variables = _variables()
    pt = str(root / "ref.pt")
    torch.save(reference_state_dict(*variables), pt)
    port = import_torch.import_checkpoint(pt, str(root / "port"),
                                          device="cpu")
    jax = jax_import.import_checkpoint(pt, str(root / "jax"))
    return variables, pt, port, jax


def _jax_template():
    """fabric_tpu's restore template: a state of zero trees (restore
    replaces every leaf)."""
    params, stats = (jax_tree_zeros(t) for t in _variables())
    return jax_create_state(JaxConfig(model_base=BASE),
                            JaxBiDateNet(base=BASE, dtype=jnp.float32),
                            variables={"params": params,
                                       "batch_stats": stats})


def jax_tree_zeros(tree):
    return {k: jax_tree_zeros(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


def test_trees_restore_bit_equal_across_packages(imported):
    """The port's import restores in fabric_tpu, fabric_tpu's in the port,
    each with the seeded trees bit for bit; the metadata is the same."""
    (params, stats), pt, port, jax = imported
    _assert_trees_equal(checkpoint.load_variables(port)[0], params)
    _assert_trees_equal(checkpoint.load_variables(port)[1], stats)
    restored = jax_ckpt.restore(_jax_template(), port)
    _assert_trees_equal(restored.params, params)
    _assert_trees_equal(restored.batch_stats, stats)
    for got, want in zip(checkpoint.load_variables(jax), (params, stats)):
        _assert_trees_equal(got, want)
    metas = [checkpoint.read_payload(p)["meta_json"] for p in (port, jax)]
    assert json.loads(metas[0]) == json.loads(metas[1]) == {
        "imported_from": pt, "source_format": "torch", "n_channels": 13,
        "base": BASE, "n_classes": 2, "epoch": 0, "step": 0}
    for d in (os.path.dirname(port), os.path.dirname(jax)):
        assert checkpoint.read_pointer(d, "best") == \
            checkpoint.read_pointer(d, "latest")


@pytest.mark.parametrize("form", ["module_prefix", "pickled_module"])
def test_saved_forms_convert_alike(imported, form, tmp_path):
    """DataParallel's ``module.`` prefix and a whole pickled module give the
    bare state_dict's trees, in both packages."""
    (params, stats), _, _, _ = imported
    sd = reference_state_dict(params, stats,
                              "module." if form == "module_prefix" else "")
    pt = str(tmp_path / "ref.pt")
    torch.save(sd if form == "module_prefix" else _module_of(sd), pt)
    got = import_torch.convert_state_dict(import_torch.load_state_dict(pt))
    want = jax_import.convert_state_dict(jax_import.load_state_dict(pt))
    for g, w in zip(got[:2], want[:2]):
        _assert_trees_equal(g, w)
    _assert_trees_equal(got[0], params)
    assert got[2] == want[2] == {"n_channels": 13, "base": BASE,
                                 "n_classes": 2}


def test_imported_checkpoint_serves_fabric_tpus_mask(imported):
    """The port's predictor on its import, and fabric_tpu's grid serving
    (``make_scene_infer`` on the folded weights its checkpoint restores)
    on its own: a 64 x 96 scene at fp32, masks equal."""
    _, _, port, jax = imported
    rng = np.random.RandomState(6)
    d1, d2 = (rng.randn(64, 96, 13).astype(np.float32) for _ in range(2))
    cfg = Config(patch_size=32, eval_batch_size=4, dtype="float32",
                 model_base=BASE)
    got = ScenePredictor(cfg, checkpoint=os.path.dirname(port), bucket=32,
                         device="cpu").predict(d1, d2)
    state = jax_ckpt.restore(_jax_template(), jax)
    run = jax_scene_infer(
        JaxBiDateNet(base=BASE, fold_bn=True, split_up_concat=True,
                     dtype=jnp.float32), 32, (64, 96), batch_size=4,
        dtype=jnp.float32)
    want = np.asarray(run({"params": fold_batchnorm(state.params,
                                                    state.batch_stats),
                           "batch_stats": {}}, d1, d2))
    assert got.shape == (64, 96) and 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)


def test_other_channel_counts_are_refused(tmp_path):
    """A 4-band checkpoint: both packages refuse it with one message."""
    pt = str(tmp_path / "ref4.pt")
    torch.save(reference_state_dict(*_variables(n_channels=4)), pt)
    messages = []
    for fn, kw in ((import_torch.import_checkpoint, {"device": "cpu"}),
                   (jax_import.import_checkpoint, {})):
        with pytest.raises(ValueError, match=r"BiDateNet\(4, 2\)") as e:
            fn(pt, str(tmp_path / "out"), **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert not os.path.exists(tmp_path / "out")


def test_cli_writes_a_checkpoint_directory(imported, tmp_path):
    (params, stats), pt, _, _ = imported
    out = str(tmp_path / "ckpt")
    assert import_torch.main(["--pt", pt, "--out", out,
                              "--device", "cpu"]) == 0
    best = checkpoint.read_pointer(out, "best")
    assert best is not None and best.endswith("checkpoint_epoch_0.msgpack")
    _assert_trees_equal(checkpoint.load_variables(best)[0], params)
