"""The port imports neither JAX, flax, optax nor anything of fabric_tpu:
every module of the package, and every module chip_smoke.py imports
(found by parsing its source), load in a fresh interpreter with none of
them in sys.modules."""

import ast
import glob
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fabric_tpu")


def _loaded_after(imports):
    code = "\n".join(
        [*(f"import {m}" for m in imports),
         "import sys",
         "print('\\n'.join(sorted(sys.modules)))"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    return [m for m in out if m.split(".")[0] in FORBIDDEN]


def _modules_imported_by(path):
    tree = ast.parse(open(path).read())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module)
    return sorted(found)


def test_port_imports_no_jax_or_fabric_tpu():
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__")
        for p in glob.glob(os.path.join(REPO, "fabric_tpu_torch", "**",
                                        "*.py"), recursive=True))
    assert {"fabric_tpu_torch.train.loop", "fabric_tpu_torch.evaluate",
            "fabric_tpu_torch.cli.evaluate", "fabric_tpu_torch.store",
            "fabric_tpu_torch.data.download",
            "fabric_tpu_torch.data.loader",
            "fabric_tpu_torch.models.unet_lstm",
            "fabric_tpu_torch.models.unet3d",
            "fabric_tpu_torch.infer.quant_multidate",
            "fabric_tpu_torch.infer.fullconv",
            "fabric_tpu_torch.infer.sharded_scene",
            "fabric_tpu_torch.parallel",
            "fabric_tpu_torch.parallel.distributed",
            "fabric_tpu_torch.parallel.mesh",
            "fabric_tpu_torch.parallel.spatial",
            "fabric_tpu_torch.utils.profiling",
            "fabric_tpu_torch.tools.export",
            "fabric_tpu_torch.infer.aot",
            "fabric_tpu_torch.ops.s2d_conv",
            "fabric_tpu_torch.tools.import_torch",
            "fabric_tpu_torch.tools.band_stats",
            "fabric_tpu_torch.tools.make_labels",
            "fabric_tpu_torch.tools.get_data",
            "fabric_tpu_torch.tools.tune",
            "fabric_tpu_torch.tools.ablate",
            "fabric_tpu_torch.tools.ablate_train"} <= set(modules)
    assert _loaded_after(modules) == []


def test_chip_smoke_imports_no_jax_or_fabric_tpu():
    mods = _modules_imported_by(os.path.join(REPO, "chip_smoke.py"))
    assert {"fabric_tpu_torch.infer.service",
            "fabric_tpu_torch.train.loop"} <= set(mods)
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert _loaded_after(mods + ["chip_smoke"]) == []


def test_cuda_kernel_wrappers_import_no_triton():
    """The eval-BatchNorm and int8-fusion wrappers launch CUDA kernels
    built by nvcc: neither imports triton, at any level."""
    for name in ("bn_relu", "fuse_s8"):
        path = os.path.join(REPO, "fabric_tpu_torch", "ops", f"{name}.py")
        assert not [m for m in _modules_imported_by(path)
                    if m.split(".")[0] == "triton"], name
