"""The spatial and model mesh axes in the port (parallel/spatial.py's halo
exchanges and gathers, parallel/distributed.py's mesh groups, the split
models, steps, losses and batches of fabric_tpu_torch) on the CPU, at
base 8, in gloo groups of subprocesses, in the pattern of
tests/test_torch_distributed.py.

The rule: ranks of a (data, spatial, model) mesh, each holding its data
slice's rows of the batch and its S-th of each patch's height, compute
what one process computes on the whole batch.  The units run on 2 ranks
(mesh (1, 2, 1)) against the port's unsharded op in the same worker; the
train steps against fabric_tpu's train step on the same batch and
variables under fabric_tpu.parallel.mesh.make_mesh of the same shape, on
the 8-device XLA CPU mesh of tests/conftest.py, in this process.  Sums
go over the ranks in another order than over the whole batch, so fp32
values agree within the bounds stated with each test; masks, counts and
batches exactly.  lane_pack's packed convs of a split level (ROADMAP.md
item 10d) are held against the unsharded packed conv (units) and
fabric_tpu's lane_pack step at patch 96 (its level 0 packs).  Three
launches: 2 ranks (the units, the (1, 2, 1) steps), 4 ranks (the (2, 2, 1), (1, 2, 2) and (1, 4, 1) steps and a
train.loop.train run at (2, 2, 1)) and 8 ranks (the (2, 4, 1) eval step
of tests/test_sharding.py, which needs 8)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from fabric_tpu import config as jax_config
from fabric_tpu import losses as jax_losses
from fabric_tpu.models import build_model as jax_build_model
from fabric_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fabric_tpu.parallel.mesh import shard_batch as jax_shard_batch
from fabric_tpu.train.state import create_state as jax_create_state
from fabric_tpu.train.steps import make_eval_step as jax_make_eval_step
from fabric_tpu.train.steps import make_train_step as jax_make_train_step

from fabric_tpu_torch import weights
from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data import loader, oscd, pipeline
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
from fabric_tpu_torch.infer.service import ScenePredictor
from fabric_tpu_torch.parallel import spatial
from fabric_tpu_torch.parallel.mesh import make_mesh
from fabric_tpu_torch.train import loop as loop_mod
from fabric_tpu_torch.weights import flatten_tree, variables_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # s, each subprocess
BASE, N, T = 8, 4, 3
# (model, patch, options) of each step; the meshes each runs at.  At patch
# 96 the lane_pack step's level 0 (inc, up4) packs, split over the ranks
STEPS = {"bidate": ("bidate", 32, {}), "unet_lstm": ("unet_lstm", 32, {}),
         "unet3d": ("unet3d", 16, {}),
         "lane_pack": ("bidate", 96, {"lane_pack": True,
                                      "lane_pack_bwd": True})}
MESHES = {(1, 2, 1): ["bidate", "unet_lstm", "unet3d", "lane_pack"],
          (2, 2, 1): ["bidate"], (1, 2, 2): ["bidate"],
          (1, 4, 1): ["bidate"]}
EVAL_MESH = (2, 4, 1)
# fabric_tpu's step on the XLA CPU mesh (1, 2, 2) doubles the update of
# every conv kernel of a split level (ROADMAP.md queue 3, a fault of the
# reference, pinned below): there the port is held to its (1, 2, 1) step
SOUND_MESH = {(1, 2, 2): (1, 2, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(code: str, world: int, **env) -> list:
    """``code`` in ``world`` processes of one gloo group (the FABRIC_*
    variables), started."""
    coord = f"localhost:{_free_port()}"
    procs = []
    for r in range(world):
        e = dict(os.environ, PYTHONPATH=REPO, FABRIC_COORDINATOR=coord,
                 FABRIC_NUM_PROCESSES=str(world), FABRIC_PROCESS_ID=str(r),
                 **env)
        e.pop("WORLD_SIZE", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=e, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def _wait(procs) -> None:
    """Wait for each process (its own timeout); fail on a non-zero exit."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{text[-4000:]}"


# --- inputs: variables with non-trivial BatchNorm, batches with a padded row

def variables(name, seed=0):
    """The tree of step ``name``'s model (base 8) with non-trivial
    BatchNorm parameters and running statistics, as numpy."""
    params, stats = weights.init_variables(
        13, 2, BASE, torch.Generator().manual_seed(seed), STEPS[name][0])
    rng = np.random.RandomState(seed)

    def walk(p, s):
        for k in sorted(p):
            if k.startswith("bn"):
                c = p[k]["scale"].shape[0]
                p[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p[k]["bias"] = (rng.randn(c) * 0.1).astype(np.float32)
                s[k]["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif k in s:
                walk(p[k], s[k])
    walk(params, stats)
    return params, stats


def batch(name, seed=1):
    """N rows at the step's patch, the last of weight 0 (a padded row)."""
    model, ps, _ = STEPS[name]
    rng = np.random.RandomState(seed)
    label = (rng.rand(N, ps, ps) < 0.3).astype(np.int32)
    if model == "bidate":
        img1 = rng.randn(N, ps, ps, 13).astype(np.float32)
        img2 = img1 + 0.3 * rng.randn(N, ps, ps, 13).astype(np.float32)
        img2[label == 1] += 1.5
        out = {"img1": img1, "img2": img2}
    else:
        imgs = rng.randn(N, T, ps, ps, 13).astype(np.float32)
        imgs[:, -1][label == 1] += 1.5
        out = {"imgs": imgs}
    return {**out, "label": label,
            "weight": np.array([1, 1, 1, 0], np.float32)}


def cfg_kw(name, **kw):
    model, ps, options = STEPS[name]
    return {"model": model, "num_dates": T, "model_base": BASE,
            "patch_size": ps, "batch_size": N,
            "eval_batch_size": N, "dtype": "float32",
            "loss_function": "tversky", "learning_rate": 0.05, **options,
            **kw}


def _inputs(root) -> str:
    """Every model's variables and batch in one .npz; its path."""
    arrays = {}
    for name in STEPS:
        params, stats = variables(name)
        arrays.update({f"{name}/params/{k}": v
                       for k, v in flatten_tree(params).items()})
        arrays.update({f"{name}/stats/{k}": v
                       for k, v in flatten_tree(stats).items()})
        arrays.update({f"{name}/batch/{k}": v
                       for k, v in batch(name).items()})
    path = os.path.join(root, "in.npz")
    np.savez(path, **arrays)
    return path


# --- the worker: every job of a launch, on each rank -------------------------

_WORKER = r"""
import contextlib, json, os
import numpy as np
import torch
import torch.distributed as tdist
torch.set_num_threads(1)
from fabric_tpu_torch import losses
from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data.oscd import full_load
from fabric_tpu_torch.losses import get_loss_fn
from fabric_tpu_torch.metrics import confusion_counts
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.models.blocks import (BatchNorm, Conv, DoubleConv,
                                            Down, Up)
from fabric_tpu_torch.ops import s2d_conv
from fabric_tpu_torch.ops.resize import (upsample2x_align_corners,
                                        upsample2x_local)
from fabric_tpu_torch.parallel import distributed as dist, spatial
from fabric_tpu_torch.train import steps
from fabric_tpu_torch.train.loop import train
from fabric_tpu_torch.train.state import create_state
from fabric_tpu_torch.weights import flatten_tree, unflatten_tree, variables_of

assert dist.maybe_initialize("cpu")
r = dist.rank()
spec = json.loads(os.environ["FT_SPEC"])
out_dir = os.environ["FT_OUT"]
data = np.load(os.environ["FT_IN"])


def tree(name, part):
    pre = f"{name}/{part}/"
    return unflatten_tree({k[len(pre):]: data[k] for k in data.files
                           if k.startswith(pre)})


def local_batch(name):
    # the rank's data slice of the batch, and its S-th of each patch's H
    pre = f"{name}/batch/"
    full = {k[len(pre):]: data[k] for k in data.files if k.startswith(pre)}
    (D, S, M), (d, s, m) = dist.mesh_shape().values(), dist.coords()
    n, h = full["label"].shape[:2]
    rows, cut = slice(d * n // D, (d + 1) * n // D), slice(
        s * h // S, (s + 1) * h // S)
    out = {}
    for k, v in full.items():
        v = v[rows]
        if k == "imgs":
            v = v[:, :, cut]
        elif k != "weight":
            v = v[:, cut]
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def state_arrays(model, st):
    p, b = variables_of(model)
    return {**{"params/" + k: v for k, v in flatten_tree(p).items()},
            **{"stats/" + k: v for k, v in flatten_tree(b).items()},
            **{"out/" + k: v.numpy() for k, v in st.items()}}


def step_job(job):
    name = job["model"]
    cfg = Config(**job["cfg"])
    model = build_model(cfg, "cpu", fold_bn=False, train=True,
                        variables=(tree(name, "params"),
                                   tree(name, "stats")))
    state = create_state(cfg, model)
    b = local_batch(name)
    for k in s2d_conv.packed_counts:
        s2d_conv.packed_counts[k] = 0
    if job["kind"] == "eval":
        st = steps.make_eval_step(model, get_loss_fn(cfg))(state, b)
    else:
        state, st = steps.make_train_step(model, get_loss_fn(cfg))(state, b)
    st["packed"] = torch.tensor(list(s2d_conv.packed_counts.values()))
    return state_arrays(model, st)


def loop_job(job):
    cfg = Config(**job["cfg"])
    state, history = train(cfg, dataset=full_load(cfg.dataset_dir, cfg),
                           device="cpu")
    p, b = variables_of(state.model)
    with open(os.path.join(out_dir, f"{job['tag']}_history_{r}.json"),
              "w") as f:
        json.dump({"history": history, "step": state.step}, f)
    return {**{"params/" + k: v for k, v in flatten_tree(p).items()},
            **{"stats/" + k: v for k, v in flatten_tree(b).items()}}


@contextlib.contextmanager
def alone():
    # the whole-batch reference: this rank as one process, no collective
    real = dist.active
    dist.active = lambda: False
    try:
        yield
    finally:
        dist.active = real


def rows_of(t, h):
    s = dist.coords()[1]
    return t[:, s * h:(s + 1) * h]


def summed(t):
    t = t.clone()
    tdist.all_reduce(t)
    return t


def units_job(job):
    g = torch.Generator().manual_seed(7)
    rnd = lambda *shape: torch.randn(*shape, generator=g)
    res = {}
    S = dist.mesh_shape()["spatial"]

    # a 3x3 conv: its rows from a halo, the input and weight gradients
    conv = Conv(5, 6)
    with torch.no_grad():
        conv.kernel.copy_(rnd(3, 3, 5, 6) * 0.3)
        conv.bias.copy_(rnd(6))
    conv.requires_grad_(True)
    x, gy = rnd(2, 8, 7, 5), rnd(2, 8, 7, 6)
    xw = x.clone().requires_grad_(True)
    with alone():
        y = conv(xw)
        (y * gy).sum().backward()
    want = (y.detach(), xw.grad, conv.kernel.grad.clone(),
            conv.bias.grad.clone())
    conv.zero_grad()
    xl = rows_of(x, 8 // S).clone().requires_grad_(True)
    with spatial.sharded(8 // S), spatial.at(0):
        yl = conv(xl)
    (yl * rows_of(gy, 8 // S)).sum().backward()
    res["conv/y"] = (yl.detach(), rows_of(want[0], 8 // S))
    res["conv/dx"] = (xl.grad, rows_of(want[1], 8 // S))
    res["conv/dkernel"] = (summed(conv.kernel.grad), want[2])
    res["conv/dbias"] = (summed(conv.bias.grad), want[3])

    # both upsamples of a split level, at the shard boundary
    x, gy = rnd(2, 6, 5, 3), rnd(2, 12, 10, 3)
    for local, up in ((True, upsample2x_local),
                      (False, upsample2x_align_corners)):
        xw = x.clone().requires_grad_(True)
        with alone():
            y = up(xw)
            (y * gy).sum().backward()
        xl = rows_of(x, 3).clone().requires_grad_(True)
        with spatial.sharded(3):
            yl = spatial.level(0).upsample2x(xl, local)
        (yl * rows_of(gy, 6)).sum().backward()
        tag = "local" if local else "align"
        res[f"up_{tag}/y"] = (yl.detach(), rows_of(y.detach(), 6))
        res[f"up_{tag}/dx"] = (xl.grad, rows_of(xw.grad, 3))

    # a gathered level: 3 rows a shard, so level 1 is gathered; Down into
    # it (BatchNorm in train mode), Up back to the split level 0
    down, upb = Down(4, 6, fold_bn=False), Up(10, 4, fold_bn=False)
    for blk in (down, upb):
        with torch.no_grad():
            for k, p in blk.named_parameters():
                p.copy_(rnd(*p.shape) * (0.3 if k.endswith("kernel")
                                         else 0.1)
                        + (1.0 if k.endswith("scale") else 0.0))
        blk.requires_grad_(True)
    x, gy = rnd(2, 6, 4, 4), rnd(2, 6, 4, 4)
    xw = x.clone().requires_grad_(True)
    with alone():
        y = upb(down(xw, True), xw, True)
        (y * gy).sum().backward()
    blocks = {"down": down, "up": upb}
    want = {f"{b}.{k}": (p.grad.clone() if p.grad is not None else None)
            for b, blk in blocks.items() for k, p in blk.named_parameters()}
    stats = {f"{b}.{k}": v.clone() for b, blk in blocks.items()
             for k, v in blk.named_buffers()}
    for blk in blocks.values():
        blk.zero_grad()
        for m in blk.modules():
            if isinstance(m, BatchNorm):
                m.mean.zero_()
                m.var.fill_(1.0)
    xl = rows_of(x, 3).clone().requires_grad_(True)
    with spatial.sharded(3):
        assert spatial.level(1, 0).split is False
        with spatial.at(1, 0):
            mid = down(xl, True)
        with spatial.at(0, 1):
            yl = upb(mid, xl, True)
    (yl * rows_of(gy, 3)).sum().backward()
    res["gathered/y"] = (yl.detach(), rows_of(y.detach(), 3))
    res["gathered/dx"] = (xl.grad, rows_of(xw.grad, 3))
    for b, blk in blocks.items():
        for k, p in blk.named_parameters():
            res[f"gathered/d:{b}.{k}"] = (summed(p.grad), want[f"{b}.{k}"])
        for k, v in blk.named_buffers():
            res[f"gathered/stat:{b}.{k}"] = (v.clone(), stats[f"{b}.{k}"])

    # BatchNorm of a split level: output, gradients, running statistics
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.scale.copy_(rnd(5).abs() + 0.5)
        bn.bias.copy_(rnd(5) * 0.1)
    bn.requires_grad_(True)
    x, gy = rnd(4, 6, 6, 5) * 2 + 3, rnd(4, 6, 6, 5)
    xw = x.clone().requires_grad_(True)
    with alone():
        y = bn(xw)
        (y * gy).sum().backward()
    want = (y.detach(), xw.grad, bn.scale.grad.clone(),
            bn.bias.grad.clone(), bn.mean.clone(), bn.var.clone())
    bn.zero_grad()
    bn.mean.zero_()
    bn.var.fill_(1.0)
    xl = rows_of(x, 3).clone().requires_grad_(True)
    with spatial.sharded(3), spatial.at(0):
        yl = bn(xl)
    (yl * rows_of(gy, 3)).sum().backward()
    res["bn/y"] = (yl.detach(), rows_of(want[0], 3))
    res["bn/dx"] = (xl.grad, rows_of(want[1], 3))
    res["bn/dscale"] = (summed(bn.scale.grad), want[2])
    res["bn/dbias"] = (summed(bn.bias.grad), want[3])
    res["bn/mean"] = (bn.mean.clone(), want[4])
    res["bn/var"] = (bn.var.clone(), want[5])

    # every loss (and the reference's compat reduction), and the counts
    logits = rnd(4, 8, 6, 2) * 2
    labels = (torch.rand(4, 8, 6, generator=g) < 0.3).to(torch.int32)
    w = torch.tensor([1.0, 1.0, 1.0, 0.0])
    fns = {"tversky": losses.tversky_loss, "dice": losses.dice_loss,
           "jaccard": losses.jaccard_loss, "focal": losses.focal_loss,
           "ce": losses.cross_entropy_loss}
    for name, fn in fns.items():
        for compat in ((False, True) if name in ("tversky", "dice",
                                                 "jaccard") else (False,)):
            kw = {"compat_reference": True} if compat else {}
            lw = logits.clone().requires_grad_(True)
            with alone():
                want = fn(lw, labels, weights=w, **kw)
                want.backward()
            ll = rows_of(logits, 4).clone().requires_grad_(True)
            got = fn(ll, rows_of(labels, 4), weights=w, **kw)
            got.backward()
            tag = f"loss_{name}{'_compat' if compat else ''}"
            res[tag] = (got.detach(), want.detach())
            # the backward of the global sums adds both ranks' dL/dS
            res[tag + "/dlogits"] = (ll.grad / S, rows_of(lw.grad, 4))
    preds = logits.argmax(-1)
    want = confusion_counts(preds, labels, w)
    got = steps._counts(rows_of(preds, 4), {"label": rows_of(labels, 4),
                                            "weight": w})
    res["counts"] = (torch.stack([got[k] for k in sorted(got)]),
                     torch.stack([want[k] for k in sorted(want)]))

    # lane_pack on a split level: the packed conv of whole s2d blocks from
    # a halo, VALID in H, and its gradients with pack_bwd off and on (at
    # 96 x 96, where the gate packs the dgrad), against the unsharded
    # packed conv; the packed convs each rank ran
    def blank(blk):
        with torch.no_grad():
            for k, p in blk.named_parameters():
                p.copy_(rnd(*p.shape) * (0.3 if k.endswith("kernel")
                                         else 0.1)
                        + (1.0 if k.endswith("scale") else 0.0))
            for k, v in blk.named_buffers():
                v.copy_(rnd(*v.shape).abs() * 0.5 + 0.5 if k.endswith("var")
                        else rnd(*v.shape) * 0.1)
        blk.requires_grad_(True)

    def packed_run():
        for k in s2d_conv.packed_counts:
            s2d_conv.packed_counts[k] = 0
        return lambda: torch.tensor(list(s2d_conv.packed_counts.values()))

    pk = Conv(3, 4)
    blank(pk)
    x, gy = rnd(1, 96, 96, 3), rnd(1, 96, 96, 4)
    for pack_bwd in (False, True):
        tag = "lane_pack_bwd" if pack_bwd else "lane_pack"
        xw = x.clone().requires_grad_(True)
        with alone():
            y = pk.packed(xw, pack_bwd)
            (y * gy).sum().backward()
        want = (y.detach(), xw.grad, pk.kernel.grad.clone(),
                pk.bias.grad.clone())
        pk.zero_grad()
        counted = packed_run()
        xl = rows_of(x, 96 // S).clone().requires_grad_(True)
        with spatial.sharded(96 // S), spatial.at(0):
            yl = pk.packed(xl, pack_bwd)
        (yl * rows_of(gy, 96 // S)).sum().backward()
        res[f"{tag}/y"] = (yl.detach(), rows_of(want[0], 96 // S))
        res[f"{tag}/dx"] = (xl.grad, rows_of(want[1], 96 // S))
        res[f"{tag}/dkernel"] = (summed(pk.kernel.grad), want[2])
        res[f"{tag}/dbias"] = (summed(pk.bias.grad), want[3])
        res[f"{tag}/packed"] = (counted(),
                                torch.tensor([1, int(pack_bwd), 0]))
        pk.zero_grad()

    # the eval form (packed conv, eval BatchNorm + ReLU) through a
    # lane_pack DoubleConv, its gate reading global rows: at 96 rows and
    # at 98 (49-row shards, odd, the packed rows cut to the rank's)
    ev = DoubleConv(3, 4, fold_bn=False, lane_pack=True)
    blank(ev)
    for hh in (96, 98):
        x = rnd(2, hh, 96, 3)
        with alone(), torch.no_grad():
            want = ev(x, False)
        counted = packed_run()
        with spatial.sharded(hh // S), spatial.at(0), torch.no_grad():
            got = ev(rows_of(x, hh // S), False)
        res[f"lane_pack_eval/y{hh}"] = (got, rows_of(want, hh // S))
        res[f"lane_pack_eval/packed{hh}"] = (counted(),
                                             torch.tensor([0, 0, 2]))

    # a lane_pack + lane_pack_bwd DoubleConv in training on 49-row shards
    # of 98: the output, input and parameter gradients, statistics; every
    # conv packed, its dgrad too (the gate reads 98 rows, not 49)
    odd = DoubleConv(3, 4, fold_bn=False, lane_pack=True, lane_pack_bwd=True)
    blank(odd)
    init = {k: v.clone() for k, v in odd.state_dict().items()}
    x, gy = rnd(2, 98, 96, 3), rnd(2, 98, 96, 4)
    xw = x.clone().requires_grad_(True)
    with alone():
        y = odd(xw, True)
        (y * gy).sum().backward()
    want = {k: p.grad.clone() for k, p in odd.named_parameters()}
    stats = {k: v.clone() for k, v in odd.named_buffers()}
    odd.zero_grad()
    odd.load_state_dict(init)
    counted = packed_run()
    xl = rows_of(x, 49).clone().requires_grad_(True)
    with spatial.sharded(49), spatial.at(0):
        yl = odd(xl, True)
    (yl * rows_of(gy, 49)).sum().backward()
    res["lane_pack_odd/y"] = (yl.detach(), rows_of(y.detach(), 49))
    res["lane_pack_odd/dx"] = (xl.grad, rows_of(xw.grad, 49))
    for k, p in odd.named_parameters():
        res[f"lane_pack_odd/d:{k}"] = (summed(p.grad), want[k])
    for k, v in odd.named_buffers():
        res[f"lane_pack_odd/stat:{k}"] = (v.clone(), stats[k])
    res["lane_pack_odd/packed"] = (counted(), torch.tensor([2, 2, 0]))

    # the rows a packed conv reads: the rank's with the halo rows that make
    # them whole blocks of the global image's shifted s2d (rows 2j - 1, 2j;
    # zeros past its top and bottom), and the rank's first output row; a
    # halo out of phase computes the same conv, rounded otherwise
    for hh in (96, 98):
        x, h = rnd(1, hh, 4, 2), hh // S
        r0 = dist.coords()[1] * h
        xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))  # row i at i + 1
        with spatial.sharded(h), spatial.at(0):
            ext, first = spatial.block_halo(rows_of(x, h))
        res[f"lane_pack_odd/rows{hh}"] = (
            ext, xp[:, r0 - r0 % 2:r0 + h + 2 + (r0 + h) % 2])
        res[f"lane_pack_odd/rows{hh}_first"] = (torch.tensor(first),
                                                torch.tensor(r0 % 2))
    return {f"{k}/{i}": t.numpy() for k, pair in res.items()
            for i, t in zip(("got", "want"), pair)}


for job in spec:
    dist.set_mesh(*job["mesh"])
    if job["kind"] == "units":
        arrays = units_job(job)
    elif job["kind"] == "loop":
        arrays = loop_job(job)
    else:
        arrays = step_job(job)
    np.savez(os.path.join(out_dir, f"{job['tag']}_{r}.npz"), **arrays)
dist.shutdown()
"""


# --- the launches and fabric_tpu's steps -------------------------------------

def _tag(kind, mesh, name="bidate"):
    return f"{kind}_{name}_{'x'.join(map(str, mesh))}"


def _jobs(root, data_dir):
    """{world size: [jobs]} of the three launches."""
    step_jobs = {}
    for mesh, names in MESHES.items():
        for name in names:
            step_jobs.setdefault(int(np.prod(mesh)), []).append(
                {"kind": "step", "mesh": list(mesh), "model": name,
                 "cfg": cfg_kw(name), "tag": _tag("step", mesh, name)})
    step_jobs[2].insert(0, {"kind": "units", "mesh": [1, 2, 1],
                            "tag": "units"})
    step_jobs[2].append({"kind": "step", "mesh": [1, 2, 1],
                         "model": "lane_pack",
                         "cfg": cfg_kw("lane_pack", remat=True),
                         "tag": "remat_lane_pack"})
    step_jobs[4].append({"kind": "loop", "mesh": [2, 2, 1],
                         "cfg": loop_cfg(root, data_dir, "loop", 2, 2),
                         "tag": "loop"})
    step_jobs[8] = [{"kind": "eval", "mesh": list(EVAL_MESH),
                     "model": "bidate", "cfg": cfg_kw("bidate"),
                     "tag": _tag("eval", EVAL_MESH)}]
    return step_jobs


def loop_cfg(root, data_dir, tag, spatial_axis, data_axis):
    return dict(
        dataset_dir=data_dir, weight_dir=os.path.join(root, tag, "weights"),
        log_dir=os.path.join(root, tag, "log"), dtype="float32",
        model_base=BASE, patch_size=32, stride=32, batch_size=N,
        eval_batch_size=N, epochs=1, steps_per_epoch=2, num_workers=0,
        seed=3, validation_cities=["beta"], prefetch=1, augmentation=True,
        loss_function="tversky", optimizer="sgd", momentum=0.9,
        learning_rate=0.05, mesh_data=data_axis, mesh_spatial=spatial_axis)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """(root, dataset dir, {world: (jobs, processes)}): the three launches,
    started together, on inputs written once."""
    root = str(tmp_path_factory.mktemp("spatial"))
    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(data_dir, Config(), cities=["alpha", "beta"],
                               sizes=[(64, 128), (64, 48)], seed=1)
    inputs = _inputs(root)
    launches = {}
    for world, jobs in _jobs(root, data_dir).items():
        launches[world] = (jobs, _start(_WORKER, world, FT_IN=inputs,
                                        FT_OUT=root,
                                        FT_SPEC=json.dumps(jobs)))
    return root, data_dir, launches


def _jax_step(name, mesh_shape, kind="step"):
    """fabric_tpu's train (or eval) step on the same variables and batch,
    under make_mesh(*mesh_shape): (flat variables or None, stats)."""
    jcfg = jax_config.Config(**cfg_kw(name))
    params, stats = variables(name)
    model = jax_build_model(jcfg)
    state = jax_create_state(jcfg, model, variables={
        "params": params, "batch_stats": stats})
    mesh = jax_make_mesh(*mesh_shape)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    b = jax_shard_batch(batch(name), mesh)
    loss_fn = jax_losses.get_loss_fn(jcfg)
    if kind == "eval":
        return None, jax.device_get(jax_make_eval_step(model, loss_fn)(
            state, b))
    state, st = jax_make_train_step(model, loss_fn, donate=False)(state, b)
    got = {**{"params/" + k: np.asarray(v) for k, v in flatten_tree(
        jax.device_get(state.params)).items()},
        **{"stats/" + k: np.asarray(v) for k, v in flatten_tree(
            jax.device_get(state.batch_stats)).items()}}
    return got, jax.device_get(st)


@pytest.fixture(scope="module")
def jax_steps(started):
    """{tag: fabric_tpu's result} of every step, computed while the
    launches run."""
    out = {_tag("step", mesh, name): _jax_step(name, mesh)
           for mesh, names in MESHES.items() for name in names}
    out[_tag("eval", EVAL_MESH)] = _jax_step("bidate", EVAL_MESH, "eval")
    return out


@pytest.fixture(scope="module")
def results(started, jax_steps):
    """{tag: [each rank's arrays]} of every job, the launches ended."""
    root, _, launches = started
    out = {}
    for world, (jobs, procs) in launches.items():
        _wait(procs)
        for job in jobs:
            out[job["tag"]] = [dict(np.load(os.path.join(
                root, f"{job['tag']}_{r}.npz"))) for r in range(world)]
    return out


# --- the units on 2 ranks, against the unsharded ops -------------------------

UNITS = ["conv", "up_local", "up_align", "gathered", "bn", "loss_tversky",
         "loss_tversky_compat", "loss_dice", "loss_dice_compat",
         "loss_jaccard", "loss_jaccard_compat", "loss_focal", "loss_ce",
         "counts", "lane_pack", "lane_pack_bwd", "lane_pack_eval",
         "lane_pack_odd"]


@pytest.mark.parametrize("unit", UNITS)
def test_units_match_the_unsharded_ops(results, unit):
    """Each rank's rows of a 3x3 conv from a halo (its input and weight
    gradients), of both upsamples at the shard boundary, of a Down block
    into a gathered level and the Up block back (parameter gradients and
    BatchNorm running statistics), of a split BatchNorm, every loss's value
    and logit gradient, the confusion counts, and lane_pack at a split
    level (the packed conv of whole s2d blocks from a halo, VALID in H:
    its forward, dx, dkernel and dbias with pack_bwd off and on at 96
    rows; a DoubleConv's eval form at 96 and 98 rows; a lane_pack_bwd
    DoubleConv in training on 49-row shards of 98; the halo rows that
    make a 48- or 49-row shard whole s2d blocks): the unsharded op's,
    within 1e-5 of each quantity's largest magnitude (sums in another
    order), the parameter gradients of the gathered and the odd-shard
    blocks within 1e-5 of their largest (the conv biases ahead of a
    train-mode BatchNorm have a gradient of 0 but for rounding); the
    local upsample, the counts, the packed convs each rank ran (the gate
    reads global rows: every one packs, the dgrads with pack_bwd) and the
    blocks' rows exactly; both ranks alike."""
    for rank in results["units"]:
        keys = sorted({k.rsplit("/", 1)[0] for k in rank
                       if k.split("/")[0] == unit})
        assert keys, unit
        grads = max([np.abs(rank[k + "/want"]).max() for k in keys
                     if k.startswith(unit + "/d:")], default=0.0)
        for k in keys:
            got, want = rank[k + "/got"], rank[k + "/want"]
            assert got.shape == want.shape, k
            if unit in ("up_local", "counts") or "/packed" in k \
                    or "/rows" in k:
                np.testing.assert_array_equal(got, want, err_msg=k)
                continue
            scale = grads if k.startswith(unit + "/d:") \
                else np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                       err_msg=k)


def test_levels_split_as_fabric_tpu_partitions():
    """Which levels a patch splits: S = 2 at patch 96 splits all five;
    S = 4 gathers the bottleneck (down4's pool would split 6 rows 4 ways);
    at patch 32 S = 4 gathers down4, S = 2 splits all; a height that does
    not divide raises."""
    assert spatial.split_levels(96, 2) == [True] * 5
    assert spatial.split_levels(96, 4) == [True] * 4 + [False]
    assert spatial.split_levels(32, 4) == [True] * 4 + [False]
    assert spatial.split_levels(32, 2) == [True] * 5
    assert spatial.split_levels(16, 2) == [True] * 4 + [False]
    with pytest.raises(ValueError, match="does not split"):
        spatial.split_levels(30, 4)


# --- train and eval steps, against fabric_tpu on its XLA CPU mesh ------------

STEP_CASES = [(mesh, name) for mesh, names in MESHES.items()
              for name in names]


@pytest.mark.parametrize("mesh,name", STEP_CASES,
                         ids=[f"{n}-{'x'.join(map(str, m))}"
                              for m, n in STEP_CASES])
def test_train_step_matches_fabric_tpu(results, jax_steps, mesh, name):
    """One tversky + SGD fp32 step of the D*S*M ranks (a padded row in the
    batch) against fabric_tpu's step on the same batch and variables on a
    mesh of the same shape (at (1, 2, 2), whose conv kernel updates
    fabric_tpu doubles, of shape (1, 2, 1)): the loss within 1e-5
    relative, the confusion counts equal, every parameter within 1e-5 and
    every running statistic within 1e-5 (relative above 1); every rank
    holds the same loss, counts, parameters and statistics, bit for bit."""
    tag = _tag("step", mesh, name)
    ranks = results[tag]
    want, jstats = jax_steps[_tag("step", SOUND_MESH.get(mesh, mesh), name)]
    first = ranks[0]
    for rank in ranks[1:]:
        assert rank.keys() == first.keys()
        for k in first:
            np.testing.assert_array_equal(rank[k], first[k], err_msg=k)
    np.testing.assert_allclose(first["out/loss"], jstats["loss"], rtol=1e-5)
    for k in ("tp", "fp", "fn", "tn"):
        assert int(first["out/" + k]) == int(jstats[k]), k
    assert {k for k in first if not k.startswith("out/")} == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(first[k], v, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(v).max()),
                                   err_msg=k)


def test_lane_pack_step_packs_on_every_rank(results):
    """The lane_pack + lane_pack_bwd step at patch 96 on mesh (1, 2, 1):
    the gate reads level 0's global 96 rows, not a rank's 48, so each rank
    packed inc's and up4's four forward convs and the three dgrads that
    lane_pack_bwd admits at base 8 (inc.conv2's, up4.conv1's and
    up4.conv2's; inc.conv1's input is the image), none direct; the steps
    without lane_pack packed none."""
    for rank in results[_tag("step", (1, 2, 1), "lane_pack")]:
        np.testing.assert_array_equal(rank["out/packed"], [4, 3, 0])
    for rank in results[_tag("step", (1, 2, 1))]:
        np.testing.assert_array_equal(rank["out/packed"], [0, 0, 0])


def test_lane_pack_step_rematerialised_on_a_split_level(results):
    """The same lane_pack step with ``remat``: each stage's recompute
    re-enters its level, so the packed convs' halos run again inside it
    (8 packed forwards a rank, the dgrads as before), and the step is
    the one without remat, bit for bit, on every rank."""
    for plain, remat in zip(results[_tag("step", (1, 2, 1), "lane_pack")],
                            results["remat_lane_pack"], strict=True):
        np.testing.assert_array_equal(remat["out/packed"], [8, 3, 0])
        assert remat.keys() == plain.keys()
        for k in plain:
            if k != "out/packed":
                np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)


def test_fabric_tpu_doubles_split_conv_kernel_updates_at_1x2x2(results,
                                                              jax_steps):
    """A fault of the reference, kept (ROADMAP.md queue 3): fabric_tpu's
    step on the XLA CPU mesh (1, 2, 2) moves every conv kernel of a split
    level by twice its (1, 2, 1) update (XLA sums the kernel's gradient
    over the model axis's replicas too), and agrees with it elsewhere.
    The port's (1, 2, 2) step holds fabric_tpu's (1, 2, 2) loss, counts,
    statistics and its other parameters within 1e-5, and its (1, 2, 1)
    kernels (above)."""
    init = {"params/" + k: v for k, v in flatten_tree(
        variables("bidate")[0]).items()}
    bad, bad_stats = jax_steps[_tag("step", (1, 2, 2))]
    sound, _ = jax_steps[_tag("step", (1, 2, 1))]
    port = results[_tag("step", (1, 2, 2))][0]
    doubled = []
    for k, v in sound.items():
        if k in init and k.endswith("kernel") and not k.startswith(
                ("params/down4.", "params/outc.")):
            step = (v - init[k]).ravel()
            ratio = np.dot((bad[k] - init[k]).ravel(), step) / np.dot(
                step, step)
            assert abs(ratio - 2.0) < 0.01, (k, ratio)
            doubled.append(k)
            continue
        np.testing.assert_allclose(bad[k], v, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(v).max()),
                                   err_msg=k)
        np.testing.assert_allclose(port[k], bad[k], rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(v).max()),
                                   err_msg=k)
    assert len(doubled) == 16  # inc, down1-3, up1-4: two convs each
    np.testing.assert_allclose(port["out/loss"], bad_stats["loss"],
                               rtol=1e-5)
    for k in ("tp", "fp", "fn", "tn"):
        assert int(port["out/" + k]) == int(bad_stats[k]), k


def test_eval_step_at_2x4x1_matches_fabric_tpu(results, jax_steps):
    """tests/test_sharding.py's case: the eval step at patch 32 on mesh
    (2, 4, 1), where four shards split the bottleneck unevenly (down4 is
    gathered): the ranks' predictions, put back together, equal
    fabric_tpu's on its mesh; the loss within 1e-5 relative and the counts
    equal on every rank."""
    _, jstats = jax_steps[_tag("eval", EVAL_MESH)]
    ranks = results[_tag("eval", EVAL_MESH)]
    d_n, s_n, _ = EVAL_MESH
    preds = np.concatenate([np.concatenate(
        [ranks[d * s_n + s]["out/preds"] for s in range(s_n)], axis=1)
        for d in range(d_n)])
    np.testing.assert_array_equal(preds, np.asarray(jstats["preds"]))
    for rank in ranks:
        np.testing.assert_allclose(rank["out/loss"], jstats["loss"],
                                   rtol=1e-5)
        for k in ("tp", "fp", "fn", "tn"):
            assert int(rank["out/" + k]) == int(jstats[k]), k


# --- train.loop.train at (2, 2, 1) against one process -----------------------

@pytest.fixture(scope="module")
def single_loop(started):
    """The loop in this process (no group) on the same config."""
    root, data_dir, _ = started
    cfg = Config(**loop_cfg(root, data_dir, "single", 1, -1))
    state, history = loop_mod.train(cfg, dataset=oscd.full_load(
        data_dir, cfg), device="cpu")
    p, b = variables_of(state.model)
    return ({**{"params/" + k: v for k, v in flatten_tree(p).items()},
             **{"stats/" + k: v for k, v in flatten_tree(b).items()}},
            {"history": history, "step": state.step})


def test_loop_on_a_spatial_mesh_trains_like_one_process(results, started,
                                                        single_loop):
    """train.loop.train on 4 ranks at mesh (2, 2, 1), 2 steps, validation
    and rank 0's scene inference: the ranks end equal, bit for bit; each
    epoch's train and validation loss within 1e-5 relative of one
    process's, the validation counts equal, every parameter within 1e-5
    and every running statistic within 1e-5 (relative above 1); rank 0
    alone wrote (one tracker run, the checkpoints of the 1-process run,
    the scene inference)."""
    root = started[0]
    ranks = results["loop"]
    want, hs = single_loop
    for rank in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(rank[k], ranks[0][k], err_msg=k)
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0][k], v, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(v).max()),
                                   err_msg=k)
    hist = []
    for r in range(len(ranks)):
        with open(os.path.join(root, f"loop_history_{r}.json")) as f:
            hist.append(json.load(f))
    assert hist[0]["step"] == hs["step"] == 2
    for split in ("train", "val"):
        for e0, es in zip(hist[0]["history"][split], hs["history"][split],
                          strict=True):
            np.testing.assert_allclose(e0["cd_losses"], es["cd_losses"],
                                       rtol=1e-5)
            if split == "val":
                for k in ("global_precision", "global_recall",
                          "global_accuracy"):
                    assert e0[k] == es[k], k
    assert "beta_scene_f1" in hist[0]["history"]["val"][0]
    for h in hist[1:]:
        assert "beta_scene_f1" not in h["history"]["val"][0]
    assert len(os.listdir(os.path.join(root, "loop", "log"))) == 1
    assert sorted(os.listdir(os.path.join(root, "loop", "weights"))) == \
        sorted(os.listdir(os.path.join(root, "single", "weights")))


# --- the batches: each rank's rows of each patch -----------------------------

@pytest.fixture(scope="module")
def sampler_data(started):
    dataset = oscd.full_load(started[1], Config())
    train_md, _ = oscd.metadata_from_dataset(dataset, ["beta"], 16, 16)
    return dataset, train_md


@pytest.mark.parametrize("augment", [True, False])
def test_rank_rows_are_the_whole_batch_rows(sampler_data, augment):
    """batch_iterator at data rank d of 2 and spatial rank s of 2 cuts the
    augmented patches: its arrays are rows [s*8, (s+1)*8) of data rank d's
    batch, byte for byte; a worker loader of the same rank delivers the
    same bytes; a patch that does not split raises."""
    dataset, md = sampler_data
    kw = dict(shuffle=True, seed=4, max_batches=2)
    for d in range(2):
        whole = list(pipeline.batch_iterator(
            pipeline.PatchSampler(dataset, md, 16, augment), 8, **kw,
            process_index=d, process_count=2))
        for s in range(2):
            part = list(pipeline.batch_iterator(
                pipeline.PatchSampler(dataset, md, 16, augment), 8, **kw,
                process_index=d, process_count=2, spatial_index=s,
                spatial_count=2))
            for a, b in zip(part, whole, strict=True):
                rows = slice(8 * s, 8 * (s + 1))
                assert a["img1"].tobytes() == b["img1"][:, rows].tobytes()
                assert a["img2"].tobytes() == b["img2"][:, rows].tobytes()
                assert a["label"].tobytes() == b["label"][:, rows].tobytes()
                assert a["weight"].tobytes() == b["weight"].tobytes()
    if augment:
        with loader.BatchLoader(loader.share_dataset(dataset), md, 16, True,
                                8, shuffle=True, num_workers=1,
                                device="cpu", process_index=1,
                                process_count=2, spatial_index=1,
                                spatial_count=2) as batches:
            got = list(batches.epoch(seed=4, max_batches=2))
        assert len(got) == len(part) == 2
        for a, b in zip(got, part):
            for k in b:
                assert a[k].numpy().tobytes() == b[k].tobytes(), k
    with pytest.raises(ValueError, match="does not split"):
        next(pipeline.batch_iterator(
            pipeline.PatchSampler(dataset, md, 16, augment), 8, **kw,
            spatial_index=0, spatial_count=3))


# --- serving on a (1, 2, 2) mesh: the spatial and model axes replicate -------

def test_predictor_and_cli_infer_on_a_1x2x2_mesh(started, tmp_path):
    """ScenePredictor and cli.infer on a (1, 2, 2) CPU mesh split tile
    batches over the one data device, the spatial and model axes holding
    replicas: masks equal to the data-only mesh's, exact and int8."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.cli.infer import main
    from fabric_tpu_torch.data.image import read_png_gray
    from fabric_tpu_torch.infer.runner import load_scene
    import types
    data_dir = started[1]
    params, stats = variables("bidate")
    state = types.SimpleNamespace(step=0, opt_state={},
                                  variables=lambda: (params, stats))
    ckpt.save(state, str(tmp_path / "ckpt"), epoch=0)
    cfg = Config(patch_size=16, eval_batch_size=8, model_base=BASE,
                 dtype="float32", dataset_dir=data_dir)
    d1, d2 = load_scene(cfg, "alpha")
    for quant in (None, "int8"):
        masks = [ScenePredictor(cfg, checkpoint=str(tmp_path / "ckpt"),
                                device="cpu", bucket=32, quant=quant,
                                mesh=make_mesh(1, s, m,
                                               devices=["cpu"] * (s * m))
                                ).predict(d1, d2)
                 for s, m in ((1, 1), (2, 2))]
        np.testing.assert_array_equal(masks[0], masks[1])
    args = ["--dataset_dir", data_dir, "--resume", str(tmp_path / "ckpt"),
            "--patch_size", "16", "--eval_batch_size", "8", "--dtype",
            "float32", "--model_base", str(BASE), "--device", "cpu",
            "--city", "alpha", "--quant", "int8", "--no_tracker"]
    cli = []
    for tag, mesh in (("data", []), ("mesh", ["--mesh_spatial", "2",
                                              "--mesh_model", "2"])):
        assert main(args + ["--output_dir", str(tmp_path / tag)] + mesh) == 0
        cli.append(read_png_gray(str(tmp_path / tag / "alpha_mask.png")))
    np.testing.assert_array_equal(cli[0], cli[1])
