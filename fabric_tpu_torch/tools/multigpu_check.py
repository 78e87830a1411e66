"""Multi-GPU check on a host with several cards: sharded serving over every
visible card against one card, and training in one NCCL rank per card,
on (data, spatial, model) meshes of them, against one process.

    python -m fabric_tpu_torch.tools.multigpu_check [--scene 4096]
        [--steps 10] [--meshes nx1x1,1xnx1,2x(n/2)x1] [--train_only]

Serving: a ``--scene``^2 bi-date pair (BiDateNet base 64, patch 64, batch
256, weights from seed 0) through ``ScenePredictor`` on ``cuda:0``, then
with the mesh of all cards (``parallel.mesh.make_mesh()``): the scene as
H-bands, one a card (``shard_scene``), grid and fullconv (band 512), bf16
and int8, and the tile-batch split (the mesh without ``shard_scene``).
Every mask must equal the one card's.  Prints each card's peak allocated
memory, ``predict``'s wall time and the runner's on placed bands (host
clock, every card synchronised).

Training: ``train.loop.train`` on a synthetic dataset (four ~1024^2
cities, patch 96, global batch 128, tversky + SGD) in one process per card
over NCCL (``FABRIC_*`` variables, ``maybe_initialize``), the cards laid
out as each mesh of ``--meshes`` (n the card count; default: data-parallel
n x 1 x 1, the height split over every card 1 x n x 1, and 2 x n/2 x 1),
against one process on ``cuda:0``, on the same global batches: fp32 for 3
steps, the loss, parameters and running statistics held to
``chip_smoke.py``'s ``dp_train`` bounds, the ranks equal, each card's peak
allocated memory beside one card's; then bf16 for 2 epochs of ``--steps``
steps, the steady (second) epoch's train examples/s of each.
``--train_only`` skips the serving check.

Exits non-zero on any mismatch.  A rank runs as ``--rank_run <json>``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PATCH, BATCH, BASE, FC_BAND = 64, 256, 64, 512
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CITIES = {"alpha": (1024, 1024), "beta": (960, 1088), "gamma": (1088, 960),
          "val": (1024, 1024)}


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _timed(fn, reps: int = 3) -> tuple[object, float]:
    """(fn(), median wall seconds of ``reps`` calls after one warm-up),
    every card synchronised around each call."""
    out = fn()
    walls = []
    for _ in range(reps):
        _sync_all()
        t0 = time.perf_counter()
        out = fn()
        _sync_all()
        walls.append(time.perf_counter() - t0)
    return out, sorted(walls)[len(walls) // 2]


def _peaks(fn) -> tuple[object, list[int]]:
    """(fn(), each card's peak allocated bytes during it)."""
    n = torch.cuda.device_count()
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    out = fn()
    _sync_all()
    return out, [torch.cuda.max_memory_allocated(i) for i in range(n)]


def serve(side: int) -> bool:
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.infer.sharded_scene import put_scene_sharded
    from fabric_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    n = mesh.shape["data"]
    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="bfloat16",
                 model_base=BASE)
    rng = np.random.RandomState(0)
    d1, d2 = (rng.randn(side, side, 13).astype(np.float32) for _ in range(2))
    mpx = side * side / 1e6
    ok = True
    for quant in ("none", "int8"):
        for band in (0, FC_BAND):
            mode = f"{'fullconv' if band else 'grid'} {quant}"
            kw = dict(bucket=512, device="cuda:0", quant=quant,
                      fullconv_band_rows=band)
            runs = {"1 card": ScenePredictor(cfg, **kw),
                    f"{n} cards, shard_scene": ScenePredictor(
                        cfg, mesh=mesh, shard_scene=True, **kw)}
            if not band:
                runs[f"{n} cards, tile batch split"] = ScenePredictor(
                    cfg, mesh=mesh, **kw)
            want = None
            for name, pred in runs.items():
                pred.predict(d1, d2)  # first call (int8: calibrates)
                mask, peaks = _peaks(lambda: pred.predict(d1, d2))
                _, wall = _timed(lambda: pred.predict(d1, d2))
                run = pred._get_runner(side, side)
                if pred.shard_scene:
                    args = [put_scene_sharded(d, mesh, torch.bfloat16)
                            for d in (d1, d2)]
                else:
                    args = [torch.from_numpy(d).to("cuda:0")
                            for d in (d1, d2)]
                _, run_s = _timed(lambda: run(*args))
                del args
                if want is None:
                    want = mask
                same = np.array_equal(mask, want)
                ok &= same
                print(f"serve {side}^2 {mode}, {name}: mask == 1 card's: "
                      f"{same} ({int((mask != want).sum())} pixels differ); "
                      f"predict {wall * 1e3:.1f} ms = {mpx / wall:.2f} "
                      f"Mpx/s, runner {run_s * 1e3:.1f} ms = "
                      f"{mpx / run_s:.2f} Mpx/s; peak allocated per card "
                      f"{[round(p / 2**20) for p in peaks]} MiB", flush=True)
            del runs
            torch.cuda.empty_cache()
    return ok


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_run(spec: dict) -> None:
    """One rank (or the single process) of a training run: train, then
    its variables and history into ``spec["out"]``."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.parallel import distributed
    from fabric_tpu_torch.train.loop import train
    from fabric_tpu_torch.weights import flatten_tree, variables_of

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.maybe_initialize()
    try:
        torch.cuda.reset_peak_memory_stats()
        state, history = train(Config(**spec["cfg"]),
                               run_scene_inference=False)
        params, stats = variables_of(state.model)
        r = distributed.rank()
        np.savez(os.path.join(spec["out"], f"vars_{r}.npz"),
                 **{"params/" + k: v for k, v in flatten_tree(params).items()},
                 **{"stats/" + k: v for k, v in flatten_tree(stats).items()})
        with open(os.path.join(spec["out"], f"history_{r}.json"), "w") as f:
            json.dump({"history": history, "peak_mib":
                       torch.cuda.max_memory_allocated() / 2 ** 20}, f)
    finally:
        distributed.shutdown()


def _train(root: str, tag: str, world: int, cfg: dict) -> str:
    """Run ``world`` ranks (one process without a group for 1) of a
    training run; its output directory."""
    out = os.path.join(root, tag)
    os.makedirs(out)
    spec = {"out": out, "cfg": dict(cfg, weight_dir=os.path.join(out, "w"),
                                    log_dir=os.path.join(out, "l"))}
    coord = f"localhost:{_free_port()}"
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("FABRIC_")}
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        if world > 1:
            env.update(FABRIC_COORDINATOR=coord,
                       FABRIC_NUM_PROCESSES=str(world),
                       FABRIC_PROCESS_ID=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fabric_tpu_torch.tools.multigpu_check",
             "--rank_run", json.dumps(spec)], env=env))
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if any(codes):
        raise SystemExit(f"multigpu_check: a rank of {tag} exited {codes}")
    return out


def _load(out: str, r: int = 0):
    with open(os.path.join(out, f"history_{r}.json")) as f:
        return dict(np.load(os.path.join(out, f"vars_{r}.npz"))), json.load(f)


def _mesh_shapes(spec: str | None, n: int) -> list[tuple[int, int, int]]:
    """The (data, spatial, model) meshes of ``--meshes`` ("DxSxM,...")."""
    if spec is None:
        return [(n, 1, 1), (1, n, 1)] + ([(2, n // 2, 1)]
                                         if n >= 4 and n % 2 == 0 else [])
    shapes = [tuple(int(v) for v in m.split("x")) for m in spec.split(",")]
    for shape in shapes:
        if int(np.prod(shape)) != n:
            raise SystemExit(f"mesh {shape} does not lay out {n} cards")
    return shapes


def train_check(steps: int, meshes: list[tuple[int, int, int]]) -> bool:
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    from fabric_tpu_torch.weights import flatten_tree, init_variables

    n = torch.cuda.device_count()
    ok = True
    with tempfile.TemporaryDirectory(prefix="fabric_mgpu_") as root:
        data = os.path.join(root, "data")
        generate_synthetic_dataset(data, Config(), cities=list(CITIES),
                                   sizes=list(CITIES.values()), seed=0)
        base = dict(dataset_dir=data, patch_size=96, stride=32,
                    batch_size=128, eval_batch_size=128, learning_rate=0.05,
                    loss_function="tversky", optimizer="sgd", model_base=BASE,
                    validation_cities=["val"], num_workers=2, seed=7)
        parity = dict(base, dtype="float32", epochs=1, steps_per_epoch=3)
        init = flatten_tree(init_variables(
            13, 2, BASE, torch.Generator().manual_seed(base["seed"]))[0])
        v1, r1 = _load(_train(root, "fp32_1", 1, parity))
        h1 = r1["history"]
        params = [k for k in v1 if k.startswith("params/")]
        stats = [k for k in v1 if k.startswith("stats/")]
        step_max = max(np.abs(v1[k] - init[k[len("params/"):]]).max()
                       for k in params)
        for d, s, m in meshes:
            tag = f"fp32_{d}x{s}x{m}"
            cfg = dict(parity, mesh_data=d, mesh_spatial=s, mesh_model=m)
            out = _train(root, tag, n, cfg)
            loaded = [_load(out, r) for r in range(n)]
            vr, hr = loaded[0][0], loaded[0][1]["history"]
            ranks_equal = all(np.array_equal(vr[k], o[0][k])
                              for o in loaded[1:] for k in vr)
            p_err = max(np.abs(vr[k] - v1[k]).max() for k in params)
            s_err = max(np.abs(vr[k] - v1[k]).max() / np.abs(v1[k]).max()
                        for k in stats)
            l1, ln = (h["train"][0]["cd_losses"] for h in (h1, hr))
            l_err = abs(ln - l1) / abs(l1)
            # chip_smoke.py's dp_train bounds
            good = (ranks_equal and l_err <= 1e-5
                    and p_err <= 1e-2 * step_max and s_err <= 1e-4)
            ok &= good
            print(f"train fp32, mesh {d}x{s}x{m} of {n} NCCL ranks vs 1 "
                  f"process, 3 steps of 128: loss rel {l_err:.3g} (bound "
                  f"1e-5), params max diff {p_err:.3g} (bound 1e-2 x "
                  f"largest update {step_max:.4g}), BN stats {s_err:.3g} "
                  f"of their largest magnitude (bound 1e-4), ranks equal "
                  f"{ranks_equal}; peak allocated per card "
                  f"{[round(o[1]['peak_mib']) for o in loaded]} MiB against "
                  f"{round(r1['peak_mib'])} on one card: "
                  f"{'ok' if good else 'MISMATCH'}", flush=True)
        rate = dict(base, dtype="bfloat16", epochs=2, steps_per_epoch=steps)
        for tag, world, (d, s, m) in [("bf16_1", 1, (1, 1, 1))] + [
                (f"bf16_{d}x{s}x{m}", n, (d, s, m)) for d, s, m in meshes]:
            out = _train(root, tag, world, dict(
                rate, mesh_data=d, mesh_spatial=s, mesh_model=m))
            run = os.path.join(out, "l", os.listdir(os.path.join(out,
                                                                 "l"))[0])
            recs = [json.loads(x) for x in open(os.path.join(
                run, "metrics.jsonl")) if "train_examples_per_sec" in x]
            peaks = [round(_load(out, r)[1]["peak_mib"])
                     for r in range(world)]
            print(f"train bf16, mesh {d}x{s}x{m} ({world} process(es)), "
                  f"global batch 128: steady epoch "
                  f"{recs[-1]['train_examples_per_sec']:.1f} train "
                  f"examples/s, loader wait "
                  f"{recs[-1]['train_feed_wait_s']:.2f} s; peak "
                  f"allocated per card {peaks} MiB", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--meshes", default=None,
                    help="training meshes DxSxM,... of the cards (default: "
                         "nx1x1,1xnx1,2x(n/2)x1)")
    ap.add_argument("--train_only", action="store_true",
                    help="skip the serving check")
    ap.add_argument("--rank_run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_run:
        rank_run(json.loads(args.rank_run))
        return 0
    if torch.cuda.device_count() < 2:
        print("multigpu_check needs at least two cards", file=sys.stderr)
        return 1
    from fabric_tpu_torch.ops import _build
    _build.build()
    print(", ".join(torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    n = torch.cuda.device_count()
    ok = True if args.train_only else serve(args.scene)
    ok &= train_check(args.steps, _mesh_shapes(args.meshes, n))
    print("multigpu_check:", "ok" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
