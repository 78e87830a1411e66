"""The card: waiting for it, its memory peak, its name and power limit,
CUDA-event timing, and the reference's float32 settings."""

from __future__ import annotations

import gc
import subprocess

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_peak(dev: torch.device) -> int:
    """The process's peak of allocated device memory so far (0 on the
    CPU, which the benchmark never reports as a device)."""
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def release(dev: torch.device) -> None:
    """Free what the program held, before the reference runs."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def describe(dev: torch.device) -> dict:
    """{"kind": the card's name, "power_limit": nvidia-smi's reading}."""
    if dev.type != "cuda":
        return {"kind": "cpu"}
    out = {"kind": torch.cuda.get_device_name(dev)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=10)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def timed_ms(dev: torch.device, fn, repeats: int) -> float:
    """Milliseconds a call of ``fn`` takes on the device, over ``repeats``
    back-to-back calls between two CUDA events."""
    if dev.type != "cuda":
        raise RuntimeError("device timings come from the card alone")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def reference_mode() -> None:
    """Full float32 for the reference: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
