"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``fabric_tpu_torch/csrc/<name>.cu`` becomes its own shared library
with a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Libraries land in ``fabric_tpu_torch/build/``
(git-ignored) under a name that carries a hash of the sources and flags, so
an edited kernel is rebuilt and an unchanged one is reused.  A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("conv3x3_bias_relu", "double_conv3x3_bias_relu", "int8_matmul",
           "conv3x3_s8", "bn_relu", "siamese_s8", "conv3x3_bias_relu_f32",
           "double_conv3x3_bias_relu_f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# these kernels round as their plain PyTorch versions: no float
# multiply-add is contracted but the ones they spell out (__fmaf_rn)
EXTRA_FLAGS = {name: ("-fmad=false",)
               for name in ("conv3x3_s8", "bn_relu", "siamese_s8")}

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return found


def library_path(name: str) -> str:
    """Where the library for ``csrc/<name>.cu`` is built, keyed by the
    contents of the source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ()))
                       .encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as fin:
            h.update(fname.encode() + b"\0" + fin.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> compiler
    output (empty for a library that was already built)."""
    with _lock:
        os.makedirs(BUILD, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.tmp.{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o",
                   tmp, os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        logs = {name: "" for name in names}
        failed = []
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{logs[name]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return ctypes.CDLL(library_path(name))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        fn = lib.fabric_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({fn(err).decode()})")


def on_device(index: int):
    """A context in which CUDA device ``index`` is current: a no-op where
    it already is, the common case, which then costs the host nothing."""
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``index``
    (what ``torch.cuda.current_stream(index).cuda_stream`` gives, without
    making a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(index)
