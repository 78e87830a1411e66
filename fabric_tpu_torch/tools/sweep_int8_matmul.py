"""Try variants of the int8 / bf16 GEMM kernel's pipeline on the card.

    python -m fabric_tpu_torch.tools.sweep_int8_matmul [--rounds 2]

Each variant is a copy of ``csrc/int8_matmul.cu`` with other values of its
constants (``kMmKB`` bytes of K per chunk, ``kMmABuf`` A chunks in flight,
``kMmBlocks`` blocks per SM) and a number of weight-ring slots, built with
the package's nvcc flags into a temporary directory and loaded in place of
the wrapper's library.  Each is checked against the plain version (a
ragged product and the timed one, exactly) and timed at the microbench's
131072 x 512 x 512 in int8 and bf16, the variants in turns, ``--rounds``
times.  Prints ptxas' register and spill lines and one line per variant and
round; the shipped constants are the first variant.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import tempfile

import torch

from fabric_tpu_torch.ops import _build
from fabric_tpu_torch.ops import int8_matmul as im

# (kMmKB, kMmABuf, kMmBlocks, ring slots)
VARIANTS = [(128, 5, 1, 4), (128, 2, 2, 4), (128, 3, 1, 4), (128, 4, 1, 4),
            (128, 6, 1, 4), (128, 5, 1, 6), (64, 4, 2, 4), (256, 2, 1, 4)]


def _build_variants(variants, out_dir):
    src = open(os.path.join(_build.CSRC, "int8_matmul.cu")).read()
    for header in os.listdir(_build.CSRC):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC, header), out_dir)
    procs = []
    for i, (kb, abuf, blocks, _) in enumerate(variants):
        s = src
        for name, value in (("kMmKB", kb), ("kMmABuf", abuf),
                            ("kMmBlocks", blocks)):
            s, hits = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", s)
            if hits != 1:
                raise RuntimeError(f"{name} not found in int8_matmul.cu")
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(s)
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so",
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = []
    for i, proc in enumerate(procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {variants[i]} failed to build:\n"
                               f"{log}")
        print(f"variant {i} {variants[i]} ptxas: " + " | ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line), flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, f"v{i}.so"))
        fn = lib.fabric_int8_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.fabric_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        libs.append(lib)
    return libs


def _ms(fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_int8_matmul needs an NVIDIA GPU")
    print(torch.cuda.get_device_name(0), flush=True)
    g = torch.Generator().manual_seed(0)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).cuda()

    m, k, n = 131072, 512, 512
    a8, b8, ar, br = s8(m, k), s8(k, n), s8(131, 515), s8(515, 257)
    shipped = (im._lib, im.KB, im.STAGES)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_variants(VARIANTS, tmp)
        try:
            for rnd in range(args.rounds):
                for i, ((kb, _, _, stages), lib) in enumerate(
                        zip(VARIANTS, libs)):
                    im._lib, im.KB, im.STAGES = (lambda lib=lib: lib), kb, \
                        stages
                    out = []
                    for dt in (torch.int8, torch.bfloat16):
                        a, b = a8.to(dt), b8.to(dt)
                        ok = torch.equal(
                            im.int8_matmul(ar.to(dt), br.to(dt)),
                            im.int8_matmul_reference(ar.to(dt), br.to(dt)))
                        ok &= torch.equal(im.int8_matmul(a, b),
                                          im.int8_matmul_reference(a, b))
                        out.append(f"{str(dt)[6:]} "
                                   f"{'exact' if ok else 'WRONG'} "
                                   f"{_ms(lambda: im.int8_matmul(a, b)):.4f}"
                                   f" ms")
                    print(f"round {rnd} variant {i} (KB, A chunks, blocks "
                          f"per SM, ring slots) {VARIANTS[i]}: "
                          + "; ".join(out), flush=True)
        finally:
            im._lib, im.KB, im.STAGES = shipped
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
