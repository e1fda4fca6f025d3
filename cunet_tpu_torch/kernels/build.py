"""Build and load the hand-written CUDA kernels of ``cunet_tpu_torch/csrc``.

The sources are compiled by ``nvcc``, one process per source started
together, and linked into one shared library with a plain C interface,
loaded with ``ctypes``: no PyTorch header is compiled, which keeps the build
short (an extension built against PyTorch's headers compiles them all). The build runs at the first CUDA launch (never at
import: a machine without a card has no ``nvcc``) into
``cunet_tpu_torch/_build/``, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the library already there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("buf_kernels.cu", "train_kernels.cu", "quant_kernels.cu",
           "bottleneck_kernels.cu", "eval_kernels.cu", "f32_kernels.cu")
HEADERS = ("common.cuh", "halo.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib = None
build_seconds = None   # wall time of this process's build; None if loaded


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcunet_buf-{_digest()}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists already."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [str(Path(work) / f"{Path(s).stem}.o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        for cmd, proc in zip(cmds, procs):
            _finish(cmd, proc)
        # link to a temporary name, then rename: a concurrent process never
        # loads a half-written library
        tmp = str(Path(work) / "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        _finish(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def _finish(cmd, proc) -> None:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{stdout}\n{stderr}")


def _declare(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    F = ctypes.c_float
    sigs = {
        "cunet_affine_dot": [P, L, L, I, P, P, L, L, I, P, I, I, P, P, L, L,
                             L, *[I] * 10, P],
        "cunet_conv3x3": [P, L, L, I, I, I, P, I, P, P, L, L, I, P, L,
                          *[I] * 10, P],
        "cunet_maxpool2": [P, L, P, L, I, I, I, I, P],
        "cunet_upsample2": [P, L, P, L, I, I, I, I, P],
        "cunet_maxpool2_f32": [P, L, P, L, I, I, I, I, P],
        "cunet_upsample2_f32": [P, L, P, L, I, I, I, I, P],
        "cunet_conv3x3_f32": [P, L, L, I, I, I, P, I, P, P, L, L, P, L, P,
                              P, P, L, I, I, I, I, I, P, P],
        "cunet_affine_f32": [P, L, L, I, P, P, L, L, P, I, I, P, L, P, P, P,
                             L, L, L, I, I, I, I, P],
        "cunet_dw_f32": [P, L, L, I, I, I, I, P, P, L, L, P, L, I, P, I, I,
                         I, I, P],
        "cunet_bn_stats": [P, L, L, L, I, P, I, I, I, P],
        "cunet_bn_bwd": [P, L, P, L, L, L, I, P, P, F, P, L, I, P,
                         *[I] * 7, P],
        "cunet_dx": [P, L, L, I, P, I, I, P, L, P, P, L, L, I, P, L,
                     *[I] * 10, P],
        "cunet_conv3x3_dx": [P, L, L, I, I, I, P, I, P, L, P, P, L, L, I, P,
                             L, *[I] * 14, P],
        "cunet_dw": [P, L, L, I, P, P, L, L, I, P, L, I, P, *[I] * 9, P],
        "cunet_conv3x3_dw": [P, L, L, I, I, I, P, P, L, L, I, P, L, I, P,
                             *[I] * 11, P],
        "cunet_drop_mask": [P, L, I, P, L, L, I, L, ctypes.c_uint,
                            ctypes.c_uint, F, P],
        "cunet_sum_rows": [P, I, L, P, P],
        "cunet_maxpool2_bwd": [P, L, P, L, P, L, I, I, I, I, I, P],
        "cunet_upsample2_bwd": [P, L, P, L, I, I, I, I, I, P],
        "cunet_affine_dot_i8": [P, L, L, I, P, P, P, I, I, F, P, P, P, L, L,
                                L, I, P],
        "cunet_conv3x3_i8": [P, L, L, I, I, I, P, I, F, P, L, I, P],
        "cunet_int8_matmul_dequant": [P, L, L, I, P, I, I, P, F, P, L, P],
        "cunet_tb_fill_table": [P, I, P, P],
        "cunet_tb_stats": [P, I, L, I, L, P, I, P],
        "cunet_tb_apply": [P, I, L, I, P, P, P, I, P, L, *[I] * 10, P],
        "cunet_tb_bwd_reduce": [P, I, L, I, P, L, I, P, P, P, L, *[I] * 10,
                                P, P, I, P],
        "cunet_tb_bwd_dx": [P, I, L, I, P, L, I, P, P, P, P, *[I] * 9, P],
        "cunet_table_dot": [P, P, P, I, P, P, I, I, L, P, P, P, P, P, P, I,
                            I, I, P, P, I, P, L, L, L, P, L, P],
        "cunet_table_dot_f32": [P, P, P, I, P, P, I, I, L, P, P, P, P, P, P,
                                I, I, I, P, P, I, P, L, L, L, P, L, I, I, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    lib.cunet_error_string.argtypes = [I]
    lib.cunet_error_string.restype = ctypes.c_char_p
    return lib


def lib():
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(str(build())))
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = _lib.cunet_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}): {msg}")
