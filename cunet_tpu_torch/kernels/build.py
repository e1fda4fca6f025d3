"""Build and load the hand-written CUDA kernels of ``cunet_tpu_torch/csrc``.

The sources are compiled by ``nvcc``, one process per source started
together (``source_seconds`` keeps when each finished), and linked into
one shared library with a plain C interface,
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
           "bottleneck_kernels.cu", "eval_kernels.cu", "f32_kernels.cu",
           "dw_f32_kernels.cu", "dx_f32_kernels.cu", "fwd_f32_kernels.cu",
           "tb_dx_f32_kernels.cu", "conv_f32_kernels.cu", "i8_kernels.cu")
HEADERS = ("common.cuh", "halo.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib = None
build_seconds = None   # wall time of this process's build; None if loaded
source_seconds = {}    # each source's compile, from the build's start


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
        logs = [open(Path(work) / f"{Path(s).stem}.log", "w+")
                for s in SOURCES]
        procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT,
                                  text=True) for c, f in zip(cmds, logs)]
        source_seconds.clear()
        while len(source_seconds) < len(SOURCES):
            for name, proc in zip(SOURCES, procs):
                if name not in source_seconds and proc.poll() is not None:
                    source_seconds[name] = time.perf_counter() - t0
            time.sleep(0.05)
        for cmd, proc, f in zip(cmds, procs, logs):
            f.seek(0)
            _finish(cmd, proc.returncode, f.read())
            f.close()
        # link to a temporary name, then rename: a concurrent process never
        # loads a half-written library
        tmp = str(Path(work) / "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        _finish(cmd, r.returncode, r.stdout)
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def _finish(cmd, returncode, output) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n"
                           f"{' '.join(cmd)}\n{output}")


def _declare(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    F = ctypes.c_float
    sigs = {
        "cunet_affine_dot": [P, L, L, I, P, P, L, L, I, P, I, I, P, P, L, L,
                             L, *[I] * 11, P],
        "cunet_conv3x3": [P, L, L, I, I, I, P, I, P, P, L, L, I, P, L,
                          *[I] * 10, P],
        "cunet_maxpool2": [P, L, P, L, I, I, I, I, P],
        "cunet_upsample2": [P, L, P, L, I, I, I, I, P],
        "cunet_maxpool2_f32": [P, L, P, L, I, I, I, I, P],
        "cunet_upsample2_f32": [P, L, P, L, I, I, I, I, P],
        "cunet_conv3x3_f32": [P, L, L, I, I, I, P, I, P, P, L, L, P, L, P,
                              P, P, L, I, I, I, I, I, P, P],
        "cunet_conv_f32": [P, L, L, I, I, I, P, I, I, P, P, L, L, P, L, P,
                           P, P, L, P, *[I] * 6, P],
        "cunet_fwd_f32": [P, P, P, I, P, L, P, P, L, L, I, P, L, I, P, L, L,
                          L, I, I, I, I, P],
        "cunet_dx_f32": [P, L, L, I, P, L, I, P, L, P, P, L, L, I, P, L, P,
                         *[I] * 3, P],
        "cunet_dw_f32": [P, L, I, I, I, I, I, P, P, L, I, I, P, L, I, P,
                         *[I] * 12, P],
        "cunet_bn_stats": [P, L, L, L, I, P, I, I, I, P],
        "cunet_bn_bwd": [P, L, P, L, L, L, I, P, P, F, P, L, I, P,
                         *[I] * 8, P],
        "cunet_dx": [P, L, L, I, P, I, I, P, L, P, P, L, L, I, P, L,
                     *[I] * 10, P],
        "cunet_conv3x3_dx": [P, L, L, I, I, I, P, I, P, L, P, P, L, L, I, P,
                             L, *[I] * 14, P],
        "cunet_dw": [P, L, L, I, P, P, L, L, I, P, L, I, P, *[I] * 9, P],
        "cunet_conv3x3_dw": [P, L, L, I, I, I, P, P, L, L, I, P, L, I, P,
                             *[I] * 11, P],
        "cunet_drop_mask": [P, L, I, P, L, L, I, L, ctypes.c_uint,
                            ctypes.c_uint, F, P],
        "cunet_threefry_mask": [P, L, I, P, L, L, I, ctypes.c_uint,
                                ctypes.c_uint, ctypes.c_uint, F, P],
        "cunet_sum_rows": [P, I, L, P, P],
        "cunet_maxpool2_bwd": [P, L, P, L, P, L, I, I, I, I, I, P],
        "cunet_upsample2_bwd": [P, L, P, L, I, I, I, I, I, P],
        "cunet_affine_dot_i8": [P, L, L, I, P, P, P, L, I, F, P, P, P, L, L,
                                L, *[I] * 18, P],
        "cunet_conv3x3_i8": [P, L, L, I, I, I, P, I, F, P, L, *[I] * 13, P],
        "cunet_int8_matmul_dequant": [P, L, L, I, P, I, I, P, F, P, L, P],
        "cunet_tb_fill_table": [P, I, P, P],
        "cunet_tb_stats": [P, I, L, I, L, P, P],
        "cunet_tb_stats_f32": [P, I, L, I, L, P, P, P],
        "cunet_tb_apply": [P, I, L, I, P, P, P, I, P, L, *[I] * 11, P],
        "cunet_tb_bwd_reduce": [P, I, L, I, P, L, I, P, P, P, P, L, *[I] * 10,
                                P, P, P],
        "cunet_tb_bwd_reduce_f32": [P, I, L, I, P, L, I, P, P, P, P, P, L, I,
                                    I, P, P, P],
        "cunet_tb_bwd_dx": [P, I, L, I, P, L, I, P, P, P, P, P, *[I] * 8, P],
        "cunet_tb_split_g": [P, L, L, I, P, P],
        "cunet_tb_bwd_dx_f32": [P, I, L, I, P, I, P, P, P, P, P, I, P],
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
