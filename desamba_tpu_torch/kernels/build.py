"""Build and bind the port's hand-written CUDA kernels.

Each ``*.cu`` source here exposes a plain C launcher. It is compiled with
``nvcc`` for ``sm_90a`` into ``kernels/_build/`` (listed in .gitignore) at
first use, and loaded with ctypes: no PyTorch headers, so a build takes
seconds. Nothing is compiled at import time, and nothing catches a failed
build: a missing ``nvcc`` or a compile error raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("rescore.cu",)
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(src):
    with open(os.path.join(_HERE, src), "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{src[:-3]}_{tag.hexdigest()[:12]}.so")


def start_build(src):
    """Start nvcc for one source (returns the Popen, or None if the
    library is already built)."""
    so = _lib_path(src)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", so + ".tmp", os.path.join(_HERE, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(src, proc):
    """Wait for a build started by start_build; returns nvcc's output
    (register and local-memory use from -Xptxas -v)."""
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{out}")
    so = _lib_path(src)
    os.replace(so + ".tmp", so)
    return out


def build_all():
    """Build every kernel source at once, one nvcc each, all started
    together. Returns {source: nvcc output}."""
    procs = {src: start_build(src) for src in SOURCES}
    return {src: finish_build(src, p) for src, p in procs.items()}


def load(src):
    """The ctypes library of one kernel source, built on first use."""
    if src not in _libs:
        finish_build(src, start_build(src))
        _libs[src] = ctypes.CDLL(_lib_path(src))
    return _libs[src]


def rescore_lib():
    lib = load("rescore.cu")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rescore_launch.argtypes = [p] * 12 + [i] * 8 + [p]
        lib.rescore_launch.restype = ctypes.c_int
        lib._bound = True
    return lib
