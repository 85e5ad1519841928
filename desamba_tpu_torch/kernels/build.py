"""Build and bind the port's hand-written CUDA kernels.

Each ``*.cu`` source here exposes plain C launchers (the ``*.cuh`` headers
beside them are shared device code). It is compiled with
``nvcc`` for ``sm_90a`` into ``kernels/_build/`` (listed in .gitignore) at
first use, and loaded with ctypes: no PyTorch headers, so a build takes
seconds. Nothing is compiled at import time, and nothing catches a failed
build: a missing ``nvcc`` or a compile error raises.

Host threads share the kernels: ``load`` and ``_bound`` build, load and
bind a source once under one lock, and ``LAUNCH_LOCK`` makes each launch
one critical section (a launcher may set its kernel's shared-memory limit
before it launches, and another thread must not change that limit in
between).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("rescore.cu", "cmpcount.cu", "plops.cu", "micro.cu", "caps.cu",
           "ladder.cu", "chain.cu")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
_LOAD_LOCK = threading.Lock()   # one build, load and binding a source
LAUNCH_LOCK = threading.Lock()  # held by the wrappers around each launch


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(src):
    """The library's path, tagged by the source, every ``*.cuh`` header
    beside it (a source may include any of them, so an edit to a header
    must not leave a stale library behind) and the flags."""
    tag = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_HERE) if f.endswith(".cuh"))
    for name in [src, *headers]:
        with open(os.path.join(_HERE, name), "rb") as f:
            tag.update(name.encode() + b"\0" + f.read())
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
    with _LOAD_LOCK:
        procs = {src: start_build(src) for src in SOURCES}
        return {src: finish_build(src, p) for src, p in procs.items()}


def load(src):
    """The ctypes library of one kernel source, built on first use (once,
    whichever thread comes first)."""
    lib = _libs.get(src)
    if lib is None:
        with _LOAD_LOCK:
            lib = _libs.get(src)
            if lib is None:
                finish_build(src, start_build(src))
                lib = _libs[src] = ctypes.CDLL(_lib_path(src))
    return lib


def _bound(src, signatures):
    """The library of ``src`` with each launcher's ctypes signature set:
    ``signatures`` maps a function name to a string of ``p`` (a pointer or
    the stream: ``c_void_p``) and ``i`` (``c_int``). Every launcher
    returns the CUDA error code of its launch."""
    lib = load(src)
    if not getattr(lib, "_bound", False):
        with _LOAD_LOCK:
            if not getattr(lib, "_bound", False):
                kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
                for name, sig in signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = [kinds[c] for c in sig]
                    fn.restype = ctypes.c_int
                lib._bound = True
    return lib


def rescore_lib():
    return _bound("rescore.cu", {"rescore_launch": "p" * 12 + "i" * 9 + "p"})


def cmpcount_lib():
    return _bound("cmpcount.cu", {"cmpcount_launch": "ppp" + "iiii" + "p"})


def plops_lib():
    # body, a, b, out, R, n_rows, eight int parameters, stream
    return _bound("plops.cu", {"plops_launch": "ipppii" + "i" * 8 + "p"})


def micro_lib():
    return _bound("micro.cu", {
        "micro_rowgather": "ppp" + "iii" + "p",
        "micro_egather": "ppp" + "iiii" + "p",
        "micro_dynslice": "ppp" + "i" * 7 + "p",
        "micro_resident_blocks": "ii",
        "micro_rgather": "ppp" + "i" * 5 + "p",
        "micro_lgather": "ppp" + "i" * 5 + "p",
        "micro_gridstep": "pp" + "ii" + "p",
        "micro_dmaloop": "ppp" + "i" * 5 + "p",
        "micro_scalarloop": "ppp" + "iii" + "p",
        "micro_oneprog": "ppp" + "iii" + "p",
        "micro_vecwork": "pp" + "ii" + "p",
    })


def caps_lib():
    # probe, a, b, out, the table's rows, stream
    return _bound("caps.cu", {"caps_launch": "ippp" + "i" + "p"})


def ladder_lib():
    # a pointer to the LadderArgs block, stream; the struct's size; a
    # block's shared memory at an SP_SET capacity
    return _bound("ladder.cu", {"ladder_fast_launch": "pp",
                                "ladder_slow_launch": "pp",
                                "ladder_args_size": "",
                                "ladder_smem_bytes": "i"})


def chain_lib():
    # anc, n_anc, chains, n_out, pre, ovf, B, A2, (M3: its shared memory
    # bytes and warps a block), stream
    return _bound("chain.cu", {"chain_m2_launch": "p" * 6 + "ii" + "p",
                               "chain_m3_launch": "p" * 6 + "iiii" + "p"})
