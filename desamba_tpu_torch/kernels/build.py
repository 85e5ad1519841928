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

Each library links the CUDA runtime statically (nvcc's default), so it
keeps its own current device a thread, 0 at first, whatever PyTorch's is.
The path's launchers (``rescore.cu``, ``ladder.cu``, ``ladder_pack.cu``,
``chain.cu``) take the ordinal of their tensors' card and make it current
before they set an attribute or launch; their wrappers pass it and refuse
tensors on two cards.
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
           "ladder.cu", "ladder_pack.cu", "chain.cu")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ShardTab of kernels/shard.cuh: the accessor of a gather table cut by row
# range over the mesh's idx axis (parallel/sharded.py), passed by value in
# a launch's argument block
MAX_IDX = 8


class ShardTab(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * MAX_IDX), ("len", ctypes.c_int),
                ("shards", ctypes.c_int)]


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


_peers: set = set()


def enable_peers(lib, entry, home, devices):
    """Let card ``home`` load from each other card of ``devices`` in the
    kernels of ``lib`` (a library links its own CUDA runtime, so each
    enables its own access): ``entry(home, peer)`` once a pair. Raises
    where the call fails (a pair without peer access among them)."""
    for dev in devices:
        if dev == home:
            continue
        key = (lib._name, home.index, dev.index)
        if key in _peers:
            continue
        rc = getattr(lib, entry)(home.index, dev.index)
        if rc != 0:
            raise RuntimeError(f"{entry}({home.index}, {dev.index}) failed: "
                               f"CUDA error {rc}")
        _peers.add(key)


def rescore_lib():
    # 12 pointers, nine sizes, the card's ordinal, stream (the sharded
    # launcher: the reference words as a pointer to their ShardTab)
    sig = "p" * 12 + "i" * 10 + "p"
    return _bound("rescore.cu", {"rescore_launch": sig,
                                 "rescore_sharded_launch": sig,
                                 "rescore_enable_peer": "ii"})


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
    # a pointer to the LadderArgs (ShardedLadderArgs) block, the card's
    # ordinal, stream; the structs' sizes; a block's shared memory at an
    # SP_SET capacity; peer access from one card to another
    return _bound("ladder.cu", {"ladder_fast_launch": "pip",
                                "ladder_slow_launch": "pip",
                                "ladder_fast_sharded_launch": "pip",
                                "ladder_slow_sharded_launch": "pip",
                                "ladder_args_size": "",
                                "ladder_sharded_args_size": "",
                                "ladder_smem_bytes": "i",
                                "ladder_enable_peer": "ii"})


def ladder_pack_lib():
    # pack2: codes, out, n, l, w, the card's ordinal, stream; the anchor
    # pack: anchors, a_cnt, flag, iv_ovf, packed, info, ovf, nb, a_cap,
    # pack_cap, the card's ordinal, stream
    return _bound("ladder_pack.cu", {
        "ladder_pack2_launch": "pp" + "iii" + "i" + "p",
        "ladder_anchor_pack_launch": "p" * 7 + "iii" + "i" + "p"})


def chain_lib():
    # anc, n_anc, chains, n_out, pre, ovf, B, A2, (M3: its shared memory
    # bytes and warps a block), the card's ordinal, stream
    return _bound("chain.cu", {"chain_m2_launch": "p" * 6 + "iii" + "p",
                               "chain_m3_launch": "p" * 6 + "iiiii" + "p"})
