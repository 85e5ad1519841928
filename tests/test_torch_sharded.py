"""The port's shard_full layout (``parallel/sharded.py``, every gather table
cut by row range over the mesh's ``idx`` axis) on the CPU, against the JAX
package's. Everything compared is integer, so every case is exact
(tolerance 0):

(a) the gathers: ``ShardedArray``/``ShardedRows`` ``__getitem__``,
    ``as_rows(9)`` and ``a[0, i]`` equal the JAX ``wrap_local`` gather
    inside ``shard_map`` at ``n_idx`` 1, 2 and 4, on lengths that no shard
    count divides, on uint8 bitmaps and at the indices -3, n and n + 5
    (which read 0, where a whole table's ``intops.take`` clamps);
(b) the whole layout: ``MeshClassifier(shard_full=True)`` at (2, 4) of the
    CPU gives the JAX ``MeshClassifier(shard_full=True)``'s SAM and
    ``fallback_stats()`` on the conftest's 8 virtual CPU devices, on the
    24-read corpus of ``tests/test_sharded_index.py``, and the SAM of the
    port's default-layout mesh at (2, 4); its eager ladders and rescore
    read the shards;
(c) the shards: no shard is as large as its (padded) table, and none that
    is longer than ``n_idx * ROW_ALIGN`` is as large as the table itself;
    the shards concatenate back to it, each an allocation of its own;
(d) the accessor through the host-C++ build of the kernel sources
    (``tests/cuda_host/``): ``kernels/shard.cuh`` equals ``ShardedArray``
    and ``intops.take`` element by element, and the B2, B3 and K1 kernels
    over ``Flat`` and ``Sharded`` tables give equal outputs (both equal to
    the eager plain version on the sharded tables) on one captured call
    each;
(e) the entry: ``entry.dryrun_multichip(8, device="cpu")``'s second phase.

The JAX programs compile once, at module scope (``jax_full``)."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_stages import assert_same, port_index  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "desamba_tpu_torch", "kernels")


def _corpus(idx):
    """The 24 reads of tests/test_sharded_index.py:40."""
    from desamba_tpu.engine.gold.mapseed import get_ref
    from desamba_tpu.io.fastx import Record

    rng = np.random.default_rng(11)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    recs = []
    for k in range(24):
        ln = int(rng.integers(150, 700))
        st = int(rng.integers(0, total - ln))
        seq = get_ref(idx.ref_bin, st, ln, True).copy()
        pos = rng.integers(0, ln, size=ln // 12)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4
        s = "".join("ACGT"[c] for c in seq)
        if k % 3 == 1:
            s = "".join("ACGT"[comp[c]] for c in seq[::-1])
        if k % 7 == 0:
            s = s[:40]
        recs.append(Record(f"r{k}", "", s))
    return recs


def _sam(pkg, eng, idx, recs):
    import importlib

    fmt = importlib.import_module(f"{pkg}.io.sam").format_result
    return "".join(fmt(r, idx.ref_name, eng.opts)
                   for r in eng.classify_reads(recs))


# ---- (a) the gathers ---------------------------------------------------------

def _jax_gather(n_idx, glob, idx, view):
    """The JAX package's sharded gather of ``glob`` at ``idx`` on a
    (1, n_idx) mesh of the virtual CPU devices."""
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from desamba_tpu.parallel.mesh import make_mesh
    from desamba_tpu.parallel.sharded import shard_table, wrap_local

    mesh = make_mesh(1, n_idx)
    placed, gshape = shard_table(mesh, glob)

    def step(flat, i):
        a = wrap_local(flat, gshape)
        if view == "rows9":
            return a.as_rows(9)[i]
        return a[0, i] if view == "row0" else a[i]

    return np.asarray(jax.jit(shard_map(
        step, mesh=mesh, in_specs=(P("idx"), P()), out_specs=P(),
        check_rep=False))(placed, jnp.asarray(idx)))


GATHERS = [  # (view, table length, dtype)
    ("flat", 103, np.int32), ("flat", 9223, np.int32),
    ("flat", 9223, np.uint8), ("rows9", 9223 * 9, np.int32),
    ("row0", 4611, np.int32)]


@pytest.mark.parametrize("n_idx", [1, 2, 4])
@pytest.mark.parametrize("view,n,dtype", GATHERS,
                         ids=[f"{v}-{n}-{np.dtype(d).name}"
                              for v, n, d in GATHERS])
def test_gathers_equal_jax_wrap_local(n_idx, view, n, dtype):
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual multi-device CPU mesh")
    from desamba_tpu_torch.engine.device.intops import take
    from desamba_tpu_torch.parallel import make_mesh
    from desamba_tpu_torch.parallel.sharded import ShardedArray, shard_table

    rng = np.random.default_rng(n + n_idx)
    hi = 256 if dtype == np.uint8 else 1 << 30
    glob = rng.integers(0, hi, size=n).astype(dtype)
    if view == "row0":
        glob = glob.reshape(1, n)
    rows = -(-n // 9) if view == "rows9" else n
    mesh = make_mesh(1, n_idx, devices=["cpu"] * n_idx)
    shards, gshape = shard_table(mesh, torch.from_numpy(glob))
    a = ShardedArray(shards[0], gshape, "cpu")
    # every shard's edges (in rows of the view), random rows, and the
    # indices outside the table
    span = a.shard_len // (9 if view == "rows9" else 1)
    edges = [e for k in range(1, n_idx) for e in
             (k * span - 1, k * span, k * span + 1) if e < rows]
    idx = np.concatenate([rng.integers(0, rows, size=37), edges,
                          [-3, 0, rows - 1, rows, rows + 5]]).astype(np.int32)
    exp = _jax_gather(n_idx, glob, idx, view)
    ti = torch.from_numpy(idx)
    if view == "rows9":
        got = a.as_rows(9)[ti]
        assert a.reshape(-1, 9).shape == (rows, 9)
    elif view == "row0":
        got = a[0, ti]
    else:
        got = a[ti]
        assert torch.equal(take(a, ti), got)    # take hands it its own
    assert got.dtype == torch.from_numpy(glob).dtype
    assert_same(exp, got, f"{view} n_idx={n_idx}")
    # out of range: 0, where a whole table clamps
    outside = np.isin(idx, [-3, rows, rows + 5])
    assert not got.numpy()[outside].any()
    if view == "flat":
        whole = take(torch.from_numpy(glob), ti).numpy()
        assert np.array_equal(whole[~outside], got.numpy()[~outside])


# ---- (b), (c) the whole layout and its shards --------------------------------

@pytest.fixture(scope="module")
def jax_full(small_my_index):
    """The corpus and the JAX MeshClassifier(shard_full=True) at (2, 4) on
    it: SAM and fallback stats."""
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.parallel.classifier import MeshClassifier as JM
    from desamba_tpu.parallel.mesh import make_mesh as jmake_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    idx = small_my_index
    recs = _corpus(idx)
    eng = JM(idx, Options(), mesh=jmake_mesh(2, 4), shard_full=True)
    return dict(idx=idx, recs=recs, sam=_sam("desamba_tpu", eng, idx, recs),
                stats=eng.fallback_stats())


@pytest.fixture(scope="module")
def port_full(jax_full):
    """The port's MeshClassifier(shard_full=True) at (2, 4) of the CPU
    after its run over the corpus, with its SAM, the first call of each
    ladder and of the rescore (their arguments), and the gathers its
    ShardedArray tables answered."""
    from desamba_tpu_torch.engine.device import rescore_pl
    from desamba_tpu_torch.parallel import MeshClassifier, make_mesh
    from desamba_tpu_torch.parallel import classifier as pc
    from desamba_tpu_torch.parallel import sharded

    idx = jax_full["idx"]
    eng = MeshClassifier(port_index(idx), None, shard_full=True,
                         mesh=make_mesh(2, 4, devices=["cpu"] * 8))
    calls, gathers = {}, [0]

    def spy(name, fn):
        def run(*a, **kw):
            calls.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return run

    def counted(*a):
        gathers[0] += 1
        return orig_sum(*a)

    orig_sum = sharded._owned_sum
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pc, "run_fast_ladder", spy("fast", pc.run_fast_ladder))
        mp.setattr(pc, "run_slow_ladder", spy("slow", pc.run_slow_ladder))
        mp.setattr(rescore_pl, "rescore", spy("rescore", rescore_pl.rescore))
        mp.setattr(sharded, "_owned_sum", counted)
        sam = _sam("desamba_tpu_torch", eng, idx, jax_full["recs"])
    return dict(eng=eng, sam=sam, calls=calls, gathers=gathers[0])


def test_shard_full_equals_jax_shard_full_and_default_mesh(jax_full,
                                                           port_full):
    from desamba_tpu_torch.parallel import MeshClassifier, make_mesh

    idx, eng = jax_full["idx"], port_full["eng"]
    assert port_full["sam"] == jax_full["sam"]
    stats = eng.fallback_stats()
    assert {k: stats[k] for k in jax_full["stats"]} == jax_full["stats"]
    default = MeshClassifier(port_index(idx), None,
                             mesh=make_mesh(2, 4, devices=["cpu"] * 8))
    assert _sam("desamba_tpu_torch", default, idx,
                jax_full["recs"]) == port_full["sam"]
    # the ladders and the rescore ran, on the shards
    assert {"fast", "slow", "rescore"} <= set(port_full["calls"])
    assert port_full["gathers"] > 1000
    (ixr, fm, _, h13, *_), _ = port_full["calls"]["fast"]
    assert not torch.is_tensor(ixr.isa) and not torch.is_tensor(fm)
    assert not torch.is_tensor(h13)
    assert not torch.is_tensor(port_full["calls"]["rescore"][0][1])


def test_no_shard_is_as_large_as_its_table(port_full):
    from desamba_tpu_torch.parallel.sharded import (ROW_ALIGN,
                                                    SHARDED_DIX_FIELDS)

    eng = port_full["eng"]
    n_idx = eng.mesh.shape["idx"]
    tables = dict((f, getattr(eng.dix, f)) for f in SHARDED_DIX_FIELDS)
    tables["ref_words"] = eng.ref_words
    ptrs = set()
    for d, (_, t, ixr, words) in enumerate(eng._rows):
        for name, whole in tables.items():
            a = words if name == "ref_words" else getattr(t, name)
            shards = a.shards
            assert len(shards) == n_idx
            n = whole.numel()
            padded = -(-n // (n_idx * ROW_ALIGN)) * n_idx * ROW_ALIGN
            for s in shards:
                assert s.numel() < padded, name
                assert s.numel() < n or n <= n_idx * ROW_ALIGN, name
                assert s.untyped_storage().data_ptr() != \
                    whole.untyped_storage().data_ptr()
                ptrs.add(s.data_ptr())
            flat = torch.cat(shards)
            assert torch.equal(flat[:n], whole.reshape(-1)), name
            assert not flat[n:].any(), name
        assert torch.is_tensor(t.rank) and torch.is_tensor(t.q_lv)
    # one shard a table and idx position, each its own allocation (the
    # two dp rows repeat the CPU, so they share them)
    assert len(ptrs) == len(tables) * n_idx


def test_shard_full_layouts_it_does_not_take_raise(small_my_index,
                                                   monkeypatch):
    from desamba_tpu_torch.parallel import MeshClassifier, make_mesh, mesh

    idx = port_index(small_my_index)
    with pytest.raises(ValueError, match="at most 8"):
        MeshClassifier(idx, None, shard_full=True,
                       mesh=make_mesh(1, 9, devices=["cpu"] * 9))
    # shards on a card that the kernels' card cannot reach: no copy, no
    # fallback, an error
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    with pytest.raises(RuntimeError, match="no peer access"):
        mesh.require_peer_access(torch.device("cuda", 0),
                                 [torch.device("cuda", 0),
                                  torch.device("cuda", 1)])
    mesh.require_peer_access(torch.device("cuda", 0),
                             [torch.device("cuda", 0)] * 3)


# ---- (d) the accessor through the host build of the kernel sources ----------

def _build(tmp_path_factory, name):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernels with")
    so = str(tmp_path_factory.mktemp(name) / f"{name}.so")
    host = os.path.join(HERE, "cuda_host")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", host,
                    "-I", KERNELS, os.path.join(host, f"{name}.cpp"),
                    "-o", so], check=True, capture_output=True)
    return ctypes.CDLL(so)


@pytest.fixture(scope="module")
def emus(tmp_path_factory):
    """kernels/shard.cuh, ladder.cu and rescore.cu as host C++."""
    libs = {n: _build(tmp_path_factory, n)
            for n in ("shard_emu", "ladder_emu", "rescore_emu")}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, sig in (("shard_ld_take", [P, P, I, I, P]),
                      ("flat_ld_take", [P, P, I, I, P]),
                      ("shard_row_take", [P, P, I, I, I, P]),
                      ("flat_row_take", [P, P, I, I, I, P])):
        getattr(libs["shard_emu"], name).argtypes = sig
        getattr(libs["shard_emu"], name).restype = None
    for name in ("ladder_emulate", "ladder_slow_emulate",
                 "ladder_sharded_emulate", "ladder_slow_sharded_emulate"):
        fn = getattr(libs["ladder_emu"], name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    libs["ladder_emu"].ladder_emu_error.restype = ctypes.c_char_p
    sig = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
    for name in ("rescore_emulate", "rescore_sharded_emulate"):
        getattr(libs["rescore_emu"], name).argtypes = sig
    libs["rescore_emu"].rescore_emu_error.restype = ctypes.c_char_p
    return libs


@pytest.mark.parametrize("n_idx", [1, 2, 4])
def test_accessor_equals_sharded_array_and_take(emus, n_idx):
    from desamba_tpu_torch.engine.device.intops import take
    from desamba_tpu_torch.parallel import make_mesh
    from desamba_tpu_torch.parallel.sharded import (ShardedArray,
                                                    shard_tab, shard_table)

    lib = emus["shard_emu"]
    rng = np.random.default_rng(5)
    mesh = make_mesh(1, n_idx, devices=["cpu"] * n_idx)
    for n, w in ((9223, 1), (9223 * 9, 9)):
        glob = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, size=n)
                                .astype(np.int32))
        shards, gshape = shard_table(mesh, glob)
        a = ShardedArray(shards[0], gshape, "cpu")
        tab = shard_tab(a)
        rows = n // w
        span = a.shard_len // w
        edges = [e for k in range(1, n_idx) for e in
                 (k * span - 1, k * span, k * span + 1)]
        idx = np.concatenate([rng.integers(0, rows, size=61), edges,
                              [-3, -1, 0, rows - 1, rows, rows + 5]]).astype(
                                  np.int32)
        got = np.zeros(len(idx) * w, np.int32)
        flat = np.zeros(len(idx) * w, np.int32)
        ip = idx.ctypes.data
        if w == 1:
            lib.shard_ld_take(ctypes.byref(tab), ip, len(idx), n,
                              got.ctypes.data)
            lib.flat_ld_take(glob.data_ptr(), ip, len(idx), n,
                             flat.ctypes.data)
            exp = a[torch.from_numpy(idx)]
            exp_flat = take(glob, torch.from_numpy(idx))
        else:
            lib.shard_row_take(ctypes.byref(tab), ip, len(idx), rows, w,
                               got.ctypes.data)
            lib.flat_row_take(glob.data_ptr(), ip, len(idx), rows, w,
                              flat.ctypes.data)
            exp = a.as_rows(w)[torch.from_numpy(idx)]
            exp_flat = take(glob.view(rows, w), torch.from_numpy(idx))
        assert np.array_equal(got, exp.numpy().reshape(-1))
        assert np.array_equal(flat, exp_flat.numpy().reshape(-1))


def _flat_args(eng, a):
    """A ladder call's arguments with the base classifier's whole tables
    in place of dp row 0's shards."""
    ixr, _, rank, _, *rest = a
    return (eng.ixr, eng.dix.fm_blocks, rank, eng.dix.hash13, *rest)


@pytest.mark.parametrize("kind", ["fast", "slow"])
def test_ladder_kernels_flat_equals_sharded(emus, port_full, kind):
    """The captured call's B2 (B3) through the host build, over whole tables
    and over the shards, in both thread orders == the eager plain version
    on the shards (packed anchors, info rows, pack overflow)."""
    from desamba_tpu_torch.engine.device import ladder

    lib = emus["ladder_emu"]
    assert lib.ladder_sharded_args_size() == ctypes.sizeof(
        ladder.ShardedLadderArgs)
    a, kw = port_full["calls"][kind]
    plain = (ladder.fast_ladder if kind == "fast" else ladder.slow_ladder)
    exp = plain(*a, **kw)
    launch_kw = {k: v for k, v in kw.items() if k != "pack_cap"}
    run = {"fast": (lib.ladder_emulate, lib.ladder_sharded_emulate),
           "slow": (lib.ladder_slow_emulate, lib.ladder_slow_sharded_emulate)}
    for sharded, args in ((False, _flat_args(port_full["eng"], a)),
                          (True, a)):
        for reverse in (False, True):
            largs, t = ladder.ladder_launch_args(*args, **launch_kw)
            assert isinstance(largs, ladder.ShardedLadderArgs) == sharded
            rc = run[kind][sharded](ctypes.addressof(largs), int(reverse))
            assert rc == 0, lib.ladder_emu_error().decode()
            got = ladder.ladder_outputs(t, kw["pack_cap"])
            what = f"{kind} sharded={sharded} reverse={reverse}"
            assert torch.equal(got[0], exp[0]), what
            assert torch.equal(got[1], exp[1]), what
            assert got[2] == exp[2], what
    assert int(exp[1][:, 1].sum()) > 0          # the call emits anchors


def test_rescore_kernel_flat_equals_sharded(emus, port_full):
    """The captured main-batch rescore through the host build of K1, over
    the whole reference words and over their shards == the plain version
    on the shards (chains and the three flag columns)."""
    from desamba_tpu_torch.engine.device import rescore_pl as trp
    from desamba_tpu_torch.parallel.sharded import shard_tab

    lib = emus["rescore_emu"]
    (inp, words, ref_off, ref_len, n_bases), _ = \
        port_full["calls"]["rescore"]
    exp_ch, exp_fl = trp.rescore_plain(
        trp.prepare(inp, words, ref_off, ref_len, n_bases))
    assert int((exp_fl[:, 2] > 0).sum()) > 0      # rows that walked
    for sharded in (False, True):
        w = words if sharded else port_full["eng"].ref_words
        prep = trp.prepare(inp, w, ref_off, ref_len, n_bases)
        host = {k: (v.numpy() if torch.is_tensor(v) else v)
                for k, v in prep.items()}
        B, A2, _ = host["anchors"].shape
        chains = np.full((B, 8, 10), -7, np.int32)
        flags = np.full((B, 3), -7, np.int32)
        arrs = {k: np.ascontiguousarray(host[k], dtype=np.int32) for k in (
            "scal", "chains", "anchors", "schash", "codes_pk", "rk_vals",
            "rk_pos", "ref_off", "ref_len")}
        ptrs = [a.ctypes.data for a in arrs.values()]
        tab = shard_tab(w) if sharded else None
        wp = ctypes.addressof(tab) if sharded else w.data_ptr()
        entry = (lib.rescore_sharded_emulate if sharded
                 else lib.rescore_emulate)
        rc = entry(*ptrs[:7], wp, *ptrs[7:],
                   chains.ctypes.data, flags.ctypes.data, B, A2,
                   host["codes_pk"].shape[1], host["rk_vals"].shape[2],
                   w.shape[0] // 128, host["ref_off"].shape[0],
                   host["n_bases"], host["last_char"], 0)
        assert rc == 0, lib.rescore_emu_error().decode()
        assert np.array_equal(chains, exp_ch.numpy()), f"sharded={sharded}"
        assert np.array_equal(flags, exp_fl.numpy()), f"sharded={sharded}"


# ---- (e) the entry -----------------------------------------------------------

def test_dryrun_multichip_second_phase(capsys):
    from desamba_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(8, device="cpu")
    assert out["shard_full_reads"] == min(24, out["reads"])
    assert out["wall_ratio"] > 0
    assert "dryrun_multichip shard_full ok" in capsys.readouterr().out
