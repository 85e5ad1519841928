"""The fast-ladder CUDA kernel's own source (kernels/ladder.cu over
kernels/ladder.cuh, a warp per lane), compiled as host C++ over
tests/cuda_host/warp_emu.h and run on the CPU, == the JAX ``fast_ladder`` and the port's eager
``fast_ladder`` (its plain version), bit for bit (tolerance 0): packed
anchors, the (N, 4) info rows and the pack overflow.

The lane sets are every fast-ladder call of ``test_torch_ladder``'s
``captured`` fixture (noisy reads on the small genome, the repeat corpus)
and of reads from a family of six strains 1-3 % apart (13-mer buckets of
several rows that extend far, where the position-space interval phase
ranks them) and of the edge corpus (``_edge_corpus``: a unitig of 130
occurrences, 13-mer buckets of SA_CAP rows with tied LCEs, a repeat family
whose slow lanes fill SP_SETs past the hot tier), at the captured SP_SET
tier, at the full tier (``iv_cap=None``, 512), at ``iv_cap`` 1 and 2
(hot-tier overflows) and on a lane set whose first probes overflow the
eager port's shared SA pool, so that it sends lanes to the rank chase that
the kernel (a warp per lane, its own SA_CAP-row scratch) resolves in
position space. Each case runs each warp's threads in order and in reverse
between collectives."""
import collections
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_repeat_paths import (  # noqa: E402,F401
    repeat_genome,
    repeat_my_index,
    repeat_reads,
)
from test_torch_ladder import (  # noqa: E402,F401
    _Rec,
    _capture,
    _jax_ladder,
    _port_ladder,
    captured,
)
from test_torch_stages import T, assert_same  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "desamba_tpu_torch", "kernels")


@pytest.fixture(scope="module")
def ladder_emu(tmp_path_factory):
    """kernels/ladder.cu compiled as host C++ over warp_emu.h, loaded with
    ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernel with")
    so = str(tmp_path_factory.mktemp("ladder_emu") / "ladder_emu.so")
    host = os.path.join(HERE, "cuda_host")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", host,
                    "-I", KERNELS, os.path.join(host, "ladder_emu.cpp"),
                    "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for entry in (lib.ladder_emulate, lib.ladder_slow_emulate):
        entry.argtypes = [ctypes.c_void_p, ctypes.c_int]
        entry.restype = ctypes.c_int
    lib.ladder_emu_error.restype = ctypes.c_char_p
    lib.ladder_args_size.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def corpora(captured, tmp_path_factory):
    """``captured`` plus the fast-ladder calls of 12 reads (5 % substitutions)
    from a family of six strains of a 12-kb ancestor, 1-3 % apart."""
    from desamba_tpu.engine.device.arrays import DeviceIndex
    from desamba_tpu.index.build import build_index

    rng = np.random.default_rng(41)
    anc = rng.integers(0, 4, 12000)
    strains = []
    for _ in range(6):
        x = anc.copy()
        m = rng.random(len(x)) < rng.uniform(0.01, 0.03)
        x[m] = (x[m] + rng.integers(1, 4, int(m.sum()))) % 4
        for at in range(700, len(x) - 10, 1500):   # N patches fragment it
            x[at : at + 3] = 4
        strains.append(x)
    fa = tmp_path_factory.mktemp("strains") / "strains.fa"
    with open(fa, "w") as f:
        for i, x in enumerate(strains):
            f.write(f">tid|{500 + i}|ref|STRAIN_{i}\n"
                    + "".join("ACGTN"[c] for c in x) + "\n")
    idx = build_index(str(fa))
    recs = []
    for i in range(12):
        x = strains[rng.integers(len(strains))]
        ln = int(rng.integers(400, 1500))
        st = int(rng.integers(0, len(x) - ln))
        r = x[st : st + ln].copy()
        r[r == 4] = 0
        m = rng.random(ln) < 0.05
        r[m] = (r[m] + 1) % 4
        recs.append(_Rec(f"s{i}", "".join("ACGT"[c] for c in r)))
    tix, calls = _capture(idx, recs)
    return captured + [(idx, DeviceIndex.build(idx), tix, calls)]


def _edge_corpus(rng):
    """Four references and 11 reads (name, sequence) for the kernels' edges:
    a 150-base unit 130 times (one unitig of 130 occurrences: a map_seed
    fans out over it in five rounds of 32 and passes a_cap; three reads
    around copies, 2 % errors), four 24-base segments 16 times each
    between unique 30-base flanks (13-mer buckets of about SA_CAP rows whose
    LCEs tie; four reads of six segments in random sequence) and a family
    of 120 copies of a 300-base unit, 4 % apart (four reads around copies,
    12 % errors, whose slow lanes walk SP_SETs past the hot tier)."""
    def rnd(n):
        return "".join("ACGT"[c] for c in rng.integers(0, 4, n))

    def mutate(s, rate):
        a = np.array(list(s))
        m = rng.random(len(a)) < rate
        a[m] = [rnd(1) for _ in range(int(m.sum()))]
        return "".join(a)

    unit, segs, fam = rnd(150), [rnd(24) for _ in range(4)], rnd(300)
    fam = [mutate(fam, 0.04) for _ in range(120)]
    pieces = [[] for _ in range(4)]
    for i in range(130):
        pieces[i % 4].append(unit)
    for g in segs:
        for i in range(16):
            pieces[i % 4].append(rnd(30) + g + rnd(30))
    for i, x in enumerate(fam):
        pieces[i % 4].append(x)
    refs = []
    for items in pieces:
        rng.shuffle(items)
        s = list(rnd(2000) + "".join(x + rnd(int(rng.integers(100, 200)))
                                     for x in items))
        for at in range(1000, len(s) - 10, 1100):   # N patches fragment it
            s[at : at + 3] = "NNN"
        refs.append("".join(s))

    def around(x, ln, rate):
        r = next(r for r in refs if x in r)
        st = max(0, r.find(x) - int(rng.integers(50, 200)))
        return mutate(r[st : st + ln].replace("N", "A"), rate)

    reads = [(f"u{i}", around(unit, 500, 0.02)) for i in range(3)]
    reads += [(f"g{i}", "".join(rnd(int(rng.integers(15, 40))) + g
                                for _ in range(6)))
              for i, g in enumerate(segs)]
    whole = [x for x in fam if any(x in r for r in refs)]   # no N patch
    reads += [(f"d{i}", around(whole[int(rng.integers(len(whole)))], 600,
                               0.12)) for i in range(4)]
    return refs, reads


def _tied_buckets(ixr, hash13, codes_pk, str_idx, pre_v, active, col_off,
                  rows):
    """Of the active lanes' probes: those whose 13-mer bucket holds SA_CAP
    rows, and of those the ones where two rows' LCEs (the values
    interval_sa ranks) are equal."""
    from desamba_tpu_torch.engine.device.fm import SA_CAP
    from desamba_tpu_torch.engine.device.intops import i32, take, u32
    from desamba_tpu_torch.engine.device.textwalk import lce_backward

    sp0 = u32(take(hash13, pre_v))
    n0 = i32(u32(take(hash13, pre_v + 1)) - sp0)
    sel = (active & (n0 == SA_CAP)).nonzero().squeeze(1)
    if sel.numel() == 0:
        return 0, 0
    rix = sp0[sel][:, None] + torch.arange(SA_CAP)[None, :]
    p = ixr.row_pos[rix.clamp(0, ixr.isa.shape[0] - 1).long()].reshape(-1)

    def rep(x):
        return x[sel, None].expand(-1, SA_CAP).reshape(-1)

    lce = lce_backward(ixr.text_pk, ixr.sep_any, codes_pk, rep(rows),
                       rep(col_off), rep(str_idx - 13), p - 1,
                       rep((str_idx - 12).clamp(min=0)),
                       torch.ones_like(p, dtype=torch.bool))
    tied = sum(len(set(r)) < SA_CAP for r in lce.reshape(-1, SA_CAP).tolist())
    return sel.numel(), tied


@pytest.fixture(scope="module")
def edges(tmp_path_factory):
    """The ladder calls of ``_edge_corpus``'s reads, (idx, jd, tix, calls,
    seen), with what the eager port met while it made them: ``seen`` maps
    (kind, what) to the largest fan-out of one map_seed ("fan"), the most
    SP_SET intervals of a lane ("niv"), the probes with an SA_CAP-row
    bucket ("full") and those of them with tied LCEs ("tied")."""
    from desamba_tpu.engine.device.arrays import DeviceIndex
    from desamba_tpu.index.build import build_index
    from desamba_tpu_torch.engine.device import fm as dev_fm
    from desamba_tpu_torch.engine.device import ladder

    refs, reads = _edge_corpus(np.random.default_rng(8))
    fa = tmp_path_factory.mktemp("edges") / "edges.fa"
    with open(fa, "w") as f:
        for i, s in enumerate(refs):
            f.write(f">tid|{700 + i}|ref|EDGE_{i}\n{s}\n")
    idx = build_index(str(fa))
    seen = collections.Counter()
    orig_map, orig_probe = ladder.map_seed_lanes, dev_fm.mem_probe

    def map_spy(*a, **kw):
        before = a[-1].clone()                    # the lanes' anchor counts
        out = orig_map(*a, **kw)
        kind = "fast" if "rows" in kw else "slow"
        seen[kind, "fan"] = max(seen[kind, "fan"],
                                int((out[1] - before).max()))
        return out

    def probe_spy(ixr, fm_blocks, rank6, hash13, codes, codes_pk, str_idx,
                  pre_v, active, spset, spcount, max_rst, *a, **kw):
        kind = "fast" if max_rst == 2 else "slow"       # MEM_SEARCH_FAST
        n, tied = _tied_buckets(ixr, hash13, codes_pk, str_idx, pre_v,
                                active, kw["col_off"], kw["row_idx"])
        seen[kind, "full"] += n
        seen[kind, "tied"] += tied
        out = orig_probe(ixr, fm_blocks, rank6, hash13, codes, codes_pk,
                         str_idx, pre_v, active, spset, spcount, max_rst,
                         *a, **kw)
        seen[kind, "niv"] = max(seen[kind, "niv"], int(out[7][:, 0].max()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ladder, "map_seed_lanes", map_spy)
        mp.setattr(dev_fm, "mem_probe", probe_spy)
        tix, calls = _capture(idx, [_Rec(n, s) for n, s in reads])
    return idx, DeviceIndex.build(idx), tix, calls, seen


def _emulate(lib, idx, tix, c, iv_cap, reverse, kind="fast", m_cap=0):
    """The ``kind`` ladder's kernel on call ``c`` at ``iv_cap`` (and, slow,
    ``m_cap``): (packed, info, overflow) and the lanes' trips."""
    from desamba_tpu_torch.engine.device.classifier import A_CAP
    from desamba_tpu_torch.engine.device.ladder import (LadderArgs,
                                                        ladder_launch_args,
                                                        ladder_outputs)

    assert lib.ladder_args_size() == ctypes.sizeof(LadderArgs)
    args, t = ladder_launch_args(
        tix.index_refs(), tix.fm_blocks, tix.rank, tix.hash13,
        T(c["codes_fr"]), T(c["buf_len"]), T(c["pre13"]), tix.q_mem,
        tix.q_lv, T(c["lane_args"]), l_ek=idx.len_e_kmer, a_cap=A_CAP,
        iv_cap=iv_cap, m_cap=m_cap)
    run = lib.ladder_emulate if kind == "fast" else lib.ladder_slow_emulate
    rc = run(ctypes.addressof(args), int(reverse))
    assert rc == 0, lib.ladder_emu_error().decode()
    return ladder_outputs(t, 2 * c["NB"]), t["trips"]


def _check(lib, idx, jd, tix, c, iv_cap):
    """Kernel (both orders) == JAX == eager port on call ``c``, and the
    longest lane's trips == the eager loop's trip count; returns the JAX
    info rows."""
    from desamba_tpu_torch.engine.device.ladder import fast_ladder

    e_packed, e_info, e_ovf = _jax_ladder(idx, jd, c, iv_cap)
    p_packed, p_info, p_ovf = _port_ladder(idx, tix, c, iv_cap)
    p_trips = fast_ladder.trips
    assert_same(e_info, p_info, "eager port info")
    assert_same(e_packed, p_packed, "eager port packed")
    for reverse in (False, True):
        (packed, info, ovf), trips = _emulate(lib, idx, tix, c, iv_cap,
                                              reverse)
        what = f"iv_cap={iv_cap} reverse={reverse}"
        assert_same(e_info, info, f"kernel info, {what}")
        assert_same(e_packed, packed, f"kernel packed anchors, {what}")
        assert bool(e_ovf) == ovf == bool(p_ovf), f"pack overflow, {what}"
        assert int(trips.max()) == p_trips, f"longest lane's trips, {what}"
    return np.asarray(e_info)


def _fast_calls(sets):
    for idx, jd, tix, calls in sets:
        for c in calls:
            if c["kind"] == "fast":
                yield idx, jd, tix, c


def corpus_sets(corpora, corpus, request):
    """The (idx, jd, tix, calls) sets of a named corpus: the fixtures' two,
    the strains, or the edge corpus (built only when asked for)."""
    if corpus == "edges":
        return [request.getfixturevalue("edges")[:4]]
    return corpora[:2] if corpus == "fixtures" else corpora[2:]


@pytest.mark.parametrize("corpus", ["fixtures", "strains", "edges"])
@pytest.mark.parametrize("tier", ["captured", "full"])
def test_kernel_source_matches_jax_and_plain(corpora, ladder_emu, tier,
                                             corpus, request):
    """Every captured fast-ladder call, at its own SP_SET tier (the hot 32,
    or None where the classifier re-dispatched) and at the full 512:
    tolerance 0 on packed anchors, info rows and pack overflow; the longest
    lane's trips equal the eager loop's trip count. On the edge corpus one
    map_seed fans out over more than a_cap occurrences (four rounds of 32
    and more), a lane's anchor count passes a_cap, and probes rank
    SA_CAP-row buckets whose LCEs tie."""
    from desamba_tpu_torch.engine.device.classifier import A_CAP

    n = most = 0
    for idx, jd, tix, c in _fast_calls(corpus_sets(corpora, corpus,
                                                   request)):
        info = _check(ladder_emu, idx, jd, tix, c,
                      c["iv_cap"] if tier == "captured" else None)
        n += int(info[:, 1].sum() > 0)
        most = max(most, int(info[:, 1].max()))
    assert n >= 1 + (corpus == "fixtures"), "too few calls with anchors"
    if corpus == "edges":
        seen = request.getfixturevalue("edges")[4]
        assert seen["fast", "fan"] > A_CAP, "no map_seed fanned out past a_cap"
        assert most > A_CAP, "no lane's anchor count passed a_cap"
        assert seen["fast", "tied"] > 0, "no SA_CAP-row bucket with tied LCEs"


@pytest.mark.parametrize("iv_cap", [1, 2])
def test_kernel_source_forced_iv_overflow(corpora, ladder_emu, iv_cap):
    """A hot tier of one or two intervals overflows (the last slot
    overwritten, the sticky bit set), and the kernel agrees with both on
    that and on every anchor (the repeat corpus and the strains)."""
    n_ovf = 0
    for idx, jd, tix, c in _fast_calls(corpora[1:]):
        info = _check(ladder_emu, idx, jd, tix, c, iv_cap)
        n_ovf += int(info[:, 3].sum())
    assert n_ovf > 0, f"iv_cap={iv_cap} never overflowed"


def _pool_lanes(tix, c, l_ek, copies=4, lowest=None):
    """Lanes of call ``c`` that each start at a probe whose 13-mer bucket
    holds 3..SA_CAP rows (the lane's island cut to end there; a probe at
    ``lowest``, by default the fast ladder's last, or above), ``copies`` of
    each in a row: on the first trip their rows, at least 3 a lane,
    overflow the eager probe's shared SA pool of 2 rows a lane. Returns the
    call with those lanes and their count."""
    from desamba_tpu_torch.constants import MIN_MEM_LEN_FAST, PRE_IDX_MASK
    from desamba_tpu_torch.engine.device.classifier import _bucket
    from desamba_tpu_torch.engine.device.fm import SA_CAP

    if lowest is None:
        lowest = MIN_MEM_LEN_FAST - l_ek
    la, pre13 = c["lane_args"], c["pre13"]
    h = tix.hash13.numpy().view(np.uint32).astype(np.int64)
    lanes = []
    for i in np.flatnonzero(la[7] != 0):
        ridx, base, soff, slen = la[0, i], la[1, i], la[5, i], la[6, i]
        for j in range(slen - 1, lowest - 1, -1):
            pre = int(pre13[ridx, np.clip(base + soff + j, 0,
                                          pre13.shape[1] - 1)]) & PRE_IDX_MASK
            if 3 <= h[pre + 1] - h[pre] <= SA_CAP:
                lane = la[:, i].copy()
                lane[6] = j + 1
                lanes += [lane] * copies
    NB = _bucket(len(lanes))
    cols = np.zeros((8, NB), np.int32)
    if lanes:
        cols[:, : len(lanes)] = np.stack(lanes, axis=1)
    return dict(c, lane_args=cols, NB=NB), len(lanes)


def count_pool_routing(monkeypatch):
    """Spy on the eager ``fm.mem_probe``: the returned list's one item
    counts the lane-probes that its shared SA pool sent to the rank
    chase."""
    from desamba_tpu_torch.engine.device import fm as dev_fm
    from desamba_tpu_torch.engine.device.intops import i32, take, u32

    routed = [0]
    orig = dev_fm.mem_probe

    def counting(ixr, fm_blocks, rank6, hash13, codes, codes_pk, str_idx,
                 pre_v, active, *a, **kw):
        n0 = i32(u32(take(hash13, pre_v + 1)) - u32(take(hash13, pre_v)))
        sa_act = active & (n0 <= dev_fm.SA_CAP)
        n_eff = torch.where(sa_act, n0.clamp(max=dev_fm.SA_CAP), 0)
        fit = torch.cumsum(n_eff, dim=0) <= 2 * str_idx.shape[0]
        routed[0] += int((sa_act & ~fit).sum())
        return orig(ixr, fm_blocks, rank6, hash13, codes, codes_pk, str_idx,
                    pre_v, active, *a, **kw)

    monkeypatch.setattr(dev_fm, "mem_probe", counting)
    return routed


def test_kernel_source_sa_pool_overflow(corpora, ladder_emu, monkeypatch):
    """A lane set whose bucket rows overflow the eager probe's shared SA
    pool: the eager port sends lanes to the rank chase through the pool
    (counted, > 0); the kernel takes the position-space path for every
    bucket of at most SA_CAP rows. Both paths give the same rows in the same
    order: kernel == eager port == JAX, tolerance 0."""
    routed = count_pool_routing(monkeypatch)
    lanes = 0
    for idx, jd, tix, c in _fast_calls(corpora):
        cut, n = _pool_lanes(tix, c, idx.len_e_kmer)
        if n:
            _check(ladder_emu, idx, jd, tix, cut, c["iv_cap"])
            lanes += n
    assert lanes > 0, "no probe with several bucket rows"
    assert routed[0] > 0, "the shared SA pool never sent a lane to the chase"
