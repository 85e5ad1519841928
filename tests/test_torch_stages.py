"""Port device stages == their JAX counterparts, bit for bit (tolerance 0).

Mirrors tests/test_device_engine.py (bloom, lv, map_seed, mem_probe) and
tests/test_device_chain.py (chain_kernel, m3_kernel): the same seeded
numpy inputs go through the JAX function and the port's, and every output
array must be equal."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from desamba_tpu.constants import (  # noqa: E402
    FORWARD,
    MEM_SEARCH_FAST,
    MIN_MEM_LEN_FAST,
    PRE_IDX_MASK,
)


def T(x):
    """numpy / jax array -> torch CPU tensor (uint32 as int32 bits)."""
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def assert_same(j, t, what=""):
    a = np.asarray(j)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    b = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype.kind == b.dtype.kind or {a.dtype.kind, b.dtype.kind} <= {
        "i", "u"}, (what, a.dtype, b.dtype)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), what


@pytest.fixture(scope="module")
def setup(small_my_index):
    from desamba_tpu.engine.device.arrays import DeviceIndex as JDix
    from desamba_tpu_torch.engine.device.arrays import DeviceIndex as TDix

    jd = JDix.build(small_my_index)
    return small_my_index, jd, TDix.build(small_my_index, "cpu")


def _random_reads(idx, n, rng, lo=200, hi=1200):
    from desamba_tpu.engine.gold.mapseed import get_ref

    reads = []
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        st = int(rng.integers(0, total - ln))
        seq = get_ref(idx.ref_bin, st, ln, True).copy()
        nerr = int(ln * 0.1)
        pos = rng.integers(0, ln, size=nerr)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=nerr)) % 4
        reads.append(seq.astype(np.uint8))
    return reads


def _codes(reads):
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
    return codes, np.array([len(r) for r in reads], np.int32)


def case_bloom_pre13(setup):
    from desamba_tpu.engine.device.islands import bloom_hit_kernel as jb
    from desamba_tpu.engine.device.pipeline import pre13_values as jp
    from desamba_tpu_torch.engine.device.islands import bloom_hit_kernel as tb
    from desamba_tpu_torch.engine.device.pipeline import pre13_values as tp

    idx, jd, td = setup
    codes, lens = _codes(_random_reads(idx, 16, np.random.default_rng(3)))
    # a poly-A read and a read shorter than its padding row
    codes[0, :300] = 0
    lens[1] = 60
    args = (idx.len_e_kmer, idx.single_base_max, jd.mask_bits)
    exp = jb(jnp.asarray(codes), jnp.asarray(lens), jd.ekmer0, jd.ekmer1,
             *args)
    got = tb(T(codes), T(lens), td.ekmer0, td.ekmer1, *args)
    assert np.asarray(exp).sum() > 100
    assert_same(exp, got, "bloom hits")
    assert_same(jp(jnp.asarray(codes), idx.len_e_kmer),
                tp(T(codes), idx.len_e_kmer), "pre13")


def case_lv(setup):
    from desamba_tpu.engine.device.lv import lv_batch as jl
    from desamba_tpu_torch.engine.device.lv import lv_batch as tl

    rng = np.random.default_rng(0)
    N = 800
    lens = rng.integers(0, 13, size=N).astype(np.int32)
    ref = rng.integers(0, 4, size=(N, 13)).astype(np.uint8)
    qry = np.where(rng.random((N, 13)) < 0.7, ref,
                   rng.integers(0, 4, size=(N, 13))).astype(np.uint8)
    qry[rng.random((N, 13)) < 0.05] = 200
    ref[rng.random((N, 13)) < 0.02] = 200
    assert_same(jax.jit(jl)(jnp.asarray(ref), jnp.asarray(qry),
                            jnp.asarray(lens)),
                tl(T(ref), T(qry), T(lens)), "lv")


def case_map_seed(setup):
    """Replay every gold map_seed call from classifying noisy reads through
    both map_seed_lanes."""
    import desamba_tpu.engine.gold.fastslow as FS
    import desamba_tpu.engine.gold.mapseed as MS
    import desamba_tpu.io.native as nv
    from desamba_tpu.engine.device.mapseed import map_seed_lanes as jm
    from desamba_tpu.engine.device.textwalk import pack2 as jpack
    from desamba_tpu.engine.gold.classify import ClassifyEngine
    from desamba_tpu.engine.gold.fm import MAX_U64
    from desamba_tpu_torch.engine.device.mapseed import A_NF
    from desamba_tpu_torch.engine.device.mapseed import map_seed_lanes as tm
    from desamba_tpu_torch.engine.device.textwalk import pack2 as tpack

    idx, jd, td = setup
    eng = ClassifyEngine(idx)
    reads = _random_reads(idx, 12, np.random.default_rng(9))
    calls, bufs, rid = [], [], [0]
    orig = MS.map_seed

    def wrap(idx_, fm, loc, q_mem, q_lv, m_r, buf, base, read_len, seed_id,
             direction, anchors, smc):
        calls.append(dict(rid=rid[0], sp=m_r.sp, ml=m_r.match_len,
                          sa=m_r.sa_sp, sal=m_r.sa_sp_l,
                          qoff=m_r.read_offset, base=base, rl=read_len,
                          sid=seed_id, dir=direction))
        return orig(idx_, fm, loc, q_mem, q_lv, m_r, buf, base, read_len,
                    seed_id, direction, anchors, smc)

    MS.map_seed = FS.map_seed = wrap
    real = nv.available
    nv.available = lambda: False
    try:
        for r in reads:
            eng.classify_read("x", "".join("ACGT"[c] for c in r), None)
            bufs.append(np.concatenate([r, (3 - r)[::-1]]))
            rid[0] += 1
    finally:
        MS.map_seed = FS.map_seed = orig
        nv.available = real
    assert len(calls) > 50
    codes_fr, buf_len = _codes(bufs)
    N, A_CAP = len(calls), 64

    def arr(k):
        return np.array([c[k] for c in calls], np.int32)

    sa_ok = np.array([c["sa"] != MAX_U64 for c in calls])
    sa_row = np.array([c["sa"] & 0xFFFFFFFF if c["sa"] != MAX_U64 else 0
                       for c in calls], np.int64).astype(np.int32)
    names = ("rid", "base", "rl", "dir", "sid", "sp", "ml")
    lane = [arr(k) for k in names]
    exp = jax.jit(jm, static_argnames=("a_cap", "occ_cap"))(
        jd.index_refs(), jpack(jnp.asarray(codes_fr)), jnp.asarray(buf_len),
        jd.q_mem, jd.q_lv, *[jnp.asarray(x) for x in lane],
        jnp.asarray(sa_ok), jnp.asarray(sa_row), jnp.asarray(arr("sal")),
        jnp.asarray(arr("qoff")), jnp.ones((N,), bool),
        jnp.zeros((N, A_CAP, A_NF), jnp.int32), jnp.zeros((N,), jnp.int32),
        a_cap=A_CAP)
    got = tm(td.index_refs(), tpack(T(codes_fr)), T(buf_len), td.q_mem,
             td.q_lv, *[T(x) for x in lane], T(sa_ok), T(sa_row),
             T(arr("sal")), T(arr("qoff")), torch.ones((N,), dtype=bool),
             torch.zeros((N, A_CAP, A_NF), dtype=torch.int32),
             torch.zeros((N,), dtype=torch.int32), a_cap=A_CAP)
    for what, e, g in zip(("anchors", "a_cnt", "max_s"), exp, got):
        assert_same(e, g, what)
    assert int(np.asarray(exp[1]).sum()) > 20


def _mem_probe(setup, sa_cap):
    from desamba_tpu.engine.device.fm import mem_probe as jmp
    from desamba_tpu.engine.device.fm import spset_init as jinit
    from desamba_tpu.engine.device.textwalk import pack2 as jpack
    from desamba_tpu.engine.gold.islands import (exist_mask, search_islands,
                                                 store_kmers_mask)
    from desamba_tpu_torch.engine.device.fm import mem_probe as tmp
    from desamba_tpu_torch.engine.device.textwalk import pack2 as tpack

    idx, jd, td = setup
    l_ek = idx.len_e_kmer
    lanes = []
    for r in _random_reads(idx, 5, np.random.default_rng(5)):
        km = store_kmers_mask(r, len(r) - l_ek + 1, l_ek,
                              idx.single_base_max)
        hit = exist_mask(km, idx.ekmer0, idx.ekmer1, idx.e_hash_mask)
        lanes += [(r, km, s) for s in search_islands(hit, FORWARD)]
    N = len(lanes)
    codes, _ = _codes([r for r, _, _ in lanes])
    jcodes, tcodes = jnp.asarray(codes), T(codes)
    jpk, tpk = jpack(jcodes), tpack(tcodes)
    jst = jinit(N)
    min_index = MIN_MEM_LEN_FAST - l_ek
    j_state = np.array([s[1] - 1 for _, _, s in lanes])
    kw = {} if sa_cap is None else {"sa_cap": sa_cap}
    nprobes = 0
    for _ in range(6):
        act_i = np.flatnonzero(j_state >= min_index)
        if len(act_i) == 0:
            break
        str_idx = np.zeros(N, np.int32)
        pre_v = np.zeros(N, np.int32)
        act = np.zeros(N, bool)
        for i in act_i:
            _, km, s = lanes[i]
            ki = s[0] + j_state[i]
            pre_v[i] = int(km[ki]) & PRE_IDX_MASK
            str_idx[i] = ki + l_ek - 1
            act[i] = True
        exp = jmp(jd.index_refs(), jd.fm_blocks, jd.rank, jd.hash13, jcodes,
                  jpk, jnp.asarray(str_idx), jnp.asarray(pre_v),
                  jnp.asarray(act), jst[0], jst[1], MEM_SEARCH_FAST,
                  MIN_MEM_LEN_FAST - 1, **kw)
        got = tmp(td.index_refs(), td.fm_blocks, td.rank, td.hash13, tcodes,
                  tpk, T(str_idx), T(pre_v), T(act), T(jst[0]), T(jst[1]),
                  MEM_SEARCH_FAST, MIN_MEM_LEN_FAST - 1, **kw)
        names = ("res_len", "res_sp", "res_sa", "res_sa_ok", "res_sa_l",
                 "res_valid", "spset", "spcount")
        for what, e, g in zip(names, exp, got):
            assert_same(e, g, what)
        jst = exp[6], exp[7]
        valid = np.asarray(exp[5])
        nprobes += len(act_i)
        for i in act_i:
            j_state[i] -= 3 if valid[i].any() else 2
    assert nprobes > 30


def _chain_inputs(rng, B, A2, rows_fn, n_lo, n_hi):
    """Ladder-pack rows + gather map for B reads of random anchors."""
    from desamba_tpu_torch.engine.device import chain as tc

    packed, gidx = [], np.full((B, A2), -1, np.int32)
    n_anc = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(n_lo, n_hi))
        rows = rows_fn(rng, n)
        for k, r in enumerate(rows):
            p = np.zeros(13, np.int32)
            p[[tc.P_IIR, tc.P_ROFF, tc.P_MLEN, tc.P_SCORE, tc.P_REF,
               tc.P_DIR, tc.P_USELESS]] = r
            gidx[b, k] = len(packed)
            packed.append(p)
        n_anc[b] = n
    order = rng.permutation(len(packed))       # gidx is a real gather
    inv = np.argsort(order)
    packed = np.array(packed, np.int32)[order]
    gidx = np.where(gidx >= 0, inv[np.maximum(gidx, 0)], -1).astype(np.int32)
    return packed, gidx, n_anc


def _rand_anchors(rng, n):
    rows = np.zeros((n, 7), np.int32)
    diags = rng.integers(0, 5000, int(rng.integers(1, 5)))
    for k in range(n):
        d = int(diags[rng.integers(0, len(diags))]) + int(rng.integers(-40, 40))
        iir = int(rng.integers(0, 800))
        rows[k] = (iir, iir + d, int(rng.integers(9, 80)),
                   int(rng.integers(20, 300)), int(rng.integers(0, 3)),
                   int(rng.integers(0, 2)), int(rng.integers(0, 2)))
    return rows


def _rand_m3_anchors(rng, n):
    rows = np.zeros((n, 7), np.int32)
    bases = rng.integers(0, 200000, int(rng.integers(1, 6)))
    refs = rng.integers(0, 3, len(bases))
    for k in range(n):
        c = int(rng.integers(0, len(bases)))
        iir = int(rng.integers(0, 2500))
        roff = iir + int(bases[c]) + int(rng.integers(-150, 150))
        if rng.random() < 0.05:
            roff = int(rng.integers(-40, -1))    # wrapped (u32) offset
        rows[k] = (iir, roff, int(rng.integers(9, 60)),
                   int(rng.integers(20, 200)), int(refs[c]),
                   int(rng.integers(0, 2)), int(rng.integers(0, 4)))
    return rows


def case_chain_step(setup):
    from desamba_tpu.engine.device import chain as jc
    from desamba_tpu_torch.engine.device import chain as tc

    packed, gidx, n_anc = _chain_inputs(np.random.default_rng(3), 64, 64,
                                        _rand_anchors, 0, 60)
    exp = jc.chain_step(jnp.asarray(packed), jnp.asarray(gidx),
                        jnp.asarray(n_anc))
    got = tc.chain_step(T(packed), T(gidx), T(n_anc))
    for what, e, g in zip(("chains", "n", "pre", "ovf", "anc3", "info"),
                          exp, got):
        assert_same(e, g, what)
    assert np.asarray(exp[3]).any() and (~np.asarray(exp[3])).sum() > 20


def case_m3_chain_step(setup):
    from desamba_tpu.engine.device import chain as jc
    from desamba_tpu_torch.engine.device import chain as tc

    packed, gidx, n_anc = _chain_inputs(np.random.default_rng(7), 8,
                                        tc.M3_A2, _rand_m3_anchors, 50, 480)
    exp = jc.m3_chain_step(jnp.asarray(packed), jnp.asarray(gidx),
                           jnp.asarray(n_anc))
    got = tc.m3_chain_step(T(packed), T(gidx), T(n_anc))
    for what, e, g in zip(("chains", "n", "pre", "ovf", "anc3", "info"),
                          exp, got):
        assert_same(e, g, what)
    assert np.asarray(exp[1]).min() > 0


def case_prep_rescore(setup):
    from desamba_tpu.engine.device import chain as jc
    from desamba_tpu_torch.engine.device import chain as tc

    rng = np.random.default_rng(11)
    B = 48
    sets = [jc.chain_step(*[jnp.asarray(x) for x in _chain_inputs(
        rng, B, 64, _rand_anchors, 0, 49)]) for _ in range(3)]
    sel = rng.integers(0, 3, B).astype(np.int32)
    stk = [jnp.stack([s[i] for s in sets]) for i in (0, 1, 2, 4)]
    exp = jc.prep_rescore(jnp.asarray(sel), *stk)
    got = tc.prep_rescore(T(sel), *[T(x) for x in stk])
    for what, e, g in zip(("chains_rc", "n", "anchors4", "schash", "n_hash",
                           "over"), exp, got):
        assert_same(e, g, what)
    assert np.asarray(exp[1]).sum() > 0


CASES = {
    "bloom_pre13": case_bloom_pre13,
    "lv_batch": case_lv,
    "map_seed_lanes": case_map_seed,
    "mem_probe_sa16": lambda s: _mem_probe(s, None),
    "mem_probe_chase": lambda s: _mem_probe(s, 0),
    "mem_probe_mixed": lambda s: _mem_probe(s, 2),
    "chain_step": case_chain_step,
    "m3_chain_step": case_m3_chain_step,
    "prep_rescore": case_prep_rescore,
}


@pytest.mark.parametrize("case", list(CASES))
def test_stage_parity(setup, case):
    CASES[case](setup)
