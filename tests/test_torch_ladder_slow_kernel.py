"""The slow-ladder CUDA kernel's own source (``slow_ladder_kernel`` of
kernels/ladder.cu over kernels/ladder.cuh, a warp per lane), compiled as
host C++ over tests/cuda_host/warp_emu.h and run on the CPU, == the JAX ``slow_ladder``
and the port's eager ``slow_ladder`` (its plain version), bit for bit
(tolerance 0): packed anchors, the (N, 4) info rows (column 2 the MEM
overflow) and the pack overflow.

The lane sets are every slow-ladder call of ``test_torch_ladder``'s
``captured`` fixture (noisy reads and reads absent from the index on the
small genome, the repeat corpus) and of the six-strain family and the edge
corpus of ``test_torch_ladder_kernel``, at the captured SP_SET tier (on the
edge corpus a re-dispatch of lanes whose SP_SETs pass 32 intervals), at
the full tier (``iv_cap=None``), at ``iv_cap`` 1 and 2 (hot-tier
overflows), at ``m_cap`` 3 and 9 on the repeat corpus (a lane stores fewer
MEMs than it finds, and records of equal length meet across the 8th place
of the stable sort, of which the kernel keeps only the first 8) and 16 on
the edge corpus (equal lengths from different trips in the top 8), and on
a lane set whose first probes overflow the eager port's shared SA pool at 8
rows a probe. Each case runs each warp's threads in order and in reverse
between collectives, and each lane's trips are the ladder's closed form (a probe every second
position from ``seed_len - 1`` down to 1)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_repeat_paths import (  # noqa: E402,F401
    repeat_genome,
    repeat_my_index,
    repeat_reads,
)
from test_torch_ladder import (  # noqa: E402,F401
    _jax_ladder,
    _port_ladder,
    captured,
)
from test_torch_ladder_kernel import (  # noqa: E402,F401
    _emulate,
    _pool_lanes,
    corpora,
    corpus_sets,
    count_pool_routing,
    edges,
    ladder_emu,
)
from test_torch_stages import assert_same  # noqa: E402


def _slow_calls(sets):
    for idx, jd, tix, calls in sets:
        for c in calls:
            if c["kind"] == "slow":
                yield idx, jd, tix, c


def _lane_trips(c):
    """Each lane's slow-ladder trips: j = seed_len - 1, seed_len - 3, ...
    down to 1."""
    la = c["lane_args"]
    return np.where(la[7] != 0, la[6] // 2, 0)


def _check(lib, idx, jd, tix, c, iv_cap, m_cap=None, eager=True):
    """Kernel (both orders) == JAX == eager port on call ``c``; with
    ``eager`` False the eager outputs are the captured ones (the call's own
    tier). Returns the JAX info rows."""
    from desamba_tpu_torch.engine.device.classifier import M_CAP
    from desamba_tpu_torch.engine.device.ladder import slow_ladder

    e_packed, e_info, e_ovf = _jax_ladder(idx, jd, c, iv_cap, m_cap)
    if eager:
        p_packed, p_info, p_ovf = _port_ladder(idx, tix, c, iv_cap, m_cap)
        assert bool(p_ovf) == bool(e_ovf), "eager port pack overflow"
        assert slow_ladder.trips == _lane_trips(c).max(initial=0)
    else:
        p_packed, p_info = c["packed"], c["info"]
    assert_same(e_info, p_info, "eager port info")
    assert_same(e_packed, p_packed, "eager port packed")
    for reverse in (False, True):
        (packed, info, ovf), trips = _emulate(
            lib, idx, tix, c, iv_cap, reverse, kind="slow",
            m_cap=m_cap or M_CAP)
        what = f"iv_cap={iv_cap} m_cap={m_cap} reverse={reverse}"
        assert_same(e_info, info, f"kernel info, {what}")
        assert_same(e_packed, packed, f"kernel packed anchors, {what}")
        assert bool(e_ovf) == ovf, f"pack overflow, {what}"
        assert np.array_equal(trips.numpy(), _lane_trips(c)), \
            f"lanes' trips, {what}"
    return np.asarray(e_info)


@pytest.mark.parametrize("corpus", ["fixtures", "strains", "edges"])
@pytest.mark.parametrize("tier", ["captured", "full"])
def test_slow_kernel_source_matches_jax_and_plain(corpora, ladder_emu, tier,
                                                  corpus, request):
    """Every captured slow-ladder call, at its own SP_SET tier (against the
    eager outputs the capture holds) and at the full tier: tolerance 0 on
    packed anchors, info rows and pack overflow. On the edge corpus a lane's
    SP_SET passes the hot tier's 32 intervals (the classifier re-ran its
    group at the full tier, which the captured tier replays) and probes rank
    SA_CAP-row buckets whose LCEs tie."""
    from desamba_tpu_torch.engine.device.ladder import IV_HOT

    n = redispatched = 0
    for idx, jd, tix, c in _slow_calls(corpus_sets(corpora, corpus,
                                                   request)):
        if tier == "captured":
            info = _check(ladder_emu, idx, jd, tix, c, c["iv_cap"],
                          eager=False)
        else:
            info = _check(ladder_emu, idx, jd, tix, c, None)
        n += int(info[:, 1].sum() > 0)
        redispatched += c["iv_cap"] is None
    assert n >= 1, "no slow-ladder call with anchors"
    if corpus == "edges":
        seen = request.getfixturevalue("edges")[4]
        assert seen["slow", "niv"] > IV_HOT and redispatched, \
            "no SP_SET passed the hot tier"
        assert seen["slow", "tied"] > 0, "no SA_CAP-row bucket with tied LCEs"


@pytest.mark.parametrize("iv_cap", [1, 2])
def test_slow_kernel_source_forced_iv_overflow(corpora, ladder_emu, iv_cap):
    """A hot tier of one or two intervals overflows, and the kernel agrees
    with both on that and on every anchor."""
    n_ovf = 0
    for idx, jd, tix, c in _slow_calls(corpora):
        info = _check(ladder_emu, idx, jd, tix, c, iv_cap)
        n_ovf += int(info[:, 3].sum())
    assert n_ovf > 0, f"iv_cap={iv_cap} never overflowed"


def cross_trip_ties(lane_recs, m_cap):
    """The lanes with more than m_cap MEM records ((length, str_idx) each,
    in the order found) whose top 8 of the first m_cap (a stable sort by
    length, longest first) holds two of equal length from different
    trips."""
    n = 0
    for recs in lane_recs.values():
        if len(recs) > m_cap:
            top = sorted(recs[:m_cap], key=lambda r: -r[0])[:8]
            n += any(a[0] == b[0] and a[1] != b[1]
                     for i, a in enumerate(top) for b in top[i + 1:])
    return n


@pytest.mark.parametrize("m_cap", [3, 9, 16])
def test_slow_kernel_source_mem_cap(corpora, ladder_emu, monkeypatch,
                                    request, m_cap):
    """A lane stores only its first ``m_cap`` MEMs and flags the rest (info
    column 2); the map takes the 8 longest of those in the stable order.
    On the repeat corpus, whose lanes find many MEMs: at m_cap 3 lanes
    overflow; at 9 some lane's 8th and 9th records are of equal length (the
    eager sort's keys say so), so the kernel's top 8 keeps the earlier
    one. At 16, on the edge corpus, a lane finds more than 16 MEMs and its
    top 8 holds records of equal length from different trips (the kernel
    merges each trip's rows into its list after the older records)."""
    from desamba_tpu_torch.engine.device import ladder

    keys = []
    orig = ladder.argsort_stable

    def spy(key, dim):
        order = orig(key, dim=dim)
        keys.append(key.gather(dim, order))
        return order

    lane_recs = {}
    orig_probe = ladder._probe

    def probe_spy(*a):
        out = orig_probe(*a)
        rg, (_, str_idx, r) = a[8], out
        for i, lane in enumerate(rg.tolist()):
            for k in np.flatnonzero(r[5][i].numpy()):
                lane_recs.setdefault(lane, []).append(
                    (int(r[0][i, k]), int(str_idx[i])))
        return out

    monkeypatch.setattr(ladder, "argsort_stable", spy)
    monkeypatch.setattr(ladder, "_probe", probe_spy)
    n_ovf = ties = crossed = 0
    sets = corpora[1:2] if m_cap < 16 else corpus_sets(None, "edges",
                                                       request)
    for idx, jd, tix, c in _slow_calls(sets):     # the repeats, the edges
        lane_recs.clear()
        info = _check(ladder_emu, idx, jd, tix, c, c["iv_cap"], m_cap)
        n_ovf += int(info[:, 2].sum())
        crossed += cross_trip_ties(lane_recs, m_cap)
        k = keys[-1].numpy()
        if k.shape[1] > 8:
            ties += int(((k[:, 7] == k[:, 8]) & (k[:, 8] < 1 << 30)).sum())
    assert n_ovf > 0, f"m_cap={m_cap} never overflowed"
    if m_cap == 9:
        assert ties > 0, "no lane had equal lengths at the 8th place"
    if m_cap == 16:
        assert crossed > 0, "no top 8 held equal lengths from two trips"


def test_slow_kernel_source_sa_pool_overflow(corpora, ladder_emu,
                                             monkeypatch):
    """Lanes that each start at a probe with 3..SA_CAP bucket rows overflow
    the eager probe's shared SA pool: the eager port sends lane-probes to
    the rank chase (counted, > 0) and the kernel ranks every such bucket in
    position space; at MEM_SEARCH_SLOW rows a probe both give the same rows
    in the same order: kernel == eager port == JAX, tolerance 0."""
    routed = count_pool_routing(monkeypatch)
    lanes = 0
    for idx, jd, tix, c in _slow_calls(corpora[:2]):
        cut, n = _pool_lanes(tix, c, idx.len_e_kmer, copies=2, lowest=1)
        if n:
            _check(ladder_emu, idx, jd, tix, cut, c["iv_cap"])
            lanes += n
    assert lanes > 0, "no probe with several bucket rows"
    assert routed[0] > 0, "the shared SA pool never sent a lane to the chase"
