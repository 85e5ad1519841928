"""Port fast/slow ladders == the JAX ladders on captured lane sets.

The lane sets are captured by spying on ``DeviceClassifier._k_ladder``
(the port's, on the CPU, which builds them exactly as the JAX classifier
does) while it classifies noisy reads (small genome) and the repeat
corpus; each captured call is replayed through the JAX ladder on the same
inputs. The packed anchors and the (N, 4) info rows must be bit-equal,
including a forced SP_SET hot-tier overflow (iv_cap=1)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_repeat_paths import (  # noqa: E402,F401
    repeat_genome,
    repeat_my_index,
    repeat_reads,
)
from test_torch_stages import T, _random_reads, assert_same  # noqa: E402


class _Rec:
    def __init__(self, name, seq):
        self.name, self.seq, self.qual = name, seq, None


def _noisy_recs(idx, n, seed):
    rng = np.random.default_rng(seed)
    recs = [_Rec(f"r{i}", "".join("ACGT"[c] for c in r))
            for i, r in enumerate(_random_reads(idx, n, rng, 300, 1500))]
    # reads absent from the index drive the slow ladders
    recs += [_Rec(f"x{i}", "".join(rng.choice(list("ACGT"), 400)))
             for i in range(3)]
    return recs


def _capture(idx, recs):
    """Every ladder call of the port's classifier on ``recs``: its inputs
    (as numpy) and its outputs."""
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu_torch.engine.device.classifier import DeviceClassifier

    eng = DeviceClassifier(idx, Options(), "cpu")
    calls = []
    orig = eng._k_ladder

    def spy(kind, codes_fr, buf_len, pre13, lane_args, NB, iv_cap=32):
        out = orig(kind, codes_fr, buf_len, pre13, lane_args, NB,
                   iv_cap=iv_cap)
        calls.append(dict(kind=kind, NB=NB, iv_cap=iv_cap,
                          codes_fr=codes_fr.numpy(), buf_len=buf_len.numpy(),
                          pre13=pre13.numpy(), lane_args=lane_args.numpy(),
                          packed=out[0], info=out[1]))
        return out

    eng._k_ladder = spy
    list(eng.classify_reads(recs))
    return eng.dix, calls


@pytest.fixture(scope="module")
def captured(small_my_index, repeat_my_index, repeat_reads):
    from desamba_tpu.engine.device.arrays import DeviceIndex
    from desamba_tpu.io.fastx import read_fastx

    out = []
    for idx, recs in ((small_my_index, _noisy_recs(small_my_index, 10, 31)),
                      (repeat_my_index, list(read_fastx(str(
                          repeat_reads[0]))))):
        tix, calls = _capture(idx, recs)
        out.append((idx, DeviceIndex.build(idx), tix, calls))
    return out


def _port_ladder(idx, tix, c, iv_cap):
    from desamba_tpu_torch.engine.device.classifier import A_CAP, M_CAP
    from desamba_tpu_torch.engine.device.ladder import fast_ladder, slow_ladder

    args = (tix.index_refs(), tix.fm_blocks, tix.rank, tix.hash13,
            T(c["codes_fr"]), T(c["buf_len"]), T(c["pre13"]), tix.q_mem,
            tix.q_lv, T(c["lane_args"]))
    kw = dict(l_ek=idx.len_e_kmer, a_cap=A_CAP, pack_cap=2 * c["NB"],
              iv_cap=iv_cap)
    if c["kind"] == "fast":
        return fast_ladder(*args, **kw)
    return slow_ladder(*args, m_cap=M_CAP, **kw)


def _jax_ladder(idx, jd, c, iv_cap):
    from desamba_tpu.engine.device.classifier import A_CAP, M_CAP
    from desamba_tpu.engine.device.ladder import fast_ladder, slow_ladder

    args = (jd.index_refs(), jd.fm_blocks, jd.rank, jd.hash13,
            jnp.asarray(c["codes_fr"]), jnp.asarray(c["buf_len"]),
            jnp.asarray(c["pre13"]), jd.q_mem, jd.q_lv,
            jnp.asarray(c["lane_args"]))
    kw = dict(l_ek=idx.len_e_kmer, a_cap=A_CAP, pack_cap=2 * c["NB"],
              bl=min(128, c["NB"]), iv_cap=iv_cap)
    if c["kind"] == "fast":
        return fast_ladder(*args, **kw)
    return slow_ladder(*args, m_cap=M_CAP, **kw)


@pytest.mark.parametrize("kind", ["fast", "slow"])
def test_ladder_matches_jax(captured, kind):
    n = 0
    for idx, jd, tix, calls in captured:
        for c in calls:
            if c["kind"] != kind:
                continue
            e_packed, e_info, _ = _jax_ladder(idx, jd, c, c["iv_cap"])
            assert_same(e_info, c["info"], f"{kind} info")
            assert_same(e_packed, c["packed"], f"{kind} packed anchors")
            n += int(c["info"][:, 1].sum() > 0)
    assert n >= 2, f"too few {kind} ladder calls with anchors"


@pytest.mark.parametrize("kind", ["fast", "slow"])
def test_ladder_forced_iv_overflow_matches_jax(captured, kind):
    """iv_cap=1: every lane that inserts a second SP_SET interval sets the
    sticky overflow bit; both ladders must agree on that and on every
    anchor they still produce."""
    n_ovf = 0
    idx, jd, tix, calls = captured[1]      # only the repeat corpus overflows
    for c in calls:
        if c["kind"] != kind:
            continue
        e_packed, e_info, _ = _jax_ladder(idx, jd, c, 1)
        packed, info, _ = _port_ladder(idx, tix, c, 1)
        assert_same(e_info, info, f"{kind} info iv_cap=1")
        assert_same(e_packed, packed, f"{kind} packed iv_cap=1")
        n_ovf += int(np.asarray(e_info)[:, 3].sum())
    assert n_ovf > 0, "iv_cap=1 never overflowed"
