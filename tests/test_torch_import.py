"""desamba_tpu_torch never loads jax or the JAX package, restates the JAX
package's constants exactly, and keeps the integer conventions its package
docstring states."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    """Every module of desamba_tpu_torch (found by walking the package, the
    copied host code and the tools included) imports neither jax nor
    anything of the JAX package desamba_tpu."""
    code = ("import importlib, pkgutil, sys\n"
            "import desamba_tpu_torch as P\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    P.__path__, 'desamba_tpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith('jax.') or m.startswith('jaxlib')\n"
            "             or m == 'desamba_tpu'\n"
            "             or m.startswith('desamba_tpu.'))\n"
            "print(' '.join(mods))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    mods, bad = (out.stdout + "\n").split("\n")[:2]
    assert bad == "", bad
    mods = set(mods.split())
    assert len(mods) >= 48   # device, gold, index, io, kernels and tools
    assert {"desamba_tpu_torch.cli", "desamba_tpu_torch.io.prefetch",
            "desamba_tpu_torch.index.compat",
            "desamba_tpu_torch.analysis.taxonomy",
            "desamba_tpu_torch.analysis.evaluate",
            "desamba_tpu_torch.parallel.sharded"} <= mods


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py, parsed: no import of jax or desamba_tpu, at any
    depth of the file."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "desamba_tpu_torch.engine.device.classifier" in names
    for n in names:
        root = n.split(".")[0]
        assert root not in ("jax", "jaxlib", "desamba_tpu"), n


# (port module, JAX module, names restated in the port)
RESTATED = [
    ("classifier", "classifier", ("A_CAP", "M_CAP")),
    ("chain", "chain", ("C2", "CH_NF", "M3_A2", "RC_CAP", "AF2", "H_REF",
                        "H_QTD", "H_SUM", "H_ANUM", "H_DIR", "H_TOP",
                        "H_TST", "H_TED", "H_QST", "H_QED", "H_INDEL",
                        "H_CUR", "H_CID", "P_MLEN", "P_SCORE", "P_DIR",
                        "P_GOFF", "P_REF", "P_ROFF", "P_IIR", "P_USELESS")),
    ("rescore", "rescore", ("C_CAP", "A_CAP", "S_CAP", "W_CAP", "CF_N",
                            "AF_N", "C_REF", "C_DIR", "C_SUM", "C_ANUM",
                            "C_TST", "C_TED", "C_QST", "C_QED", "C_INDEL",
                            "C_CUR")),
    ("rescore_ref", "rescore_pl", ("CF_CAP", "F_CAP", "H_CAP", "MAX_STEPS",
                                   "OVER", "FB_MIDW", "FB_WRAP", "FB_HITS",
                                   "FB_FCAP", "FB_SMS", "FB_OVER")),
    ("textwalk", "textwalk", ("IV_CAP",)),
    ("ladder", "ladder", ("IV_HOT", "M_NF")),
    ("fm", "fm", ("SA_CAP",)),
    ("mapseed", "mapseed", ("A_NF", "A_FIELDS", "GARBAGE")),
    ("lv", "lv", ("LV_BASE", "NQ", "OFF", "SENT_REF", "SENT_QRY")),
    ("arrays", "arrays", ("BLOCK",)),
]


@pytest.mark.parametrize("port_mod,jax_mod,names", RESTATED,
                         ids=[r[0] for r in RESTATED])
def test_restated_constants_match_jax(port_mod, jax_mod, names):
    import importlib

    p = importlib.import_module(f"desamba_tpu_torch.engine.device.{port_mod}")
    j = importlib.import_module(f"desamba_tpu.engine.device.{jax_mod}")
    for n in names:
        assert getattr(p, n) == getattr(j, n), n


def test_sharded_layout_restates_jax():
    """parallel/sharded.py keeps its own copies of the JAX layout's row
    alignment and sharded fields."""
    from desamba_tpu.parallel import sharded as j
    from desamba_tpu_torch.parallel import sharded as p

    assert p.ROW_ALIGN == j.ROW_ALIGN
    assert p.SHARDED_IXR_FIELDS == j.SHARDED_IXR_FIELDS
    for n in (1, 2, 4):
        a = np.arange(9223, dtype=np.int32)
        pf, ps = p._flat_pad(torch.from_numpy(a), n)
        jf, js = j._flat_pad(a, n)
        assert ps == js and np.array_equal(pf.numpy(), jf)


def test_u32_travels_as_int32_bit_patterns():
    from desamba_tpu_torch.engine.device.intops import i32, popc, u32

    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF],
                    np.uint32)
    t = torch.from_numpy(vals.view(np.int32))
    assert t.dtype == torch.int32
    assert u32(t).tolist() == [int(v) for v in vals]
    assert torch.equal(i32(u32(t)), t)
    assert popc(u32(t)).tolist() == [bin(int(v)).count("1") for v in vals]


def test_unsigned_compare_only_where_jax_casts():
    """chain._absu compares unsigned (a wrapped-huge ref offset is far from
    a small one); the diagonal test beside it stays signed."""
    import jax.numpy as jnp

    from desamba_tpu.engine.device import chain as jc
    from desamba_tpu_torch.engine.device import chain as tc

    a = np.array([-5, 10, 2**31 - 1, -(2**31), 400], np.int32)
    b = np.array([3, -3, -1, 5, 0], np.int32)
    got = tc._absu(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, np.asarray(jc._absu(jnp.asarray(a),
                                                   jnp.asarray(b))))
    assert got[0] != 8          # signed |(-5) - 3| would be 8


def test_arange_and_cumsum_widen_to_int64():
    m = torch.ones(4, dtype=torch.int32)
    assert torch.arange(4).dtype == torch.int64
    assert torch.cumsum(m, 0).dtype == torch.int64
    from desamba_tpu_torch.engine.device.compaction import compact_rows

    rows_g, rows_s, valid = compact_rows(torch.tensor([True, False, True]), 2)
    assert rows_g.dtype == rows_s.dtype == torch.int32
    assert rows_s.tolist() == [0, 2] and valid.tolist() == [True, True]


def test_scatter_out_of_bounds_raises_in_torch_drops_in_port():
    """JAX's compact_rows parks lanes past k at an out-of-range scatter
    index and relies on the drop; torch raises there, so the port masks."""
    import jax.numpy as jnp

    from desamba_tpu.engine.device.compaction import compact_rows as jcr
    from desamba_tpu_torch.engine.device.compaction import compact_rows
    from desamba_tpu_torch.engine.device.intops import take

    with pytest.raises(IndexError):
        torch.zeros(5, dtype=torch.int32)[torch.tensor([1, 7])] = \
            torch.tensor([10, 20], dtype=torch.int32)
    mask = np.random.default_rng(1).random(40) < 0.6
    for k in (4, 16, 40):                 # k below the live count drops
        exp = jcr(jnp.asarray(mask), k)
        got = compact_rows(torch.from_numpy(mask), k)
        for e, g in zip(exp, got):
            assert np.asarray(e).tolist() == g.tolist()
    src = np.arange(5, dtype=np.int32) * 3
    gi = np.array([-7, -1, 9, 2], np.int64)
    assert take(torch.from_numpy(src), torch.from_numpy(gi)).tolist() == \
        np.asarray(jnp.asarray(src)[jnp.asarray(gi)]).tolist()


def test_started_processes_get_no_persistent_jax_cache():
    """The root conftest switches the JAX compilation cache off for the
    processes that tests start (the two workers of test_multihost.py must
    both compile), and leaves this process's cache on."""
    import jax

    assert os.environ["JAX_ENABLE_COMPILATION_CACHE"] == "false"
    assert jax.config.jax_enable_compilation_cache is True
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.config.jax_enable_compilation_cache)"],
        capture_output=True, text=True, check=True, cwd=REPO)
    assert out.stdout.strip() == "False"
