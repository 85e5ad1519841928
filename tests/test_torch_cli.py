"""The port's command line against the JAX package's, byte for byte
(tolerance 0; the pipeline is integer): ``classify --engine gold|auto`` at
``-t`` 1 and 4 on a stream whose chainless 600-bp first read sets the
stream state of the batch contract apart from serial ``classify_read``;
``index`` with and without ``--export-reference-format``; every
``analysis`` mode; ``kmersort`` from a FASTA and from a
Jellyfish dump. Also: ``kernels.build.load`` builds, loads and binds a
source once when threads race to its first use."""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from test_analysis import synthetic  # noqa: F401
from test_jellyfish_dump import _write_jf_dump

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Rec:
    def __init__(self, name, seq, qual=None):
        self.name, self.seq, self.qual = name, seq, qual


def short_read_stream(idx, n=300, seed=5):
    """A random (chainless) 600-bp read, then ``n`` reads of 60-500 bp cut
    from the reference at 2-15 % substitutions, ``r0``..``r{n-1}``."""
    from desamba_tpu.engine.gold.mapseed import get_ref

    rng = np.random.default_rng(seed)
    recs = [Rec("long0", "".join(rng.choice(list("ACGT"), 600)))]
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    for i in range(n):
        ln = int(rng.integers(60, 501))
        st = int(rng.integers(0, total - ln))
        seq = get_ref(idx.ref_bin, st, ln, True).copy()
        nerr = int(ln * rng.uniform(0.02, 0.15))
        pos = rng.integers(0, ln, size=nerr)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=nerr)) % 4
        recs.append(Rec(f"r{i}", "".join("ACGT"[c] for c in seq)))
    return recs


def write_fastq(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(f"@{r.name}\n{r.seq}\n+\n{'I' * len(r.seq)}\n")


# ---- classify --engine gold | auto ------------------------------------------
@pytest.fixture(scope="module")
def gold_case(small_my_index, tmp_path_factory):
    """The index, the stream as FASTQ, and the SAM of serial
    ``classify_read`` calls on it (the contract the JAX CLI does not
    keep)."""
    from desamba_tpu.index.store import save_index
    from desamba_tpu_torch.engine.gold.classify import ClassifyEngine
    from desamba_tpu_torch.io.sam import format_result
    from test_torch_stages import port_index

    d = tmp_path_factory.mktemp("goldcli")
    save_index(small_my_index, str(d / "idx"))
    recs = short_read_stream(small_my_index)
    write_fastq(d / "reads.fq", recs)
    g = ClassifyEngine(port_index(small_my_index))
    serial = "".join(format_result(g.classify_read(r.name, r.seq),
                                   small_my_index.ref_name, g.opts)
                     for r in recs)
    return d, len(recs), serial


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("engine", ["gold", "auto"])
def test_gold_cli_equals_jax_cli(gold_case, engine, threads):
    from desamba_tpu.cli import main as jax_main
    from desamba_tpu_torch.cli import main

    d, n, serial = gold_case
    exp, got = d / f"jax_{engine}_{threads}.sam", d / f"{engine}_{threads}.sam"
    args = ["classify", str(d / "idx"), str(d / "reads.fq"), "-t",
            str(threads), "--engine", engine]
    jax_main(args + ["-o", str(exp)])
    main(args + ["-o", str(got), "--device", "cpu"])
    assert got.read_bytes() == exp.read_bytes()
    text = exp.read_text()
    assert text.count("\n") >= n
    # the construction bites: serial classify_read keeps another state
    assert text != serial


def test_gold_cli_raises_a_read_error(tmp_path, gold_case):
    """A parse error of the reads reaches the caller (after the batches
    before it)."""
    from desamba_tpu_torch.cli import main

    d, _, _ = gold_case
    bad = tmp_path / "bad.fq"
    bad.write_text("@a\nACGT\n+\nIIII\nnot a record\n")
    with pytest.raises(OSError, match="malformed"):
        main(["classify", str(d / "idx"), str(bad), "--engine", "gold",
              "-o", str(tmp_path / "o.sam")])


# ---- index ------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_reference(small_genome, tmp_path_factory):
    """The small genome's first reference alone (a third of its build
    time)."""
    text = small_genome.read_text()
    first = text[: text.index(">", 1)]
    fa = tmp_path_factory.mktemp("oneref") / "one.fa"
    fa.write_text(first)
    return fa


@pytest.mark.parametrize("export", [False, True], ids=["native", "export"])
def test_index_cli_equals_jax_cli(one_reference, tmp_path, export):
    from desamba_tpu.cli import main as jax_main
    from desamba_tpu_torch.cli import main

    flag = ["--export-reference-format"] if export else []
    jax_main(["index", str(one_reference), str(tmp_path / "jax")] + flag)
    main(["index", str(one_reference), str(tmp_path / "port")] + flag)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert ("deSAMBA.bwt" in names) == export and "meta.json" in names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


# ---- analysis ---------------------------------------------------------------
# mode -> arguments, in the working directory that ``analysis_inputs`` makes
ANALYSIS = {
    "ana_meta": ["in.sam", "nodes.dmp"],
    "ana_meta_base": ["in.sam", "nodes.dmp"],
    "ana_species": ["in.sam", "31", "nodes.dmp"],
    "ana_genus": ["in.sam", "30", "nodes.dmp"],
    "ana_sam": ["in.sam", "41", "nodes.dmp", "species"],
    "ana_sam_filter": ["in.sam", "31", "nodes.dmp", "genus", "filter.txt"],
    "mark_genus": ["in.sam", "nodes.dmp"],
    "ana_meta_rst": ["in.rst", "nodes.dmp"],
    "ana_dump_filter": ["in.rst", "32", "nodes.dmp", "species",
                        "filter.txt"],
    "rst_stat": ["in.rst"],
    "ana_paf": ["in.paf", "31", "nodes.dmp", "genus"],
    "ana_paf_filter": ["in.paf", "31", "nodes.dmp", "species",
                       "filter.txt"],
    "ana_meta_cen": ["in.cen", "nodes.dmp"],
    "ana_meta_cen_base": ["in.cen", "nodes.dmp"],
    "ana_cen": ["in.cen", "41", "nodes.dmp", "species"],
    "ana_meta_kai": ["in.kai", "nodes.dmp"],
    "ana_kai": ["in.kai", "32", "nodes.dmp", "genus"],
    "ana_meta_kai_base": ["in.kaib", "nodes.dmp", "kai_lens.txt"],
    "ana_matemaps_base": ["in.mm", "nodes.dmp", "exchange.txt"],
    "ana_BLASTN": ["in.blast"],
    "ana_univ": ["in.unv"],
    "count_base": ["in.fq"],
    "get_read_by_NAME": ["in.fq", "q2"],
    "reverse_read": ["in.fq"],
    "split_fastq": ["in.fq", "1", "2"],
    "pacbio_filter": ["in.fq"],
    "fastq_to_fasta": ["in.fq"],
    "fastq_to_name": ["in.fq"],
    "file_cmp": ["in.fq", "in.sam"],
}


def _analysis_inputs(d, sam, nodes):
    """Every mode's input in ``d``: the synthetic SAM and nodes.dmp, and
    RST, PAF, centrifuge, kaiju, MetaMaps, BLASTN, unitig and FASTQ files
    over the same taxa."""
    d.mkdir()
    (d / "in.sam").write_bytes(sam.read_bytes())
    (d / "nodes.dmp").write_bytes(nodes.read_bytes())
    (d / "in.rst").write_text(
        "r1 C 31 520 30 120\nr2 C 30 400 30 100\nr3 U 0 0 0\n"
        "r4 C 41 300 30 0\nr5 C 32 2000 10 4\nr6 C 32 600 30 200\n")
    (d / "in.paf").write_text("".join(
        f"{n}\t{ln}\t0\t{ln}\t+\ttid|{t}|ref|X\t9\t0\t9\n"
        for n, ln, t in (("r1", 520, 31), ("r2", 400, 32), ("r4", 300, 41),
                         ("r6", 600, 31))))
    (d / "in.cen").write_text(
        "readID\tseqID\ttaxID\tscore\t2ndBest\thitLength\tqueryLength\t"
        "numMatches\treadLen\n"
        "r1\tA\t31\t9\t0\t50\t520\t1\t520\nr2\tB\t0\t0\t0\t0\t400\t1\t400\n"
        "r4\tD\t41\t9\t0\t50\t300\t1\t300\nr6\tC\t32\t9\t0\t50\t600\t1\t600\n")
    (d / "in.kai").write_text(
        "C\tr1\t31\t9\t31,30\tA\nU\tr2\t0\nC\tr4\t41\t9\t41\tD\n"
        "C\tr6\t32\t9\t32,30\tC\n")
    # kaiju with lengths by the number after a name's 11th character
    (d / "in.kaib").write_text(
        "C\tread_000000001\t31\t9\t31\tA\nU\tread_000000002\t0\n"
        "C\tread_000000003\t41\t9\t41\tD\n")
    (d / "kai_lens.txt").write_text("1 520\n2 400\n3 2300\n")
    # MetaMaps: field 5 holds "d<tid>|" or "dx<index into exchange.txt>|"
    (d / "in.mm").write_text("".join(
        f"{n} {ln} 0 {ln} + {ref} 9 0 9 0 0 0 0 {sc}\n"
        for n, ln, ref, sc in (("r1", 520, "d31|A", "0.91"),
                               ("r2", 400, "dx1|B", "0.5"),
                               ("r6", 600, "d41|D", "0.25"))))
    (d / "exchange.txt").write_text("30\n32\n")
    (d / "in.blast").write_text(
        "r1\tA\t99\t500\t0\t0\t1\t500\nr1\tA\t99\t40\t0\t0\t450\t490\n"
        "r1\tA\t99\t200\t0\t0\t600\t800\nr2\tB\t98\t300\t0\t0\t5\t305\n")
    unv = np.array([[0, 3], [7, 15], [22, 150], [5, 99]], np.uint32)
    with open(d / "in.unv", "wb") as f:
        np.uint64(len(unv)).tofile(f)
        unv.tofile(f)
    rng = np.random.default_rng(11)
    reads = ["".join(rng.choice(list("ACGT"), n)) for n in (1500, 80, 1200)]
    reads.append("A" * 400 + reads[0][:800])        # a low-complexity run
    (d / "in.fq").write_text("".join(
        f"@q{i} c{i}\n{s}\n+\n{'5' * len(s)}\n" for i, s in enumerate(reads)))
    (d / "filter.txt").write_text("r1 P\nr2 F\nr4 P\nr5 P\nr6 F\n")


def _run_modes(pkg, cwd):
    """Every mode of ANALYSIS through ``pkg``'s CLI in one process run in
    ``cwd``: {mode: (stdout, stderr)}, split at marker lines."""
    code = ("import sys\n"
            f"from {pkg}.cli import main\n"
            f"for mode, args in {ANALYSIS!r}.items():\n"
            "    for s in (sys.stdout, sys.stderr):\n"
            "        s.write('\\n@@ ' + mode + '\\n')\n"
            "        s.flush()\n"
            "    main(['analysis', mode] + args)\n"
            "    sys.stdout.flush()\n"
            "    sys.stderr.flush()\n")
    # -W ignore: a warning names its module's path, which differs
    p = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                       cwd=str(cwd),
                       capture_output=True, text=True, check=True,
                       env=dict(os.environ, PYTHONPATH=REPO))

    def split(text):
        parts = text.split("\n@@ ")[1:]
        return {p.split("\n", 1)[0]: p.split("\n", 1)[1] for p in parts}

    out, err = split(p.stdout), split(p.stderr)
    return {m: (out[m], err[m]) for m in ANALYSIS}


@pytest.fixture(scope="module")
def analysis_runs(synthetic, tmp_path_factory):  # noqa: F811
    sam, nodes = synthetic
    base = tmp_path_factory.mktemp("anacli")
    runs = {}
    for pkg in ("desamba_tpu", "desamba_tpu_torch"):
        _analysis_inputs(base / pkg, sam, nodes)
        modes = _run_modes(pkg, base / pkg)
        files = {n: (base / pkg / n).read_bytes()
                 for n in sorted(os.listdir(base / pkg))}
        runs[pkg] = modes, files
    return runs


@pytest.mark.parametrize("mode", sorted(ANALYSIS))
def test_analysis_cli_equals_jax_cli(analysis_runs, mode):
    exp, got = analysis_runs["desamba_tpu"][0], \
        analysis_runs["desamba_tpu_torch"][0]
    assert got[mode] == exp[mode]
    assert any(exp[mode]), mode             # the mode wrote something


def test_analysis_cli_leaves_the_same_files(analysis_runs):
    assert analysis_runs["desamba_tpu_torch"][1] == \
        analysis_runs["desamba_tpu"][1]


# ---- kmersort ---------------------------------------------------------------
def test_kmersort_cli_equals_jax_cli(small_genome, tmp_path):
    """From the FASTA, and from a Jellyfish dump of the same k-mers in
    another order (--jf)."""
    from desamba_tpu.cli import main as jax_main
    from desamba_tpu_torch.cli import main

    jax_main(["kmersort", str(small_genome), "-o", str(tmp_path / "j.srt")])
    main(["kmersort", str(small_genome), "-o", str(tmp_path / "p.srt")])
    exp = (tmp_path / "j.srt").read_bytes()
    assert (tmp_path / "p.srt").read_bytes() == exp
    data = np.frombuffer(exp, np.uint64)
    assert int(data[0]) == len(data) - 1 > 1000

    kmers = data[1:].copy()
    np.random.default_rng(2).shuffle(kmers)
    jdb = tmp_path / "mers.jdb"
    _write_jf_dump(jdb, kmers[:5000], 31)
    jax_main(["kmersort", "--jf", str(jdb), "-o", str(tmp_path / "jj.srt")])
    main(["kmersort", "--jf", str(jdb), "-o", str(tmp_path / "pj.srt")])
    exp_jf = (tmp_path / "jj.srt").read_bytes()
    assert (tmp_path / "pj.srt").read_bytes() == exp_jf
    assert np.frombuffer(exp_jf, np.uint64)[0] == 5000


# ---- kernels.build under threads --------------------------------------------
def test_build_load_once_under_threads(monkeypatch):
    """Eight threads race to the first ``ladder_lib()``: one build, one
    library, bound once, the same object for all."""
    from desamba_tpu_torch.kernels import build

    builds, loads = [], []

    class FakeLib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            if name.startswith("ladder_"):
                fn = type("Fn", (), {})()
                setattr(self, name, fn)
                return fn
            raise AttributeError(name)

    def fake_start(src):
        builds.append(src)
        threading.Event().wait(0.05)      # a slow build widens the race
        return None

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "start_build", fake_start)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    go = threading.Barrier(8)
    got = []

    def worker():
        go.wait()
        got.append(build.ladder_lib())

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert builds == ["ladder.cu"]
    assert loads == [build._lib_path("ladder.cu")]
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert got[0]._bound and got[0].ladder_fast_launch.restype is not None
