"""Accuracy evaluation harness + cross-tool comparators + FASTQ utilities.

Faithful ports of the reference's eval-only analysis modes
(src/analysis.c): ana_tax (:1073) with get_tax_by_rank (:1029) and
compare_tax (:1051), filtered variants (:2135-2292), cross-tool RST
parsers — minimap2 PAF (:601), centrifuge (:823), kaiju (:895), MetaMaps
(:468), BLASTN (:2021-2133) — mark_SAM (:2317), rst_stat (:1791),
uni_v_analysis (:1756), file_cmp_bin (:2295), and the FASTQ utilities
(:2372-2608). Output formats (stdout detail + stderr stats) match the
reference byte for byte.
"""
from __future__ import annotations

import gzip
import sys

import numpy as np

from .taxonomy import Rst, load_taxonomy, sam_to_rst

MAX_U32 = 0xFFFFFFFF


def _io(out, err):
    """Resolve stdout/stderr at call time (so redirects apply)."""
    return (sys.stdout if out is None else out,
            sys.stderr if err is None else err)



def _open(path, mode="rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _read_fastx_records(path):
    """(name, comment, seq, qual) tuples, kseq-compatible."""
    from ..io.fastx import read_fastx

    for rec in read_fastx(path):
        yield rec.name, rec.comment, rec.seq, rec.qual


# ---------------------------------------------------------------- tax walks
def get_tax_by_rank(parent, rank, tax, want_rank):
    """src/analysis.c:1029-1047."""
    c_tax = tax
    while True:
        if rank.get(c_tax, "") == want_rank:
            return c_tax
        c_tax = parent.get(c_tax, MAX_U32)
        if c_tax <= 1 or c_tax == MAX_U32:
            break
    return 0


def compare_tax(parent, tax_a, tax_b):
    """Is tax_a an ancestor of tax_b (src/analysis.c:1051-1065)."""
    c_tax = tax_b
    while True:
        if c_tax == tax_a:
            return True
        c_tax = parent.get(c_tax, MAX_U32)
        if c_tax <= 1 or c_tax == MAX_U32:
            break
    return False


# ----------------------------------------------------------------- parsers
def rst_from_file(path):
    """getOneRST text format: name C/U tid read_len mapq [score]."""
    out = []
    with _open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            score = int(t[5]) if len(t) > 5 else 0
            out.append(Rst(t[0], t[1], int(t[2]), int(t[3]), int(t[4]),
                           score))
    return out


def paf_to_rst(path):
    """minimap2 PAF -> RST (src/analysis.c:601-631); every line 'C'."""
    out = []
    with _open(path) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 6:
                continue
            tid = int(t[5].split("|")[1])
            out.append(Rst(t[0], "C", tid, 0, 0, 0))
    return out


def centrifuge_to_rst(path):
    """centrifuge output -> RST (src/analysis.c:823-863)."""
    out = []
    with _open(path) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 3:
                continue
            tid = int(t[2]) if t[2].isdigit() else 0
            if tid == 0:
                out.append(Rst(t[0], "U", 0, 0, 0, 1))
            else:
                read_len = int(t[8]) if len(t) > 8 else 0
                out.append(Rst(t[0], "C", tid, read_len, 0, 1))
    return out


def kaiju_to_rst(path, read_lengths=None):
    """kaiju output -> RST (src/analysis.c:895-923). read_lengths: optional
    {name: length} map (dump_KAI_file_with_length, :1896)."""
    out = []
    with _open(path) as f:
        for line in f:
            if not line.strip():
                continue
            cls = line[0]
            t = line[2:].rstrip("\n").split("\t")
            name = t[0]
            tid = 0
            if cls == "C" and len(t) >= 4:
                # the reference takes the 4th field after the name (the
                # kaiju taxon_ids list), first comma entry
                # (src/analysis.c:906-913)
                tid = int(t[3].split(",")[0])
            rl = read_lengths.get(name, 0) if read_lengths else 0
            out.append(Rst(name, cls, tid, rl, 0, 0))
    return out


def metamaps_to_rst(path, exchange_file=None):
    """MetaMaps output -> RST (src/analysis.c:468-527). The exchange file
    maps 'x<NNN>' pseudo-tids to real tids (one tid per line, index = NNN)."""
    exchange = []
    if exchange_file:
        with _open(exchange_file) as f:
            exchange = [int(x.split()[0]) for x in f if x.strip()]
    out = []
    with _open(path) as f:
        for line in f:
            t = line.replace("\x00", " ").split()
            if len(t) < 14:
                continue
            name = t[0]
            read_len = int(t[1])
            # field 5 is 'cXXX...kraken:taxid|NNN|...' in the reference's
            # tokenization: split on 'd' then take up to '|'
            ref = t[5]
            di = ref.find("d")
            tid_part = ref[di + 1 :].split("|")[0] if di >= 0 else "0"
            if tid_part.startswith("x"):
                tid = exchange[int(tid_part[1:])]
            else:
                tid = int(tid_part)
            score = int(np.float32(t[13]) * 10000)
            out.append(Rst(name, "C", tid, read_len, 0, score))
    return out


# ---------------------------------------------------------------- ana_tax
def ana_tax(records, right_tax, tax_path, want_rank, rst_name,
            out=None, err=None, filter_map=None):
    """Accuracy vs a known taxid (src/analysis.c:1073-1213); the filtered
    variant (:2135) counts only reads whose filter verdict is 'P'."""
    out, err = _io(locals().get("out"), locals().get("err"))
    err.write(f"{rst_name}\t")
    parent, rank, _max_tid = load_taxonomy(tax_path)
    no_rank = want_rank == "null"

    def is_right(tid):
        if no_rank:
            return compare_tax(parent, right_tax, tid)
        return get_tax_by_rank(parent, rank, tid, want_rank) == right_tax

    def passes(name):
        return filter_map is None or filter_map.get(name, "F") == "P"

    total = unmapped = right_first = right_second = wrong = 0
    i = 0
    if i >= len(records):
        return
    rst = records[i]
    i += 1
    while True:
        ok = passes(rst.read_name)
        if filter_map is None or ok:
            total += 1
        out.write(f"\n{rst.read_name} ")
        if rst.is_classify == "U":
            if filter_map is None or ok:
                unmapped += 1
            out.write("UM")
            if i >= len(records):
                break
            rst = records[i]
            i += 1
            continue
        right = is_right(rst.tid)
        if right:
            if filter_map is None or ok:
                right_first += 1
            out.write("PRI")
        old_name = rst.read_name
        eof = False
        while True:
            if i >= len(records):
                eof = True
                break
            rst = records[i]
            i += 1
            if rst.read_name != old_name:
                break
            if right:
                continue
            if is_right(rst.tid):
                right = True
                if filter_map is None or ok:
                    right_second += 1
                out.write("SEC")
        if eof:
            break
        if not right and (filter_map is None or ok):
            wrong += 1

    def pct(a, b):
        return np.float32(a) / np.float32(b) * np.float32(100)

    err.write(f"{total}\t{unmapped}\t{right_first}\t"
              f"{right_second + right_first}\t")
    err.write(f"{pct(unmapped, total):f}%\t")
    err.write(f"{pct(right_first, total):f}%\t")
    err.write(f"{pct(right_first, total - unmapped):f}%\t")
    err.write(f"{pct(right_second + right_first, total):f}%\t")
    err.write(f"{pct(right_second + right_first, total - unmapped):f}%\n")


def load_filter_map(path):
    """pacbio_filter output: 'name P|F' lines."""
    out = {}
    with _open(path) as f:
        for line in f:
            t = line.split()
            if len(t) >= 2:
                out[t[0]] = t[1][0]
    return out


def ana_blastn(path, err=None):
    """BLASTN tabular coverage stat (src/analysis.c:2050-2133)."""
    out, err = _io(locals().get("out"), locals().get("err"))
    record_num = 0
    total_length = 0
    regions = []
    old_name = ""
    with _open(path) as f:
        for line in f:
            t = line.split("\t")
            if len(t) < 8:
                continue
            name = t[0]
            mapping_length = int(t[3])
            read_st, read_ed = int(t[6]), int(t[7])
            if name != old_name:
                regions = [(read_st, read_ed)]
                total_length += mapping_length
                record_num += 1
                old_name = name
            else:
                if not any(read_st <= e and read_ed >= s
                           for s, e in regions):
                    regions.append((read_st, read_ed))
                    total_length += mapping_length
    err.write(f"{path}\t {record_num}\t {total_length}\n")


def mark_sam(sam_path, tax_path, want_rank, out=None, err=None):
    """Prefix every SAM line with its rank-level taxid (src/analysis.c:2317)."""
    out, err = _io(locals().get("out"), locals().get("err"))
    err.write(f"{sam_path}\t")
    parent, rank, _ = load_taxonomy(tax_path)
    with _open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.split("\t")
            tid = 0 if t[2][0] == "*" else int(t[2].split("|")[1])
            if tid == 0:
                out.write("0\t")
            else:
                out.write(f"{get_tax_by_rank(parent, rank, tid, want_rank)}\t")
            out.write(line[:100].rstrip("\n") + "\n")


# ----------------------------------------------------------- stats / files
def rst_stat(records, err=None):
    """U/C counts (src/analysis.c:1791-1808). The reference's loop skips
    the first record and classifies the stale last record twice at EOF —
    replicated exactly."""
    out, err = _io(locals().get("out"), locals().get("err"))
    n = c = u = 0
    if records:
        for i in range(1, len(records) + 1):
            rst = records[i] if i < len(records) else records[-1]
            n += 1
            if rst.is_classify == "U":
                u += 1
            else:
                c += 1
    err.write(f"total:{n}, U:{u},C:{c}")


def uni_v_analysis(unv_path, out=None, bins: int = 100):
    """Unitig length histogram over deSAMBA.unv (src/analysis.c:1756)."""
    out, err = _io(locals().get("out"), locals().get("err"))
    with open(unv_path, "rb") as f:
        n = int(np.frombuffer(f.read(8), np.uint64)[0])
        data = np.frombuffer(f.read(8 * n), np.uint32).reshape(n, 2)
    lengths = data[:, 1]
    over = int(lengths[lengths >= bins].sum())
    counts = np.bincount(lengths[lengths < bins], minlength=bins)
    for i in range(bins):
        out.write(f"{i} {counts[i]}\n")
    out.write(f"over_{bins} {over}\n")


def file_cmp_bin(path1, path2, err=None):
    """Byte-compare two files (src/analysis.c:2295-2315)."""
    out, err = _io(locals().get("out"), locals().get("err"))
    with open(path1, "rb") as f1, open(path2, "rb") as f2:
        pos = 0
        while True:
            b1 = f1.read(1 << 20)
            b2 = f2.read(1 << 20)
            if b1 != b2:
                n = min(len(b1), len(b2))
                for i in range(n):
                    if b1[i] != b2[i]:
                        err.write(f"files differ at byte {pos + i}\n")
                        return False
                err.write(f"files differ at byte {pos + n}\n")
                return False
            if not b1:
                break
            pos += len(b1)
    err.write("files identical\n")
    return True


# ------------------------------------------------------------ FASTQ utils
def count_base(path, err=None):
    out, err = _io(locals().get("out"), locals().get("err"))
    n = total = 0
    for _name, _c, seq, _q in _read_fastx_records(path):
        n += 1
        total += len(seq)
    err.write(f"{path} read number: {n} base number {total} "
              f"( {np.float32(total) / 1000000:f} Mbp)\n")


def get_read_by_name(path, read_name, out=None):
    out, err = _io(locals().get("out"), locals().get("err"))
    for name, comment, seq, qual in _read_fastx_records(path):
        if name == read_name:
            out.write(f"@{name} {comment}\n{seq}\n+\n{qual}\n")


def reverse_read(path, err=None):
    out, err = _io(locals().get("out"), locals().get("err"))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    n = total = 0
    for _name, _c, seq, _q in _read_fastx_records(path):
        n += 1
        total += len(seq)
        err.write("".join(comp.get(ch, "X") for ch in reversed(seq)))
        err.write("\n\n\n")
    err.write(f"{path} read number: {n} base number {total} "
              f"( {np.float32(total) / 1000000:f} Mbp)\n")


def split_fastq(path, begin, step, out=None, err=None):
    out, err = _io(locals().get("out"), locals().get("err"))
    n = total = 0
    for name, comment, seq, qual in _read_fastx_records(path):
        if n >= begin and (n - begin) % step == 0:
            out.write(f"@{name} {comment}\n{seq}\n+\n{qual}\n")
            total += len(seq)
        n += 1
    err.write(f"{path} read number: {n} base number {total} "
              f"( {np.float32(total) / 1000000:f} Mbp)\n")


def _is_low_complex(seq, st, length=27):
    window = seq[st : st + length].upper()
    cap = int(length * 0.7)
    return any(window.count(b) >= cap for b in "ACGT")


def pacbio_filter(path, out=None, err=None,
                  min_len: int = 1000):
    """Read-quality filter emitting 'name P|F' lines (src/analysis.c:2535)."""
    out, err = _io(locals().get("out"), locals().get("err"))
    n = filtered = 0
    for name, _c, seq, _q in _read_fastx_records(path):
        n += 1
        ok = len(seq) >= min_len
        if ok:
            abnormal = sum(1 for i in range(len(seq) - 28)
                           if _is_low_complex(seq, i))
            ok = (len(seq) - abnormal) >= min_len
        if not ok:
            filtered += 1
            out.write(f"{name} F\n")
        else:
            out.write(f"{name} P\n")
    err.write(f"file name: {path} total number: {n} "
              f"filtered number: {filtered}\n")


def fastq_to_fasta(path, out=None):
    out, err = _io(locals().get("out"), locals().get("err"))
    for name, comment, seq, _q in _read_fastx_records(path):
        out.write(f">{name} {comment}\n{seq}\n")


def fastq_to_name(path, out=None):
    out, err = _io(locals().get("out"), locals().get("err"))
    for name, comment, _s, _q in _read_fastx_records(path):
        out.write(f"{name} {comment}\n")
