"""Taxonomy abundance analysis (reference src/analysis.c).

Faithful ports: taxonTree_rank (:71), getOneSAM/dump_des_sam_file
(:191-466), getOneRST (:161), ana_get_tid (:1271), ana_meta (:1332),
ana_meta_base_M2 (:1620), ana_meta_loop_print (:1233).

Output is byte-compatible with the reference (float32 percentages through
%f formatting, empty tax_name fields, sibling order = descending weight
with stable ties).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

MAX_U32 = 4294967295
MIN_SCORE = 10  # base-weighted gate (src/analysis.c:1470)


@dataclass
class Rst:
    read_name: str
    is_classify: str
    tid: int
    read_length: int
    mapq: int
    score: int


def load_taxonomy(path: str):
    """nodes.dmp -> (parent: dict, rank: dict, max_tid). max_tid = last
    line's tid + 1,000,000 (src/analysis.c:79-92)."""
    parent, rank = {}, {}
    last_tid = 0
    with open(path) as f:
        for line in f:
            fields = [t for t in line.replace("|", "\t").split("\t") if t.strip() != ""]
            parts = line.split("\t|\t")
            tid = int(parts[0])
            parent[tid] = int(parts[1])
            rank[tid] = parts[2].split("\t")[0].strip("|\t\n")
            last_tid = tid
    max_tid = last_tid + 1_000_000
    parent[1] = 0
    rank[1] = "root"
    rank[0] = "CLY_FAIL"
    return parent, rank, max_tid


def sam_to_rst(sam_path: str):
    """dump_des_sam_file equivalent: SAM lines -> RST records
    (src/analysis.c:191-294). Read length = sum of CIGAR M/I/S/X."""
    out = []
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.rstrip("\n").split("\t")
            name = t[0]
            if t[2][0] == "*":
                out.append(Rst(name, "U", 0, 0, 0, 0))
                continue
            tid = int(t[2].split("|")[1])
            mapq = int(t[4])
            cigar = t[5]
            read_len = 0
            n = 0
            for ch in cigar:
                if ch.isdigit():
                    n = n * 10 + ord(ch) - 48
                else:
                    if ch in "MISX":
                        read_len += n
                    n = 0
            score = 0
            for tag in t[11:]:
                if tag.startswith("AS:i:") or tag.startswith("NM:i:"):
                    score = int(tag.split(":")[2])
                    break
            out.append(Rst(name, "C", tid, read_len, mapq, score))
    return out


def _ana_get_tid(records, i, max_tid, parent):
    """src/analysis.c:1271-1330. Returns (final_tid, read_len, coverage,
    mapq_of_first, next_i). One call consumes one read group."""
    rst = records[i]
    read_len = rst.read_length
    mapq = rst.mapq
    if rst.is_classify != "C":
        return 0, read_len, 0.0, mapq, i + 1
    tid, score, coverage = 0, 0, np.float32(0)
    if rst.tid <= max_tid:
        tid = rst.tid
        score = rst.score
        coverage = (np.float32(score) / np.float32(rst.read_length)
                    if rst.read_length > 0 else np.float32(0))
    name = rst.read_name
    j = i + 1
    while True:
        if j >= len(records):
            # C returns 0 when the group ends at EOF (src/analysis.c:1303):
            # the final read's tid is dropped (still counted as a read)
            return 0, read_len, coverage, mapq, j
        nxt = records[j]
        if nxt.read_name != name:
            break
        if score == 0:
            break  # nxt stays unconsumed and becomes the next "read"
        j += 1
        if nxt.score != score:
            continue
        if nxt.tid > max_tid:
            continue
        p_tid = nxt.tid
        while True:
            if p_tid == tid:
                tid = nxt.tid
                break
            if p_tid < 1 or p_tid == MAX_U32:
                break
            p_tid = parent.get(p_tid, MAX_U32)
    return tid, read_len, coverage, mapq, j


def _fmt_f(x) -> str:
    # C printf("%f") of the x86 0.0f/0.0f NaN prints "-nan" (sign bit
    # set); keep byte parity on empty inputs
    return "-nan" if np.isnan(x) else f"{x:f}"


def _print_tree(weights, mapq_w, children, rank, node, level, total, is_base,
                out):
    w = weights.get(node, 0)
    rate = np.float32(w) / np.float32(total) * np.float32(100)
    if rate < 0.01:
        return
    out.write("|" * level)
    if is_base:
        mq = np.float32(mapq_w.get(node, 0)) / np.float32(w) * rate
        out.write(f"{rank.get(node, '')} TID:{node}  {_fmt_f(rate)}%, "
                  f"mapQ:{_fmt_f(mq)}\n")
    else:
        out.write(f"{rank.get(node, '')} TID:{node}  {_fmt_f(rate)}%\n")
    for ch in children.get(node, []):
        _print_tree(weights, mapq_w, children, rank, ch, level + 1, total,
                    is_base, out)


def _propagate(leaf_weight, leaf_mapq, parent):
    """Weight propagation + child adjacency, in descending-leaf-weight order
    (stable, ascending tid ties; src/analysis.c:1416-1446)."""
    order = sorted(leaf_weight.keys(), key=lambda t: (-leaf_weight[t], t))
    weights, mapq_w, children = {}, {}, {}
    for tid in order:
        w = leaf_weight[tid]
        m = leaf_mapq.get(tid, 0)
        weights[tid] = weights.get(tid, 0) + w
        mapq_w[tid] = mapq_w.get(tid, 0) + m
        c = tid
        while True:
            p = parent.get(c, MAX_U32)
            if p < 1 or p == MAX_U32:
                break
            weights[p] = weights.get(p, 0) + w
            mapq_w[p] = mapq_w.get(p, 0) + m
            lst = children.setdefault(p, [])
            if c not in lst:
                lst.append(c)
            c = p
    return weights, mapq_w, children


def ana_meta(rst_records, tax_path, rst_name, out=sys.stdout):
    """Read-count abundance tree (src/analysis.c:1332-1458)."""
    out.write(f"Current read {rst_name}\t{rst_name}\t")
    parent, rank, max_tid = load_taxonomy(tax_path)
    node_count: dict = {}
    total_reads = 0
    i = 0
    while i < len(rst_records):
        total_reads += 1
        tid, _rl, _cov, _mq, i = _ana_get_tid(rst_records, i, max_tid, parent)
        if tid > 0:
            node_count[tid] = node_count.get(tid, 0) + 1
    weights, mapq_w, children = _propagate(node_count, {}, parent)
    out.write("Data:\n")
    _print_tree(weights, mapq_w, children, rank, 1, 0, total_reads, False, out)
    out.write(f"total_read_number :{total_reads}\t")


def ana_meta_base(rst_records, tax_path, rst_name, out=sys.stdout,
                  with_mapq=True):
    """Base-weighted abundance tree (src/analysis.c). with_mapq=True is
    the M2 variant the SAM path uses (:1620-1752, prints mapQ);
    with_mapq=False is the plain variant (:1471-1608, no mapQ) used by
    the centrifuge/kaiju/MetaMaps base modes (:1866, :1943, :1748)."""
    out.write(f"Current read {rst_name}\t{rst_name}\t")
    parent, rank, max_tid = load_taxonomy(tax_path)
    node_base: dict = {}
    node_mapq: dict = {}
    total_base = 0
    low_num = low_base = 0
    i = 0
    while i < len(rst_records):
        mapq = rst_records[i].mapq
        tid, read_len, cov, _mq, i = _ana_get_tid(rst_records, i, max_tid, parent)
        if tid > 0 and np.float32(cov) * read_len > MIN_SCORE:
            total_base += read_len
            node_base[tid] = node_base.get(tid, 0) + read_len
            node_mapq[tid] = node_mapq.get(tid, 0) + read_len * mapq
            if cov < 0.08:
                low_base += read_len
                low_num += 1
    weights, mapq_w, children = _propagate(node_base, node_mapq, parent)
    out.write("Analysis based on base number:\n")
    _print_tree(weights, mapq_w, children, rank, 1, 0, total_base,
                with_mapq, out)
    out.write(f"total_mapped_base_number :{total_base}\n")
    out.write(f"low identity read (identity <= 75%) number :{low_num}\t")
    out.write(f"total base {low_base}\t")


def run_analysis(mode: str, args: list, out=sys.stdout):
    """simDataTest dispatcher (src/analysis.c:2640-2683)."""
    from . import evaluate as ev

    if mode == "ana_meta":
        sam, tax = args
        ana_meta(sam_to_rst(sam), tax, sam + ".temp", out)
    elif mode == "ana_meta_base":
        sam, tax = args
        ana_meta_base(sam_to_rst(sam), tax, sam + ".temp", out)
    elif mode == "ana_meta_rst":
        rst, tax = args
        ana_meta(ev.rst_from_file(rst), tax, rst, out)
    elif mode == "ana_meta_cen":
        cen, tax = args
        ana_meta(ev.centrifuge_to_rst(cen), tax, cen + ".temp", out)
    elif mode == "ana_meta_cen_base":
        cen, tax = args
        ana_meta_base(ev.centrifuge_to_rst(cen), tax, cen + ".temp", out,
                      with_mapq=False)
    elif mode == "ana_meta_kai":
        kai, tax = args
        ana_meta(ev.kaiju_to_rst(kai), tax, kai + ".temp", out)
    elif mode == "ana_meta_kai_base":
        kai, tax, lens_fn = args
        lengths = {}
        with open(lens_fn) as f:
            for line in f:
                t = line.split()
                if len(t) >= 2:
                    lengths[int(t[0])] = int(t[1])
        recs = ev.kaiju_to_rst(kai)
        for r in recs:
            r.read_length = lengths.get(int(r.read_name[11:] or 0), 0)
        ana_meta_base(recs, tax, kai + ".temp", out, with_mapq=False)
    elif mode == "ana_matemaps_base":
        mm, tax, exchange = args
        ana_meta_base(ev.metamaps_to_rst(mm, exchange), tax, mm + ".temp",
                      out, with_mapq=False)
    elif mode in ("ana_species", "ana_genus"):
        sam, right_tax, tax = args
        rank = "species" if mode == "ana_species" else "genus"
        ev.ana_tax(sam_to_rst(sam), int(right_tax), tax, rank,
                   sam + ".temp", out)
    elif mode == "ana_sam":
        sam, right_tax, tax, rank = args
        ev.ana_tax(sam_to_rst(sam), int(right_tax), tax, rank,
                   sam + ".temp", out)
    elif mode == "ana_paf":
        paf, right_tax, tax, rank = args
        ev.ana_tax(ev.paf_to_rst(paf), int(right_tax), tax, rank,
                   paf + ".temp", out)
    elif mode == "ana_cen":
        cen, right_tax, tax, rank = args
        ev.ana_tax(ev.centrifuge_to_rst(cen), int(right_tax), tax, rank,
                   cen + ".temp", out)
    elif mode == "ana_kai":
        kai, right_tax, tax, rank = args
        ev.ana_tax(ev.kaiju_to_rst(kai), int(right_tax), tax, rank,
                   kai + ".temp", out)
    elif mode == "ana_BLASTN":
        ev.ana_blastn(args[0])
    elif mode in ("ana_sam_filter", "ana_dump_filter"):
        src, right_tax, tax, rank, filt = args
        recs = (sam_to_rst(src) if mode == "ana_sam_filter"
                else ev.rst_from_file(src))
        ev.ana_tax(recs, int(right_tax), tax, rank, src + ".temp", out,
                   filter_map=ev.load_filter_map(filt))
    elif mode == "ana_paf_filter":
        paf, right_tax, tax, rank, filt = args
        ev.ana_tax(ev.paf_to_rst(paf), int(right_tax), tax, rank,
                   paf + ".temp", out,
                   filter_map=ev.load_filter_map(filt))
    elif mode == "mark_genus":
        sam, tax = args
        ev.mark_sam(sam, tax, "genus", out)
    elif mode == "count_base":
        ev.count_base(args[0])
    elif mode == "get_read_by_NAME":
        ev.get_read_by_name(args[0], args[1], out)
    elif mode == "reverse_read":
        ev.reverse_read(args[0])
    elif mode == "split_fastq":
        ev.split_fastq(args[0], int(args[1]), int(args[2]), out)
    elif mode == "pacbio_filter":
        ev.pacbio_filter(args[0], out)
    elif mode == "fastq_to_fasta":
        ev.fastq_to_fasta(args[0], out)
    elif mode == "fastq_to_name":
        ev.fastq_to_name(args[0], out)
    elif mode == "ana_univ":
        ev.uni_v_analysis(args[0], out)
    elif mode == "rst_stat":
        ev.rst_stat(ev.rst_from_file(args[0]))
    elif mode == "file_cmp":
        ev.file_cmp_bin(args[0], args[1])
    else:
        raise SystemExit(f"analysis mode [{mode}] unsupported")
