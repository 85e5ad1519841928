"""Output formatters: SAM / SAM_FULL / DES / DES_FULL.

Byte-faithful to src/cly_mt.c:158-365 (field order, tabs — including the
trailing tab after AS:i — MAPQ rules, CIGAR S/H usage). Coordinates are
uint32 in the reference but printed with %d, so wrapped values (t_st of
a chain whose left extension crossed the reference start) print
negative — _i32 mirrors that.
"""
from __future__ import annotations


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def format_sam(res, ref_names, max_sec_n: int, output_seq: bool) -> str:
    out = []
    seq_s = res.seq if output_seq else "*"
    qual_s = (res.qual if res.qual is not None else "*") if output_seq else "*"
    chains = res.chains
    if not chains:
        return f"{res.name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq_s}\t{qual_s}\t\n"
    read_l = res.read_len
    c0 = chains[0]
    flag = 0 if c0.direction else 0x10
    if len(chains) == 1 or (c0.sum_score - chains[1].sum_score > 5):
        mapq_pri = 30
    else:
        mapq_pri = (c0.sum_score - chains[1].sum_score) << 2
    out.append(
        f"{res.name}\t{flag}\t{ref_names[c0.ref_id]}\t{_i32(c0.t_st)}\t{mapq_pri}\t"
        f"{_i32(c0.q_st)}S{_i32(c0.q_ed - c0.q_st)}M"
        f"{_i32(read_l - c0.q_ed)}S\t*\t0\t0\t"
        f"{seq_s}\t{qual_s}\tAS:i:{c0.sum_score}\t\n"
    )
    for loop in (0, 1):
        for c in chains[1:]:
            flag = 0 if c.direction else 0x10
            mapq = 0
            if loop == 0 and c.pri_index == 0:
                flag += 0x800
                mapq = min(30, mapq_pri)
            elif loop == 1 and 0 < c.pri_index <= max_sec_n:
                flag += 0x100
            else:
                continue
            hs = "H" if loop == 0 else "S"
            out.append(
                f"{res.name}\t{flag}\t{ref_names[c.ref_id]}\t{_i32(c.t_st)}\t{mapq}\t"
                f"{_i32(c.q_st)}{hs}{_i32(c.q_ed - c.q_st)}M"
                f"{_i32(read_l - c.q_ed)}{hs}\t*\t0\t0\t"
                f"*\t*\tAS:i:{c.sum_score}\t\n"
            )
    return "".join(out)


def format_des(res, ref_names, max_sec_n: int, full: bool) -> str:
    out = [
        f"{res.name}\t{'CLASSIFY' if res.chains else 'UNCLASSIFY'}\t"
        f"{'FAST' if res.fast else 'SLOW'}\t{res.read_len}\t"
        f"n_rst:[{len(res.chains)}]\tn_anc:[{len(res.anchors)}]\t\n"
    ]
    rst_cnt = 0

    def hit_line(c):
        nonlocal rst_cnt
        pri = ["PRI", "SEC", "SUP"][c.primary - 1]
        line = (
            f"{rst_cnt:3d} {pri} {'F' if c.direction else 'R'} "
            f"{ref_names[c.ref_id]:>20s} ts:{_i32(c.t_st):<10d} "
            f"te:{_i32(c.t_ed):<10d} "
            f"qs:{_i32(c.q_st):<10d} qe:{_i32(c.q_ed):<10d} "
            f"{c.sum_score:<5d}\t{c.indel}\t\n"
        )
        rst_cnt += 1
        return line

    for c in res.chains:
        if c.pri_index == 0:
            out.append(hit_line(c))
    for c in res.chains:
        if full:
            if c.pri_index > 0:
                out.append(hit_line(c))
        elif 0 < c.pri_index <= max_sec_n:
            out.append(hit_line(c))
    out.append("\n")
    return "".join(out)


def format_result(res, ref_names, opts) -> str:
    if opts.out_format == "SAM":
        return format_sam(res, ref_names, opts.max_sec_n, False)
    if opts.out_format == "SAM_FULL":
        return format_sam(res, ref_names, opts.max_sec_n, True)
    if opts.out_format == "DES":
        return format_des(res, ref_names, opts.max_sec_n, False)
    if opts.out_format == "DES_FULL":
        return format_des(res, ref_names, opts.max_sec_n, True)
    raise ValueError(opts.out_format)
