"""Plain version of the per-read 9-mer SDP rescore kernel.

A read-by-read transliteration, on Python ints, of what the CUDA kernel
(``kernels/rescore.cu``) computes — which is what the JAX package's
Pallas kernel (``desamba_tpu/engine/device/rescore_pl.py``,
``_make_kernel.kernel``) computes. It is the CPU path of
``rescore_pl.rescore`` and the oracle the kernel is held against on the
card; it never runs on the main path when the device is ``cuda``.

uint32 coordinates are int32 bit patterns: ``_w`` wraps every add to
int32, and ``_ult``/``_ule`` compare unsigned at exactly the points the
Pallas kernel uses ``po.ult``/``po.ule``/``po.umin``.
"""
from __future__ import annotations

import numpy as np

from ...constants import MIN_SCORE_MEM, OVER_SEARCH_M2, S_A_KMER_L

from .rescore import (C_ANUM, C_CAP, C_CUR, C_DIR, C_INDEL, C_QED, C_QST,
                      C_REF, C_SUM, C_TED, C_TST, CF_N, S_CAP, W_CAP)

K9 = S_A_KMER_L
OVER = OVER_SEARCH_M2          # 50
CF_CAP = 96                    # stage-1 candidate cap (fallback parity)
F_CAP = 48                     # stage-2 survivor cap (fallback parity)
H_CAP = 4                      # hits per probe value (fallback parity)
NCAND = 128                    # candidate slots per window fetch
MAX_STEPS = 1 << 14            # per-read step guard
FB_MIDW, FB_WRAP, FB_HITS, FB_FCAP, FB_SMS, FB_OVER = 1, 2, 4, 8, 16, 32
NEG_INF = -(1 << 30)
M32 = 0xFFFFFFFF


def _w(x):
    """Wrap to int32."""
    return ((x + 0x80000000) & M32) - 0x80000000


def _ult(a, b):
    return (a & M32) < (b & M32)


def _ule(a, b):
    return (a & M32) <= (b & M32)


def _abs(x):
    return _w(-x) if x < 0 else x


def _popc(v):
    return bin(v & M32).count("1")


def _clip(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


class _Read:
    """One read's rescore program (what one warp of the kernel walks)."""

    def __init__(self, prep, b):
        s = prep["scal"][b]
        self.n_chains, self.n_hash = int(s[0]), int(s[1])
        self.l_read, self.buf_len = int(s[2]), int(s[3])
        self.chw = [list(map(int, r)) for r in prep["chains"][b]]
        self.anc = prep["anchors"][b].tolist()
        self.A2 = len(self.anc)
        self.sch = prep["schash"][b].tolist()
        self.cpk = prep["codes_pk"][b].tolist()
        self.nw = len(self.cpk)
        self.kw = -(-self.nw // 128) * 128
        self.rkv = prep["rk_vals"][b].tolist()
        self.rkp = prep["rk_pos"][b].tolist()
        self.refw = prep["ref_words"]
        self.NR = len(self.refw) // 128
        self.ref_off = prep["ref_off"]
        self.ref_len = prep["ref_len"]
        self.n_bases = prep["n_bases"]
        self.last_char = prep["last_char"]
        self.sms = [[0] * S_CAP for _ in range(4)]
        self.hashv = [[0] * 16 for _ in range(10)]

    # ---- small accessors --------------------------------------------------
    def anc_f(self, a, f):
        return self.anc[_clip(a, 0, self.A2 - 1)][f]

    def sms_set(self, slot, q, t, ln, sc):
        if 0 <= slot < S_CAP:
            for r, v in enumerate((q, t, ln, sc)):
                self.sms[r][slot] = v

    def sms_get(self, slot):
        if 0 <= slot < S_CAP:
            return tuple(self.sms[r][slot] for r in range(4))
        return (-(1 << 31),) * 4

    def build_hashv(self):
        for e in range(len(self.sch)):
            key, eci_raw, soe = self.sch[e]
            c = self.chw[_clip(eci_raw, 0, C_CAP - 1)]
            vals = (key, eci_raw, soe, c[C_QST], c[C_TST], c[C_QED],
                    c[C_TED], c[C_REF], c[C_DIR], c[C_SUM])
            for r, v in enumerate(vals):
                self.hashv[r][e] = v

    # ---- packed words -----------------------------------------------------
    def word16_q(self, base):
        b = max(base, 0)
        w0, sh = b >> 4, (b & 15) << 1
        i0 = _clip(w0, 0, self.kw - 1)
        i1 = _clip(w0 + 1, 0, self.kw - 1)
        g0 = self.cpk[i0] & M32 if i0 < self.nw else 0
        g1 = self.cpk[i1] & M32 if i1 < self.nw else 0
        v = g0 if sh == 0 else ((g0 >> sh) | (g1 << (32 - sh))) & M32
        if base >= 0:
            return v
        neg = _clip(-base, 0, 16)
        return 0 if neg >= 16 else (v << (min(neg, 15) << 1)) & M32

    @staticmethod
    def word16_w(wj, base):
        b = max(base, 0)
        w0, sh = b >> 4, (b & 15) << 1
        g0 = wj[_clip(w0, 0, 127)]
        g1 = wj[_clip(w0 + 1, 0, 127)]
        v = g0 if sh == 0 else ((g0 >> sh) | (g1 << (32 - sh))) & M32
        if base >= 0:
            return v
        neg = _clip(-base, 0, 16)
        return 0 if neg >= 16 else (v << (min(neg, 15) << 1)) & M32

    def run_len(self, wj, win_len, qstart, wstart, forward, cap):
        """Match-run length: read char qstart +- k vs window char
        wstart +- k, k < cap (rescore_pl._run_len_lanes, one lane)."""
        n = 0
        run = cap > 0
        while run:
            qi = _w(qstart + n) if forward else _w(qstart - n)
            wi = _w(wstart + n) if forward else _w(wstart - n)
            qw = self.word16_q(qi if forward else qi - 15)
            ww = self.word16_w(wj, wi if forward else wi - 15)
            y = qw ^ ww
            y = (y | (y >> 1)) & 0x55555555
            if forward:
                t = ((y & ((~y + 1) & M32)) - 1) & M32
                m = _popc(t & 0x55555555)
                q_rem = self.buf_len - qi if qi >= 0 else 0
                w_rem = win_len - wi if wi >= 0 else 0
            else:
                s = y | (y >> 2)
                s = s | (s >> 4)
                s = s | (s >> 8)
                s = s | (s >> 16)
                m = 16 - _popc(s & 0x55555555)
                q_rem = (1 << 30) if qi < self.buf_len else 0
                w_rem = wi + 1 if wi < win_len else 0
            lim = max(min(q_rem, w_rem, cap - n), 0)
            adv = min(m, lim, 16)
            n += adv
            run = adv == 16 and n < cap
        return min(n, max(cap, 0))

    # ---- window fetch -----------------------------------------------------
    def fetch_window(self, goff, bug_zero):
        """128 words (2048 chars) of reference starting at char goff
        (clamped at 0); chars past n_bases replicate the last char, chars
        at window index >= bug_zero read 0."""
        off0 = max(goff, 0)
        gw0, cb = off0 >> 4, off0 & 15
        r0 = _clip(gw0 >> 7, 0, self.NR - 2)
        o = gw0 & 127
        at = r0 * 128 + o
        aw = [int(x) & M32 for x in self.refw[at : at + 128]]
        base_g = at * 16
        rep = (self.last_char * 0x55555555) & M32
        bz = bug_zero + cb
        for l in range(128):
            nv = _clip(self.n_bases - (base_g + 16 * l), 0, 16)
            keep = M32 if nv >= 16 else (1 << (2 * nv)) - 1
            v = (aw[l] & keep) | (rep & ~keep & M32)
            nz = _clip(bz - 16 * l, 0, 16)
            aw[l] = v & (M32 if nz >= 16 else (1 << (2 * nz)) - 1)
        if cb == 0:
            return aw
        sh = cb << 1
        return [((aw[l] >> sh) | (aw[(l + 1) & 127] << (32 - sh))) & M32
                for l in range(128)]

    # ---- sdp_match --------------------------------------------------------
    def sdp_match(self, forward, wj, t_len, t0j, q_bg, q_ed, t_st, dslot,
                  base_slot, is_mid, fb):
        """Append match nodes to sms from slot base_slot. Returns
        (n_new, fb)."""
        t_kmer_num = _w(t_len - K9 + 1)
        qbase = 0 if dslot == 1 else self.l_read
        phi = 0 if forward else (t0j + t_kmer_num - 1) & 3
        rkn = self.l_read - K9 + 1 if self.l_read >= K9 else 0
        vals, pos = self.rkv[dslot], self.rkp[dslot]
        qf = _ule(q_bg, q_ed)
        total_cand = lead_cnt = n_new = 0
        hits_over = False
        if t_kmer_num > 4:
            for i in range(4, t_kmer_num, 4):
                j = i + t0j if forward else t0j + t_kmer_num - 1 - i
                if not 0 <= j - phi <= 4 * 511:
                    continue
                pv = 0
                for k in range(K9):
                    x = j + k
                    pv = (pv << 2) | ((wj[(x >> 4) & 127] >> ((x & 15) << 1))
                                      & 3)
                lo, hi = 0, rkn
                while lo < hi:
                    mid = (lo + hi) >> 1
                    if vals[mid] < pv:
                        lo = mid + 1
                    else:
                        hi = mid
                cnt = 0
                while cnt <= H_CAP and lo + cnt < rkn and vals[lo + cnt] == pv:
                    cnt += 1
                hits_over |= cnt > H_CAP
                tpos = j - t0j
                for h in range(min(cnt, H_CAP)):
                    qpos = int(pos[lo + h])
                    if not (qf and _ule(q_bg, qpos)):
                        continue
                    c = total_cand
                    total_cand += 1
                    if c >= NCAND:
                        continue
                    if forward:
                        wl = t_len + (0 if is_mid else OVER)
                        short = self.run_len(wj, wl, qbase + qpos - 1,
                                             t0j + tpos - 1, False, 4)
                    else:
                        short = self.run_len(wj, t0j + t_len,
                                             qbase + qpos + K9,
                                             t0j + tpos + K9, True, 4)
                    if not (short < 4 or i == 4):
                        continue
                    lead_cnt += 1
                    if forward:
                        ms_u = _w(q_ed - qpos - 1)
                        b_u = _w(t_len - tpos - 1)
                        cap = _w((ms_u if _ult(ms_u, b_u) else b_u) + OVER)
                        longr = self.run_len(wj, wl, qbase + qpos + K9,
                                             t0j + tpos + K9, True, cap)
                        back, fwd = short, longr
                    else:
                        cap = min(qpos, tpos) + OVER
                        longr = self.run_len(wj, t0j + t_len, qbase + qpos - 1,
                                             t0j + tpos - 1, False, cap)
                        back, fwd = longr, short
                    total = back + fwd + 1
                    if total >= 4:
                        self.sms_set(base_slot + n_new, _w(qpos - back),
                                     _w(tpos - back + t_st), total, 0)
                        n_new += 1
        if hits_over:
            fb |= FB_HITS
        if total_cand > CF_CAP or lead_cnt > F_CAP:
            fb |= FB_FCAP
        if base_slot + n_new + 1 > S_CAP:
            fb |= FB_SMS
        return n_new, fb

    # ---- node DP ----------------------------------------------------------
    def node_dp(self, cur, is_left, is_mid):
        cq, ct, cln, _ = self.sms_get(cur)
        pq_, pt_, pl_, ps_ = self.sms
        best = NEG_INF
        if not is_left:
            max_q, max_t = _w(cq + 6), _w(ct + 6)
        else:
            min_q = _w(cq + cln - 6 + K9 - 1)
            min_t = _w(ct + cln - 6 + K9 - 1)
        for s in range(min(cur, S_CAP) - 1, -1, -1):
            pq, pt, plen, psc = pq_[s], pt_[s], pl_[s], ps_[s]
            if not is_left:
                pqe, pte = _w(pq + plen + K9 - 1), _w(pt + plen + K9 - 1)
                ok = _ule(pqe, max_q) and _ule(pte, max_t)
                brk = _ult(_w(pt + 600), max_t)
                indel = _w(pq - pt - _w(max_q - max_t))
                pen = (max(_w(pqe - cq), _w(pte - ct))
                       if _ult(cq, pqe) or _ult(ct, pte) else 0)
            else:
                ok = _ule(min_q, pq) and _ule(min_t, pt)
                brk = _ult(_w(min_t + 600), pt)
                indel = _w(pq - pt - _w(min_q - min_t))
                pen = (max(_w(min_q + 6 - pq), _w(min_t + 6 - pt))
                       if _ult(pq, _w(min_q + 6)) or _ult(pt, _w(min_t + 6))
                       else 0)
            if brk and not is_mid:
                break
            if ok and _abs(indel) <= 200:
                new = _w(psc + cln - (_abs(indel) >> 3) - pen)
                best = max(best, new)
        node_max = max(cln, best)
        if 0 <= cur < S_CAP:
            self.sms[3][cur] = node_max
        return node_max

    # ---- middle walk ------------------------------------------------------
    def run_middle(self, a, dslot, t_glob, fb, steps):
        score = 10000
        while a >= 0 and fb == 0 and steps < MAX_STEPS:
            pre = self.anc_f(a, 3)
            cur_q, cur_t, cur_m = (self.anc_f(a, 0), self.anc_f(a, 1),
                                   self.anc_f(a, 2))
            if pre < 0:
                score = _w(score + cur_m - K9 + 1)
                steps += 1
            else:
                pre_q, pre_t, pre_m = (self.anc_f(pre, 0), self.anc_f(pre, 1),
                                       self.anc_f(pre, 2))
                pre_roff3 = _w(pre_t - 3)
                trl = _w(cur_t - _w(pre_roff3 + pre_m) + 3)
                if trl > 12 and trl > W_CAP:
                    fb |= FB_MIDW
                self.sms_set(0, pre_q, pre_t, _w(pre_m - K9 + 1), score)
                n_new = 0
                if trl > 12 and fb == 0:
                    t_st = _w(pre_roff3 + pre_m)
                    wj = self.fetch_window(_w(t_st + t_glob), 1 << 20)
                    n_new, fb = self.sdp_match(
                        True, wj, trl, 0, _w(pre_q + pre_m - 8),
                        _w(cur_q - 1), t_st, dslot, 1, True, fb)
                self.sms_set(_clip(1 + n_new, 0, S_CAP - 1), cur_q, cur_t,
                             _w(cur_m - K9 + 1), 0)
                n_sms = min(2 + n_new, S_CAP)
                for si in range(1, n_sms):
                    score = max(score, self.node_dp(si, False, True))
                steps += n_sms
            a = pre
        return score, fb, steps

    # ---- side extension ---------------------------------------------------
    def run_side(self, is_left, ci, dslot, t_glob, t_length, score_in, fb,
                 steps):
        c = self.chw[ci]
        q_anchor = c[C_QST] if is_left else c[C_QED]
        t_anchor = c[C_TST] if is_left else c[C_TED]
        self.sms_set(0, q_anchor, t_anchor, 0 if is_left else 1 - K9,
                     score_in)
        n, cur, max_id, total, so = 1, 1, 0, score_in, score_in
        cto = _w(t_anchor + 3) if is_left else _w(t_anchor - 3)
        ls, done = 0, 0
        while done == 0 and fb == 0 and steps < MAX_STEPS:
            if cur == n:
                best_q = self.sms_get(max_id)[0]
                q_st_c, q_ed_c = c[C_QST], c[C_QED]
                if is_left:
                    brk = _ult(cto, MIN_SCORE_MEM)
                    near = _ult(q_st_c, 600)
                    msr_raw = _w(q_st_c + 60) if near else cto
                else:
                    brk = _ult(_w(t_length - cto), MIN_SCORE_MEM)
                    near = _w(self.l_read - q_ed_c) < 600
                    msr_raw = (_w(self.l_read - q_ed_c + 60) if near
                               else _w(t_length - cto))
                brk = brk or (near and ls != 0)
                ls = ls | int(near)
                msr = 600 if _ult(600, msr_raw) else msr_raw
                fwrap = (not brk) and cto < 0
                if fwrap:
                    fb |= FB_WRAP
                if brk or fwrap:
                    done = 1
                    steps += 1
                    continue
                if is_left:
                    bug = t_glob == 0 and cto < OVER + msr
                    goff = _w(cto + t_glob - msr - (0 if bug else OVER))
                    bugz = msr if bug else 1 << 20
                    t0j, t_st = OVER, _w(cto - msr)
                else:
                    goff, bugz, t0j, t_st = _w(cto + t_glob), 1 << 20, 0, cto
                wj = self.fetch_window(goff, bugz)
                if is_left:
                    sqs = max(_w(best_q - 1000), 0)
                    q_bg = sqs
                    a_u, b_u = _w(sqs + 2000), _w(q_st_c - 1)
                    q_ed = a_u if _ult(a_u, b_u) else b_u
                else:
                    sqe = min(_w(best_q + 1000), self.l_read)
                    a_u, b_u = _w(sqe - 2000), _w(q_st_c - 8)
                    q_bg = a_u if _ult(b_u, a_u) else b_u
                    q_ed = sqe
                n_new, fb = self.sdp_match(not is_left, wj, msr, t0j, q_bg,
                                           q_ed, t_st, dslot, n, False, fb)
                cto = (_w(cto - (msr - K9 - 3)) if is_left
                       else _w(cto + msr - K9 - 3))
                first_t = self.sms_get(_clip(cur, 0, S_CAP - 1))[1]
                best_t = self.sms_get(max_id)[1]
                far = (_ult(_w(first_t + 1000), best_t) if is_left
                       else _ult(_w(best_t + 1000), first_t))
                n = n + n_new
                done = int(n_new == 0 or far)
                steps += 1
                continue
            node_max = self.node_dp(cur, is_left, False)
            cq, ct, cln, _ = self.sms_get(cur)
            dis = _w(ct - cq)
            c_q_pos = _w(cq + cln) if is_left else cq
            hv = self.hashv
            first_e = -1
            if cln >= 8:
                for e in range(min(self.n_hash, 16)):
                    if is_left:
                        dis_con = _w(hv[6][e] - hv[5][e])
                        q_pos_con = _w(hv[5][e] - K9)
                        soe_want = 1
                    else:
                        dis_con = _w(hv[4][e] - hv[3][e])
                        q_pos_con = hv[3][e]
                        soe_want = 0
                    if (hv[0][e] == (dis & 0xFF) and dis == dis_con
                            and hv[1][e] != ci and hv[2][e] != soe_want
                            and _abs(_w(c_q_pos - q_pos_con)) < 8
                            and hv[7][e] == c[C_REF] and hv[8][e] == c[C_DIR]
                            and hv[9][e] != 0 and hv[1][e] > ci):
                        first_e = e
                        break
            if first_e >= 0:
                aci = _clip(hv[1][first_e], 0, C_CAP - 1)
                a_ = self.chw[aci]
                c[C_SUM] = _w(c[C_SUM] + a_[C_SUM])
                c[C_ANUM] = _w(c[C_ANUM] + a_[C_ANUM])
                c[C_INDEL] = _w(c[C_INDEL] + a_[C_INDEL])
                c[C_QST] = min(c[C_QST], a_[C_QST])
                c[C_TST] = min(c[C_TST], a_[C_TST])
                c[C_QED] = max(c[C_QED], a_[C_QED])
                c[C_TED] = max(c[C_TED], a_[C_TED])
                absorbed_cur = a_[C_CUR]
                for f in (C_SUM, C_TST, C_TED, C_QST, C_QED):
                    a_[f] = 0
                self.build_hashv()
                mid_sc, fb, steps = self.run_middle(absorbed_cur, dslot,
                                                    t_glob, fb, steps + 1)
                total = _w(max(so, node_max) - cln + mid_sc - 10000)
                q_a2 = c[C_QST] if is_left else c[C_QED]
                t_a2 = c[C_TST] if is_left else c[C_TED]
                self.sms_set(0, q_a2, t_a2, 0 if is_left else -K9, total)
                n, cur, max_id, so, cto, done = 1, 1, 0, total, t_a2, 0
            else:
                cur2 = cur + 1
                if total < node_max:
                    total, max_id = node_max, cur2 - 1
                best_t = self.sms_get(max_id)[1]
                brk2 = (_ult(_w(ct + 1000), best_t) if is_left
                        else _ult(_w(best_t + 1000), ct))
                cur, done = cur2, int(brk2)
                steps += 1
        if steps >= MAX_STEPS:
            fb |= FB_OVER
        bq, bt, bl, _ = self.sms_get(_clip(max_id, 0, S_CAP - 1))
        if is_left:
            c[C_QST], c[C_TST] = bq, bt
            c[C_SUM] = _w(total - 10000)
        else:
            c[C_QED], c[C_TED] = _w(bq + bl + K9), _w(bt + bl + K9)
        return total, fb, steps

    # ---- chain loop -------------------------------------------------------
    def run(self):
        ci_prev, fb, steps = -1, 0, 0
        nref = len(self.ref_off)
        rcap = -(-nref // 128) * 128
        while fb == 0 and steps < MAX_STEPS and ci_prev < self.n_chains:
            pick = C_CAP
            for cc in range(C_CAP):
                if ci_prev < cc < self.n_chains and self.chw[cc][C_SUM] != 0:
                    pick = cc
                    break
            if pick >= C_CAP:
                ci_prev = C_CAP
                continue
            ci = pick
            c = self.chw[ci]
            dslot = _clip(c[C_DIR], 0, 1)
            refc = _clip(c[C_REF], 0, rcap - 1)
            t_glob = int(self.ref_off[refc]) if refc < nref else 0
            t_length = int(self.ref_len[refc]) if refc < nref else 0
            self.build_hashv()
            sc, fb, steps = self.run_middle(c[C_CUR], dslot, t_glob, fb,
                                            steps)
            sc, fb, steps = self.run_side(False, ci, dslot, t_glob, t_length,
                                          sc, fb, steps)
            sc, fb, steps = self.run_side(True, ci, dslot, t_glob, t_length,
                                          sc, fb, steps)
            ci_prev = ci
        return [r[:CF_N] for r in self.chw], fb, steps


def rescore_rows(prep, rows=None):
    """Run the plain rescore on the prepared batch ``prep`` (numpy arrays,
    see ``rescore_pl.prepare``). Returns (chains (B, C_CAP, CF_N) int32,
    flags (B, 3) int32 = [fallback, reason bits, steps])."""
    B = len(prep["scal"])
    rows = range(B) if rows is None else rows
    chains = np.array(prep["chains"], dtype=np.int32, copy=True)
    flags = np.zeros((B, 3), np.int32)
    for b in rows:
        out, fb, steps = _Read(prep, b).run()
        chains[b] = out
        flags[b] = (int(fb != 0), fb, steps)
    return chains, flags
