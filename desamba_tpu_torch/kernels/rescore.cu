// Per-read 9-mer sparse-DP rescore (src/cly.c:2335-2849) for Hopper.
//
// Replaces the Pallas TPU kernel desamba_tpu/engine/device/rescore_pl.py
// (rescore_kernel_pl, kernel body _make_kernel.kernel). It computes what
// that kernel computes, read for read and bit for bit: the anchor-gap walk
// (run_middle), the right/left window extensions (run_side/fetch_window),
// the 9-mer window matches (sdp_match), the sequential sparse DP over the
// sms node slots (node_dp) and the combine-hash absorption of sibling
// chains (build_hashv). The plain version beside it,
// desamba_tpu_torch/engine/device/rescore_ref.py, transliterates this file
// line for line and is what it is held against.
//
// Design: one thread per read. The TPU kernel emulated vector gathers,
// unsigned compares and lane rolls (plops.py); here they are direct global
// loads and native uint32 ops. A read's working state (chains, 128 sms
// slots, combine-hash entries, one 2048-char window) sits in the thread's
// local memory. What bounds it: per-thread latency of dependent global
// loads (binary searches over the read's sorted 9-mer table, packed LCE
// words) and warp divergence, since reads take data-dependent paths; the
// card is far from its memory or compute roofline. Making it fast (a warp
// per read, shared-memory staging of the sorted table and the window) is
// later work.
//
// uint32 coordinates travel as int32 bit patterns; every add wraps through
// w32() and the compares are unsigned (ult/ule) exactly where the Pallas
// kernel used po.ult/po.ule/po.umin. Windows that run past the last base
// read the last base, and the one zero row after the packed reference keeps
// the two-row window read in range (rescore_pl.py:1036-1047). The caps that
// keep fallbacks in parity (CF_CAP, F_CAP, H_CAP, S_CAP, MAX_STEPS), the
// bug_zero window truncation and the u32 wraps are kept.
#include <cstdint>
#include <cuda_runtime.h>

#define K9 9
#define OVER 50
#define C_CAP 8
#define CF_N 10
#define S_CAP 128
#define W_CAP 704
#define CF_CAP 96
#define F_CAP 48
#define H_CAP 4
#define NCAND 128
#define HASH_CAP 16
#define MAX_STEPS (1 << 14)
#define MIN_SCORE_MEM 12
#define NEG_INF (-(1 << 30))

enum { C_REF, C_DIR, C_SUM, C_ANUM, C_TST, C_TED, C_QST, C_QED, C_INDEL,
       C_CUR };
enum { FB_MIDW = 1, FB_WRAP = 2, FB_HITS = 4, FB_FCAP = 8, FB_SMS = 16,
       FB_OVER = 32 };

struct Params {
  const int* scal;          // (B, 4) [n_chains, n_hash, read_len, buf_len]
  const int* chains;        // (B, C_CAP, CF_N)
  const int* anchors;       // (B, A2, 4) [iir, roff, mlen, pre]
  const int* schash;        // (B, HASH_CAP, 3) [key, ci, s_or_e]
  const unsigned* codes_pk; // (B, nw) packed F+R read buffer
  const int* rk_vals;       // (B, 2, K) value-sorted 9-mers per direction
  const int* rk_pos;        // (B, 2, K) their read positions
  const unsigned* ref_words;  // (NR * 128,) packed reference + zero row
  const int* ref_off;       // (nref,)
  const int* ref_len;       // (nref,)
  int* chains_out;          // (B, C_CAP, CF_N)
  int* flags;               // (B, 3) [fallback, reason bits, steps]
  int B, A2, nw, K, NR, nref, n_bases, last_char;
};

__device__ __forceinline__ int w32(long long x) {
  return (int)(unsigned)(unsigned long long)x;
}
__device__ __forceinline__ bool ult(int a, int b) {
  return (unsigned)a < (unsigned)b;
}
__device__ __forceinline__ bool ule(int a, int b) {
  return (unsigned)a <= (unsigned)b;
}
__device__ __forceinline__ int iabs(int x) {
  return x < 0 ? (int)(0u - (unsigned)x) : x;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Read {
  const Params* P;
  int n_chains, n_hash, l_read, buf_len, kw;
  const int* anc;
  const int* sch;
  const unsigned* cpk;
  const int* rkv;
  const int* rkp;
  int chw[C_CAP][CF_N];
  int sms[4][S_CAP];
  int hashv[10][HASH_CAP];
  unsigned wj[128];
};

__device__ __forceinline__ int anc_f(const Read& R, int a, int f) {
  return R.anc[clampi(a, 0, R.P->A2 - 1) * 4 + f];
}

__device__ __forceinline__ void sms_set(Read& R, int slot, int q, int t,
                                        int ln, int sc) {
  if (slot >= 0 && slot < S_CAP) {
    R.sms[0][slot] = q;
    R.sms[1][slot] = t;
    R.sms[2][slot] = ln;
    R.sms[3][slot] = sc;
  }
}

__device__ __forceinline__ int sms_get(const Read& R, int r, int slot) {
  return (slot >= 0 && slot < S_CAP) ? R.sms[r][slot] : (int)0x80000000;
}

__device__ void build_hashv(Read& R) {
  for (int e = 0; e < HASH_CAP; ++e) {
    const int* s = R.sch + e * 3;
    const int* c = R.chw[clampi(s[1], 0, C_CAP - 1)];
    int vals[10] = {s[0], s[1], s[2], c[C_QST], c[C_TST], c[C_QED],
                    c[C_TED], c[C_REF], c[C_DIR], c[C_SUM]};
    for (int r = 0; r < 10; ++r) R.hashv[r][e] = vals[r];
  }
}

// ---- packed words ---------------------------------------------------------
__device__ unsigned word16_q(const Read& R, int base) {
  int b = base > 0 ? base : 0;
  int w0 = b >> 4, sh = (b & 15) << 1;
  int i0 = clampi(w0, 0, R.kw - 1), i1 = clampi(w0 + 1, 0, R.kw - 1);
  unsigned g0 = i0 < R.P->nw ? R.cpk[i0] : 0u;
  unsigned g1 = i1 < R.P->nw ? R.cpk[i1] : 0u;
  unsigned v = sh == 0 ? g0 : ((g0 >> sh) | (g1 << (32 - sh)));
  if (base >= 0) return v;
  int neg = clampi(w32(-(long long)base), 0, 16);
  return neg >= 16 ? 0u : (v << ((neg < 15 ? neg : 15) << 1));
}

__device__ unsigned word16_w(const Read& R, int base) {
  int b = base > 0 ? base : 0;
  int w0 = b >> 4, sh = (b & 15) << 1;
  unsigned g0 = R.wj[clampi(w0, 0, 127)];
  unsigned g1 = R.wj[clampi(w0 + 1, 0, 127)];
  unsigned v = sh == 0 ? g0 : ((g0 >> sh) | (g1 << (32 - sh)));
  if (base >= 0) return v;
  int neg = clampi(w32(-(long long)base), 0, 16);
  return neg >= 16 ? 0u : (v << ((neg < 15 ? neg : 15) << 1));
}

// Match-run length: read char qstart +- k vs window char wstart +- k,
// k < cap (rescore_pl._run_len_lanes for one candidate).
__device__ int run_len(const Read& R, int win_len, int qstart, int wstart,
                       bool forward, int cap) {
  int n = 0;
  bool run = cap > 0;
  while (run) {
    int qi = forward ? w32((long long)qstart + n) : w32((long long)qstart - n);
    int wi = forward ? w32((long long)wstart + n) : w32((long long)wstart - n);
    unsigned qw = word16_q(R, forward ? qi : w32((long long)qi - 15));
    unsigned ww = word16_w(R, forward ? wi : w32((long long)wi - 15));
    unsigned y = qw ^ ww;
    y = (y | (y >> 1)) & 0x55555555u;
    int m, q_rem, w_rem;
    if (forward) {
      unsigned t = (y & (~y + 1u)) - 1u;
      m = __popc(t & 0x55555555u);
      q_rem = qi >= 0 ? R.buf_len - qi : 0;
      w_rem = wi >= 0 ? win_len - wi : 0;
    } else {
      unsigned s = y | (y >> 2);
      s |= s >> 4;
      s |= s >> 8;
      s |= s >> 16;
      m = 16 - __popc(s & 0x55555555u);
      q_rem = qi < R.buf_len ? (1 << 30) : 0;
      w_rem = wi < win_len ? wi + 1 : 0;
    }
    int lim = min(min(q_rem, w_rem), cap - n);
    lim = lim > 0 ? lim : 0;
    int adv = min(m, min(lim, 16));
    n += adv;
    run = adv == 16 && n < cap;
  }
  return min(n, cap > 0 ? cap : 0);
}

// ---- window fetch ---------------------------------------------------------
// 128 words (2048 chars) of reference from char goff (clamped at 0); chars
// past n_bases replicate the last char, window chars >= bug_zero read 0.
__device__ void fetch_window(Read& R, int goff, int bug_zero) {
  const Params* P = R.P;
  int off0 = goff > 0 ? goff : 0;
  int gw0 = off0 >> 4, cb = off0 & 15;
  int r0 = clampi(gw0 >> 7, 0, P->NR - 2);
  int o = gw0 & 127;
  long long at = (long long)r0 * 128 + o;
  int base_g = w32(at * 16);
  unsigned rep = (unsigned)P->last_char * 0x55555555u;
  int bz = w32((long long)bug_zero + cb);
  unsigned first = 0, prev = 0;
  for (int l = 0; l < 128; ++l) {
    unsigned v = P->ref_words[at + l];
    int nv = clampi(w32((long long)P->n_bases - w32((long long)base_g + 16 * l)),
                    0, 16);
    unsigned keep = nv >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nv)) - 1u);
    v = (v & keep) | (rep & ~keep);
    int nz = clampi(w32((long long)bz - 16 * l), 0, 16);
    v &= nz >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nz)) - 1u);
    if (l == 0) {
      first = v;
    } else if (cb == 0) {
      R.wj[l - 1] = prev;
    } else {
      R.wj[l - 1] = (prev >> (2 * cb)) | (v << (32 - 2 * cb));
    }
    prev = v;
  }
  R.wj[127] = cb == 0 ? prev : ((prev >> (2 * cb)) | (first << (32 - 2 * cb)));
}

// ---- sdp_match --------------------------------------------------------------
// Append the window's match nodes to sms from slot base_slot; returns the
// number emitted and ORs the FB_HITS/FB_FCAP/FB_SMS reasons into fb.
__device__ int sdp_match(Read& R, bool forward, int t_len, int t0j, int q_bg,
                         int q_ed, int t_st, int dslot, int base_slot,
                         bool is_mid, int& fb) {
  int t_kmer_num = w32((long long)t_len - K9 + 1);
  int qbase = dslot == 1 ? 0 : R.l_read;
  int phi = forward ? 0 : ((t0j + t_kmer_num - 1) & 3);
  int rkn = R.l_read >= K9 ? R.l_read - K9 + 1 : 0;
  const int* vals = R.rkv + (long long)dslot * R.P->K;
  const int* pos = R.rkp + (long long)dslot * R.P->K;
  bool qf = ule(q_bg, q_ed);
  int total_cand = 0, lead_cnt = 0, n_new = 0;
  bool hits_over = false;
  if (t_kmer_num > 4) {
    for (int i = 4; i < t_kmer_num; i += 4) {
      int j = forward ? i + t0j : t0j + t_kmer_num - 1 - i;
      if (j - phi < 0 || j - phi > 4 * 511) continue;
      int pv = 0;
      for (int k = 0; k < K9; ++k) {
        int x = j + k;
        pv = (pv << 2) | (int)((R.wj[(x >> 4) & 127] >> ((x & 15) << 1)) & 3u);
      }
      int lo = 0, hi = rkn;
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (vals[mid] < pv) lo = mid + 1; else hi = mid;
      }
      int cnt = 0;
      while (cnt <= H_CAP && lo + cnt < rkn && vals[lo + cnt] == pv) ++cnt;
      hits_over |= cnt > H_CAP;
      int tpos = j - t0j;
      int nh = cnt < H_CAP ? cnt : H_CAP;
      for (int h = 0; h < nh; ++h) {
        int qpos = pos[lo + h];
        if (!(qf && ule(q_bg, qpos))) continue;
        int c = total_cand++;
        if (c >= NCAND) continue;
        int wl = 0, shrt;
        if (forward) {
          wl = t_len + (is_mid ? 0 : OVER);
          shrt = run_len(R, wl, qbase + qpos - 1, t0j + tpos - 1, false, 4);
        } else {
          shrt = run_len(R, t0j + t_len, qbase + qpos + K9, t0j + tpos + K9,
                         true, 4);
        }
        if (!(shrt < 4 || i == 4)) continue;
        ++lead_cnt;
        int back, fwd;
        if (forward) {
          int ms_u = w32((long long)q_ed - qpos - 1);
          int b_u = w32((long long)t_len - tpos - 1);
          int cap = w32((long long)(ult(ms_u, b_u) ? ms_u : b_u) + OVER);
          int longr = run_len(R, wl, qbase + qpos + K9, t0j + tpos + K9, true,
                              cap);
          back = shrt;
          fwd = longr;
        } else {
          int cap = min(qpos, tpos) + OVER;
          int longr = run_len(R, t0j + t_len, qbase + qpos - 1,
                              t0j + tpos - 1, false, cap);
          back = longr;
          fwd = shrt;
        }
        int total = back + fwd + 1;
        if (total >= 4) {
          sms_set(R, base_slot + n_new, w32((long long)qpos - back),
                  w32((long long)tpos - back + t_st), total, 0);
          ++n_new;
        }
      }
    }
  }
  if (hits_over) fb |= FB_HITS;
  if (total_cand > CF_CAP || lead_cnt > F_CAP) fb |= FB_FCAP;
  if (base_slot + n_new + 1 > S_CAP) fb |= FB_SMS;
  return n_new;
}

// ---- node DP (one node against all prior slots) ---------------------------
__device__ int node_dp(Read& R, int cur, bool is_left, bool is_mid) {
  int cq = sms_get(R, 0, cur), ct = sms_get(R, 1, cur);
  int cln = sms_get(R, 2, cur);
  int best = NEG_INF;
  int max_q = 0, max_t = 0, min_q = 0, min_t = 0;
  if (!is_left) {
    max_q = w32((long long)cq + 6);
    max_t = w32((long long)ct + 6);
  } else {
    min_q = w32((long long)cq + cln - 6 + K9 - 1);
    min_t = w32((long long)ct + cln - 6 + K9 - 1);
  }
  for (int s = (cur < S_CAP ? cur : S_CAP) - 1; s >= 0; --s) {
    int pq = R.sms[0][s], pt = R.sms[1][s], plen = R.sms[2][s];
    int psc = R.sms[3][s];
    bool ok, brk;
    int indel, pen;
    if (!is_left) {
      int pqe = w32((long long)pq + plen + K9 - 1);
      int pte = w32((long long)pt + plen + K9 - 1);
      ok = ule(pqe, max_q) && ule(pte, max_t);
      brk = ult(w32((long long)pt + 600), max_t);
      indel = w32((long long)pq - pt - w32((long long)max_q - max_t));
      pen = (ult(cq, pqe) || ult(ct, pte))
                ? max(w32((long long)pqe - cq), w32((long long)pte - ct)) : 0;
    } else {
      ok = ule(min_q, pq) && ule(min_t, pt);
      brk = ult(w32((long long)min_t + 600), pt);
      indel = w32((long long)pq - pt - w32((long long)min_q - min_t));
      int mq6 = w32((long long)min_q + 6), mt6 = w32((long long)min_t + 6);
      pen = (ult(pq, mq6) || ult(pt, mt6))
                ? max(w32((long long)mq6 - pq), w32((long long)mt6 - pt)) : 0;
    }
    if (brk && !is_mid) break;
    if (ok && iabs(indel) <= 200) {
      int nw = w32((long long)psc + cln - (iabs(indel) >> 3) - pen);
      best = max(best, nw);
    }
  }
  int node_max = max(cln, best);
  if (cur >= 0 && cur < S_CAP) R.sms[3][cur] = node_max;
  return node_max;
}

// ---- middle walk ------------------------------------------------------------
// Returns the walk score (+10000 domain); updates fb and steps.
__device__ int run_middle(Read& R, int a, int dslot, int t_glob, int& fb,
                          int& steps) {
  int score = 10000;
  while (a >= 0 && fb == 0 && steps < MAX_STEPS) {
    int pre = anc_f(R, a, 3);
    int cur_q = anc_f(R, a, 0), cur_t = anc_f(R, a, 1), cur_m = anc_f(R, a, 2);
    if (pre < 0) {
      score = w32((long long)score + cur_m - K9 + 1);
      steps += 1;
    } else {
      int pre_q = anc_f(R, pre, 0), pre_t = anc_f(R, pre, 1);
      int pre_m = anc_f(R, pre, 2);
      int pre_roff3 = w32((long long)pre_t - 3);
      int trl = w32((long long)cur_t - w32((long long)pre_roff3 + pre_m) + 3);
      if (trl > 12 && trl > W_CAP) fb |= FB_MIDW;
      sms_set(R, 0, pre_q, pre_t, w32((long long)pre_m - K9 + 1), score);
      int n_new = 0;
      if (trl > 12 && fb == 0) {
        int t_st = w32((long long)pre_roff3 + pre_m);
        fetch_window(R, w32((long long)t_st + t_glob), 1 << 20);
        n_new = sdp_match(R, true, trl, 0, w32((long long)pre_q + pre_m - 8),
                          w32((long long)cur_q - 1), t_st, dslot, 1, true, fb);
      }
      sms_set(R, clampi(1 + n_new, 0, S_CAP - 1), cur_q, cur_t,
              w32((long long)cur_m - K9 + 1), 0);
      int n_sms = min(2 + n_new, S_CAP);
      for (int si = 1; si < n_sms; ++si)
        score = max(score, node_dp(R, si, false, true));
      steps += n_sms;
    }
    a = pre;
  }
  return score;
}

// ---- side extension ---------------------------------------------------------
__device__ int run_side(Read& R, bool is_left, int ci, int dslot, int t_glob,
                        int t_length, int score_in, int& fb, int& steps) {
  int* c = R.chw[ci];
  int q_anchor = is_left ? c[C_QST] : c[C_QED];
  int t_anchor = is_left ? c[C_TST] : c[C_TED];
  sms_set(R, 0, q_anchor, t_anchor, is_left ? 0 : 1 - K9, score_in);
  int n = 1, cur = 1, max_id = 0, total = score_in, so = score_in;
  int cto = is_left ? w32((long long)t_anchor + 3) : w32((long long)t_anchor - 3);
  int ls = 0, done = 0;
  while (done == 0 && fb == 0 && steps < MAX_STEPS) {
    if (cur == n) {
      int best_q = sms_get(R, 0, max_id);
      int q_st_c = c[C_QST], q_ed_c = c[C_QED];
      bool brk, nearb;
      int msr_raw;
      if (is_left) {
        brk = ult(cto, MIN_SCORE_MEM);
        nearb = ult(q_st_c, 600);
        msr_raw = nearb ? w32((long long)q_st_c + 60) : cto;
      } else {
        brk = ult(w32((long long)t_length - cto), MIN_SCORE_MEM);
        nearb = w32((long long)R.l_read - q_ed_c) < 600;
        msr_raw = nearb ? w32((long long)R.l_read - q_ed_c + 60)
                        : w32((long long)t_length - cto);
      }
      brk = brk || (nearb && ls != 0);
      ls |= nearb ? 1 : 0;
      int msr = ult(600, msr_raw) ? 600 : msr_raw;
      bool fwrap = !brk && cto < 0;
      if (fwrap) fb |= FB_WRAP;
      if (brk || fwrap) {
        done = 1;
        steps += 1;
        continue;
      }
      int goff, bugz, t0j, t_st;
      if (is_left) {
        bool bug = t_glob == 0 && cto < OVER + msr;
        goff = w32((long long)cto + t_glob - msr - (bug ? 0 : OVER));
        bugz = bug ? msr : (1 << 20);
        t0j = OVER;
        t_st = w32((long long)cto - msr);
      } else {
        goff = w32((long long)cto + t_glob);
        bugz = 1 << 20;
        t0j = 0;
        t_st = cto;
      }
      fetch_window(R, goff, bugz);
      int q_bg, q_ed;
      if (is_left) {
        int sqs = w32((long long)best_q - 1000);
        sqs = sqs > 0 ? sqs : 0;
        q_bg = sqs;
        int a_u = w32((long long)sqs + 2000), b_u = w32((long long)q_st_c - 1);
        q_ed = ult(a_u, b_u) ? a_u : b_u;
      } else {
        int sqe = min(w32((long long)best_q + 1000), R.l_read);
        int a_u = w32((long long)sqe - 2000), b_u = w32((long long)q_st_c - 8);
        q_bg = ult(b_u, a_u) ? a_u : b_u;
        q_ed = sqe;
      }
      int n_new = sdp_match(R, !is_left, msr, t0j, q_bg, q_ed, t_st, dslot, n,
                            false, fb);
      cto = is_left ? w32((long long)cto - (msr - K9 - 3))
                    : w32((long long)cto + msr - K9 - 3);
      int first_t = sms_get(R, 1, clampi(cur, 0, S_CAP - 1));
      int best_t = sms_get(R, 1, max_id);
      bool far = is_left ? ult(w32((long long)first_t + 1000), best_t)
                         : ult(w32((long long)best_t + 1000), first_t);
      n += n_new;
      done = (n_new == 0 || far) ? 1 : 0;
      steps += 1;
      continue;
    }
    int node_max = node_dp(R, cur, is_left, false);
    int cq = sms_get(R, 0, cur), ct = sms_get(R, 1, cur);
    int cln = sms_get(R, 2, cur);
    int dis = w32((long long)ct - cq);
    int c_q_pos = is_left ? w32((long long)cq + cln) : cq;
    int first_e = -1;
    if (cln >= 8) {
      int ne = R.n_hash < HASH_CAP ? R.n_hash : HASH_CAP;
      for (int e = 0; e < ne; ++e) {
        int dis_con, q_pos_con, soe_want;
        if (is_left) {
          dis_con = w32((long long)R.hashv[6][e] - R.hashv[5][e]);
          q_pos_con = w32((long long)R.hashv[5][e] - K9);
          soe_want = 1;
        } else {
          dis_con = w32((long long)R.hashv[4][e] - R.hashv[3][e]);
          q_pos_con = R.hashv[3][e];
          soe_want = 0;
        }
        if (R.hashv[0][e] == (dis & 0xFF) && dis == dis_con &&
            R.hashv[1][e] != ci && R.hashv[2][e] != soe_want &&
            iabs(w32((long long)c_q_pos - q_pos_con)) < 8 &&
            R.hashv[7][e] == c[C_REF] && R.hashv[8][e] == c[C_DIR] &&
            R.hashv[9][e] != 0 && R.hashv[1][e] > ci) {
          first_e = e;
          break;
        }
      }
    }
    if (first_e >= 0) {
      int* a_ = R.chw[clampi(R.hashv[1][first_e], 0, C_CAP - 1)];
      c[C_SUM] = w32((long long)c[C_SUM] + a_[C_SUM]);
      c[C_ANUM] = w32((long long)c[C_ANUM] + a_[C_ANUM]);
      c[C_INDEL] = w32((long long)c[C_INDEL] + a_[C_INDEL]);
      c[C_QST] = min(c[C_QST], a_[C_QST]);
      c[C_TST] = min(c[C_TST], a_[C_TST]);
      c[C_QED] = max(c[C_QED], a_[C_QED]);
      c[C_TED] = max(c[C_TED], a_[C_TED]);
      int absorbed_cur = a_[C_CUR];
      a_[C_SUM] = a_[C_TST] = a_[C_TED] = a_[C_QST] = a_[C_QED] = 0;
      build_hashv(R);
      steps += 1;
      int mid_sc = run_middle(R, absorbed_cur, dslot, t_glob, fb, steps);
      total = w32((long long)max(so, node_max) - cln + mid_sc - 10000);
      int q_a2 = is_left ? c[C_QST] : c[C_QED];
      int t_a2 = is_left ? c[C_TST] : c[C_TED];
      sms_set(R, 0, q_a2, t_a2, is_left ? 0 : -K9, total);
      n = 1;
      cur = 1;
      max_id = 0;
      so = total;
      cto = t_a2;
      done = 0;
    } else {
      int cur2 = cur + 1;
      if (total < node_max) {
        total = node_max;
        max_id = cur2 - 1;
      }
      int best_t = sms_get(R, 1, max_id);
      bool brk2 = is_left ? ult(w32((long long)ct + 1000), best_t)
                          : ult(w32((long long)best_t + 1000), ct);
      cur = cur2;
      done = brk2 ? 1 : 0;
      steps += 1;
    }
  }
  if (steps >= MAX_STEPS) fb |= FB_OVER;
  int mid = clampi(max_id, 0, S_CAP - 1);
  int bq = R.sms[0][mid], bt = R.sms[1][mid], bl = R.sms[2][mid];
  if (is_left) {
    c[C_QST] = bq;
    c[C_TST] = bt;
    c[C_SUM] = w32((long long)total - 10000);
  } else {
    c[C_QED] = w32((long long)bq + bl + K9);
    c[C_TED] = w32((long long)bt + bl + K9);
  }
  return total;
}

__global__ void __launch_bounds__(32) rescore_kernel(Params P) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  Read R;
  R.P = &P;
  const int* s = P.scal + b * 4;
  R.n_chains = s[0];
  R.n_hash = s[1];
  R.l_read = s[2];
  R.buf_len = s[3];
  R.kw = ((P.nw + 127) / 128) * 128;
  R.anc = P.anchors + (long long)b * P.A2 * 4;
  R.sch = P.schash + (long long)b * HASH_CAP * 3;
  R.cpk = P.codes_pk + (long long)b * P.nw;
  R.rkv = P.rk_vals + (long long)b * 2 * P.K;
  R.rkp = P.rk_pos + (long long)b * 2 * P.K;
  for (int c = 0; c < C_CAP; ++c)
    for (int f = 0; f < CF_N; ++f)
      R.chw[c][f] = P.chains[((long long)b * C_CAP + c) * CF_N + f];
  for (int r = 0; r < 4; ++r)
    for (int k = 0; k < S_CAP; ++k) R.sms[r][k] = 0;

  int rcap = ((P.nref + 127) / 128) * 128;
  int ci_prev = -1, fb = 0, steps = 0;
  while (fb == 0 && steps < MAX_STEPS && ci_prev < R.n_chains) {
    int pick = C_CAP;
    for (int cc = 0; cc < C_CAP; ++cc) {
      if (cc > ci_prev && cc < R.n_chains && R.chw[cc][C_SUM] != 0) {
        pick = cc;
        break;
      }
    }
    if (pick >= C_CAP) {
      ci_prev = C_CAP;
      continue;
    }
    int ci = pick;
    int dslot = clampi(R.chw[ci][C_DIR], 0, 1);
    int refc = clampi(R.chw[ci][C_REF], 0, rcap - 1);
    int t_glob = refc < P.nref ? P.ref_off[refc] : 0;
    int t_length = refc < P.nref ? P.ref_len[refc] : 0;
    build_hashv(R);
    int sc = run_middle(R, R.chw[ci][C_CUR], dslot, t_glob, fb, steps);
    sc = run_side(R, false, ci, dslot, t_glob, t_length, sc, fb, steps);
    sc = run_side(R, true, ci, dslot, t_glob, t_length, sc, fb, steps);
    ci_prev = ci;
  }
  for (int c = 0; c < C_CAP; ++c)
    for (int f = 0; f < CF_N; ++f)
      P.chains_out[((long long)b * C_CAP + c) * CF_N + f] = R.chw[c][f];
  P.flags[b * 3 + 0] = fb != 0 ? 1 : 0;
  P.flags[b * 3 + 1] = fb;
  P.flags[b * 3 + 2] = steps;
}

extern "C" int rescore_launch(
    const int* scal, const int* chains, const int* anchors, const int* schash,
    const unsigned* codes_pk, const int* rk_vals, const int* rk_pos,
    const unsigned* ref_words, const int* ref_off, const int* ref_len,
    int* chains_out, int* flags, int B, int A2, int nw, int K, int NR,
    int nref, int n_bases, int last_char, void* stream) {
  Params P{scal, chains, anchors, schash, codes_pk, rk_vals, rk_pos,
           ref_words, ref_off, ref_len, chains_out, flags,
           B, A2, nw, K, NR, nref, n_bases, last_char};
  if (B <= 0) return 0;
  const int threads = 32;
  rescore_kernel<<<(B + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
