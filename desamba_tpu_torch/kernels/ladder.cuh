// The classify ladders' device functions, one lane a thread (src/cly.c
// bwt_MEM_search, map_seed and their helpers).
//
// Each function here is the per-lane body of the port's function of the
// same name (desamba_tpu_torch/engine/device/): lv (lv.lv_batch),
// lce_backward, collect_backward, find_bit_low, find_bit_high and
// ivset_walk (textwalk.py), interval_sa, interval_rank_chase and mem_probe
// (fm.py), get_uni, get_ref13, get_new_ed and map_seed (mapseed.py). The
// port runs them as lockstep (N,) tensor loops; here one thread runs one
// lane's loop to its end, so every `while bool(run.any())` becomes a plain
// loop on the lane's own condition. The arithmetic is the port's, step for
// step: int where the port holds int32, uint32_t exactly where it goes
// through intops.u32 / M32 (the FM intervals, the hash13 bucket, the
// rank words, the suffix length), JAX's clamping gathers (take) and the
// port's explicit clamps where each stands.
//
// One rule differs, and only in which path computes a result: the port's
// mem_probe sends a lane to the rank chase when the batch's running sum of
// bucket rows passes the shared SA pool (2 N rows); a thread has its own
// SA_CAP-row buffer, so every bucket of at most SA_CAP rows takes the
// position-space path here. Both paths give the same rows in the same
// order (tests/test_torch_ladder_kernel.py holds it on a lane set that
// overflows the pool).
//
// The SP_SET of a lane lives in device memory (iv_cap intervals); only its
// first min(niv, iv_cap) slots can be non-empty (every write goes to slot
// min(niv, iv_cap - 1) and a reset sets niv to 0), so the covered-point
// scans read those and a reset only zeroes the counts: the same answers as
// the port's scans over all iv_cap slots of a cleared set. The hot-tier
// overflow (slot iv_cap - 1 overwritten, the sticky bit set) is the port's.
//
// Header only: kernels/ladder.cu holds the kernels and the launcher; a
// later ladder kernel includes this file too. It compiles as host C++ over
// tests/cuda_host/block_emu.h, which is how the CPU tests run it.
#pragma once
#include <cstdint>

namespace lad {

// constants of desamba_tpu_torch/constants.py and the port's modules
constexpr int L_PRE_IDX = 13;
constexpr int PRE_IDX_MASK = 0x3FFFFFF;
constexpr int SA_MASK = 0x7;
constexpr int MIN_UNI_L = 35;
constexpr int MEM_SEARCH_FAST = 2;
constexpr int MIN_MEM_LEN_FAST = 21;
constexpr int SP_SET_CAP = 500;
constexpr int LV_ERROR = 4;
constexpr int LV_L = 12;
constexpr int W13 = LV_L + 1;     // a window's chars
constexpr int MIN_S_1 = 12;
constexpr int MIN_S_2 = 20;
constexpr int SA_CAP = 16;        // fm.SA_CAP
constexpr int BIG = 1 << 30;      // fm.BIG
constexpr int GARBAGE = 200;      // mapseed.GARBAGE
constexpr int A_NF = 12;          // mapseed.A_NF

// Everything a ladder launch reads and writes. Pointers first, then ints;
// desamba_tpu_torch/engine/device/ladder.py mirrors it field for field
// (LadderArgs) and checks the size against ladder_args_size(). uint32
// tables are the DeviceIndex's int32 bit patterns.
struct LadderArgs {
  const uint32_t* fm_blocks;      // (n_blocks, 9)
  const uint32_t* rank6;          // (6,)
  const uint32_t* hash13;         // (n_hash13,)
  const int* row_pos;             // (n_row_pos,)
  const int* isa;                 // (n_text,)
  const uint32_t* text_pk;        // (n_text_pk,) 16 chars a word
  const uint32_t* sep_any;        // bitmaps, 32 positions a word
  const uint32_t* sep_hash;
  const uint32_t* samp_bits;
  const int* uni_start;           // (n_uni_tab,)
  const int* uni_len;
  const int* uni_ref_list;
  const int* rp_global_off;       // (n_rp,)
  const int* rp_ref_id;
  const int* ref_off;             // (n_ref,)
  const uint32_t* ref_pk;         // (n_ref_pk,)
  const int* pos2uni;             // (text_len,)
  const int* q_mem;               // (n_q_mem,)
  const int* q_lv;                // (q_lv_rows, q_lv_cols)
  const uint8_t* codes;           // (n_reads, codes_w) read codes, 0..3
  const uint32_t* codes_pk;       // (n_reads, codes_pk_w) packed
  const int* buf_len;             // (n_reads,)
  const int* pre13;               // (n_reads, pre13_w)
  const int* lane_args;           // (8, nb)
  int* anchors;                   // (nb, a_cap, A_NF) out
  int* a_cnt;                     // (nb,) out: anchors emitted
  int* skip;                      // (nb,) out: max score > 512 seen
  int* iv_ovf;                    // (nb,) out: SP_SET hot tier overflowed
  int* trips;                     // (nb,) out: the lane's ladder trips
  int* iv;                        // (nb, iv_cap, 2) scratch: the SP_SETs
  int n_blocks, n_hash13, n_row_pos, n_text, n_text_pk, n_sep_any,
      n_sep_hash, n_samp, n_uni_tab, n_rp, n_ref, n_ref_pk, n_q_mem,
      q_lv_rows, q_lv_cols, text_len, n_uni, n_bases, codes_w, codes_pk_w,
      pre13_w, nb, l_ek, a_cap, iv_cap;
};

// ---- integer helpers ---------------------------------------------------------
#ifdef __CUDA_ARCH__
__device__ inline int popc32(uint32_t x) { return __popc(x); }
__device__ inline int clz32(uint32_t x) { return __clz(x); }
#else
__host__ __device__ inline int popc32(uint32_t x) {
  return __builtin_popcount(x);
}
__host__ __device__ inline int clz32(uint32_t x) {
  return x ? __builtin_clz(x) : 32;
}
#endif
// trailing zeros, 32 for 0 (intops.popc of (low - 1))
__device__ inline int ctz32(uint32_t x) { return popc32((x & (0u - x)) - 1u); }
__device__ inline int imin(int a, int b) { return a < b ? a : b; }
__device__ inline int imax(int a, int b) { return a > b ? a : b; }
__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ inline uint32_t umin(uint32_t a, uint32_t b) { return a < b ? a : b; }
// JAX's gather index (intops.take): a negative index wraps once, then clamps
__device__ inline int take_i(int i, int n) {
  return clampi(i < 0 ? i + n : i, 0, n - 1);
}
// Python's i % n for n > 0
__device__ inline int pymod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}
__device__ inline int q_lv_at(const LadderArgs& A, int e, int l) {
  return A.q_lv[take_i(e, A.q_lv_rows) * A.q_lv_cols + take_i(l, A.q_lv_cols)];
}

// ---- lv.py -------------------------------------------------------------------
// Landau-Vishkin edit distance of two 13-char windows over their first
// `length` (0..12) chars: lv_batch's 35-step DP for one lane, the match
// run along each diagonal as trailing ones of a 14-bit agreement mask.
__device__ inline int lv(const uint8_t* ref, const uint8_t* qry, int length) {
  constexpr int OFF = LV_ERROR + 1;
  int rp[14], qp[14];
  for (int m = 0; m < 14; ++m) {
    rp[m] = m == length ? 254 : (m < W13 ? ref[m] : 0);
    qp[m] = m == length ? 255 : (m < W13 ? qry[m] : 0);
  }
  uint32_t masks[2 * LV_ERROR + 1];
  for (int d = -LV_ERROR; d <= LV_ERROR; ++d) {
    uint32_t mk = 0;
    for (int m = 0; m < 14; ++m) {
      const int mr = m + d;
      if (m <= length && mr >= 0 && mr <= length && rp[mr] == qp[m])
        mk |= 1u << m;
    }
    masks[d + LV_ERROR] = mk;
  }
  int mn[2 * OFF + 3], ed[2 * OFF + 3];
  for (int k = 0; k < 2 * OFF + 1; ++k) {
    mn[k] = -1;
    ed[k] = k < OFF ? OFF - k : k - OFF;
  }
  mn[2 * OFF + 1] = mn[2 * OFF + 2] = ed[2 * OFF + 1] = ed[2 * OFF + 2] = 0;
  int best = length;
  for (int i = 0; i <= LV_ERROR; ++i) {
    int prev_mn = -1, cur_mn = i - 1, next_mn = mn[OFF - i + 1];
    int prev_ed = i + 1, cur_ed = i, next_ed = ed[OFF - i + 1];
    for (int j = -i; j <= LV_ERROR; ++j) {
      const bool take_ext = cur_mn + j < length - 1;
      int a_mn = cur_mn + 1, a_ed = cur_ed + 1, a_max = cur_mn + 1 - cur_ed;
      if (a_max < next_mn + 1 - next_ed) {
        a_mn = next_mn + 1;
        a_ed = next_ed + 1;
        a_max = next_mn - next_ed;
      }
      if (a_max < prev_mn - prev_ed) {
        a_mn = prev_mn + 1;
        a_ed = prev_ed + 1;
      }
      int b_mn = cur_mn, b_ed = cur_ed + 1, b_max = cur_mn - cur_ed;
      if (b_max < prev_mn - prev_ed) {
        b_mn = prev_mn;
        b_ed = prev_ed + 1;
        b_max = prev_mn - prev_ed;
      }
      if (b_max < next_mn + 1 - next_ed) {
        b_mn = next_mn + 1;
        b_ed = next_ed + 1;
      }
      int new_mn = take_ext ? a_mn : b_mn;
      const int new_ed = take_ext ? a_ed : b_ed;
      new_mn = imin(imin(new_mn, length), length - j);
      const uint32_t mk = masks[j + LV_ERROR];
      const int run = ctz32(~(mk >> clampi(new_mn, 0, 31)));
      new_mn += new_mn >= 0 ? run : 0;
      if (new_mn == length || new_mn + j == length) {
        best = imin(new_ed - 1, best);
        // done: nothing after this step changes best
        if (j <= i + 1) return best;
      }
      mn[OFF + j] = new_mn;
      ed[OFF + j] = new_ed;
      prev_mn = cur_mn;
      cur_mn = next_mn;
      next_mn = mn[OFF + j + 2];
      prev_ed = cur_ed;
      cur_ed = next_ed;
      next_ed = ed[OFF + j + 2];
    }
  }
  return best;
}

// ---- textwalk.py -------------------------------------------------------------
__device__ inline uint32_t funnel(uint32_t g0, uint32_t g1, int sh) {
  return sh == 0 ? g0 : (g0 >> sh) | (g1 << (32 - sh));
}

// 16 chars of a packed row from char `base` on (chars below 0 read as 0)
__device__ inline uint32_t word16(const uint32_t* pk, int kw, int base) {
  const int b = imax(base, 0);
  const int w0 = b >> 4;
  const uint32_t v = funnel(pk[clampi(w0, 0, kw - 1)],
                            pk[clampi(w0 + 1, 0, kw - 1)], (b & 15) << 1);
  return base < 0 ? v << (imin(-base, 15) << 1) : v;
}

// 16 bitmap bits for positions [lo, lo + 15], LSB = position lo
__device__ inline uint32_t bits16(const uint32_t* bits, int nw, int lo) {
  const int b = imax(lo, 0);
  const int w0 = b >> 5;
  uint32_t v = funnel(bits[clampi(w0, 0, nw - 1)],
                      bits[clampi(w0 + 1, 0, nw - 1)], b & 31);
  if (lo < 0) v <<= imin(-lo, 16);
  return v & 0xFFFFu;
}

__device__ inline uint32_t spread16(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// Backward match run: read chars qrow[col_off + q_hi - k] against text
// chars t_hi - k, k = 0.., up to the first mismatch, text separator, start
// of either, or cap.
__device__ inline int lce_backward(const LadderArgs& A, const uint32_t* qrow,
                                   int col_off, int q_hi, int t_hi, int cap) {
  int n = 0;
  bool run = cap > 0;
  while (run) {
    const int qi = col_off + q_hi - n;
    const int ti = t_hi - n;
    uint32_t y = word16(qrow, A.codes_pk_w, qi - 15) ^
                 word16(A.text_pk, A.n_text_pk, ti - 15);
    y = (y | (y >> 1)) & 0x55555555u;
    y |= spread16(bits16(A.sep_any, A.n_sep_any, ti - 15));
    uint32_t s = y | (y >> 2);
    s |= s >> 4;
    s |= s >> 8;
    s |= s >> 16;
    const int m = 16 - popc32(s & 0x55555555u);
    const int lim =
        imax(imin(imin(imax(q_hi - n + 1, 0), imax(ti + 1, 0)), cap - n), 0);
    const int adv = imin(m, imin(lim, 16));
    n += adv;
    run = adv == 16 && n < cap;
  }
  return n;
}

// text[t_hi], text[t_hi - 1], ... (13 chars); separators and positions
// below 0 as 4
__device__ inline void collect_backward(const LadderArgs& A, int t_hi,
                                        uint8_t* out) {
  const uint32_t tw = word16(A.text_pk, A.n_text_pk, t_hi - 15);
  const uint32_t sep = bits16(A.sep_any, A.n_sep_any, t_hi - 15);
  for (int k = 0; k < W13; ++k) {
    const bool bad = ((sep >> (15 - k)) & 1u) || t_hi - k < 0;
    out[k] = bad ? 4 : (uint8_t)((tw >> ((15 - k) * 2)) & 3u);
  }
}

__device__ inline uint32_t range_masks(uint32_t word, int lo, int hi,
                                       int base) {
  const int b_lo = clampi(lo - base, 0, 32);
  const int b_hi = clampi(hi - base, -1, 31);
  const uint32_t m_lo = b_lo >= 32 ? 0u : 0xFFFFFFFFu << b_lo;
  const uint32_t m_hi =
      b_hi < 0 ? 0u : (b_hi >= 31 ? 0xFFFFFFFFu : (1u << (b_hi + 1)) - 1u);
  return word & m_lo & m_hi;
}

// Smallest position q in [lo, hi] with its bit set: found, q (0 if not)
__device__ inline bool find_bit_low(const uint32_t* bits, int nw, int lo,
                                    int hi, int& q) {
  q = 0;
  if (!(hi >= lo && hi >= 0)) return false;
  int w = imax(lo, 0) >> 5;
  const int w_hi = imax(hi, 0) >> 5;
  for (;;) {
    const int base = w << 5;
    const uint32_t m = range_masks(bits[clampi(w, 0, nw - 1)], lo, hi, base);
    if (m != 0) {
      q = base + ctz32(m);
      return true;
    }
    if (!(w < w_hi)) return false;
    ++w;
  }
}

// Largest position q in [lo, hi] with its bit set: found, q (0 if not)
__device__ inline bool find_bit_high(const uint32_t* bits, int nw, int lo,
                                     int hi, int& q) {
  q = 0;
  if (!(hi >= lo && hi >= 0)) return false;
  int w = imax(hi, 0) >> 5;
  const int w_lo = imax(lo, 0) >> 5;
  for (;;) {
    const int base = w << 5;
    const uint32_t m = range_masks(bits[clampi(w, 0, nw - 1)], lo, hi, base);
    if (m != 0) {
      q = base + 31 - clz32(m);
      return true;
    }
    if (!(w > w_lo)) return false;
    --w;
  }
}

// A lane's SP_SET: disjoint position intervals [lo, hi] in iv (cap slots)
// and the counts [intervals used, positions, overflowed].
struct IvSet {
  int* iv;
  int cap;
  int niv, size, ovf;
};

// The reference's insert sequence for one row walk (textwalk.ivset_walk)
// at position p with natural walk length nat. Returns dup0 (p already
// covered: no walk); sets abort (the walk met an earlier one) and wlen.
__device__ inline bool ivset_walk(IvSet& S, int p, int nat, bool& abort,
                                  int& wlen) {
  if (S.size == SP_SET_CAP) S.niv = S.size = 0;         // reset0
  const int used = imin(S.niv, S.cap);
  int qd = -1;
  const int a = p - nat, b = p - 1;
  for (int k = 0; k < used; ++k) {
    const int lo = S.iv[2 * k], hi = S.iv[2 * k + 1];
    if (lo <= p && p <= hi) {
      abort = false;
      wlen = nat;
      return true;
    }
    const int c = imin(hi, b);
    if (c >= lo && c >= a) qd = imax(qd, c);
  }
  const int s1 = S.size + 1;
  const int j_r = SP_SET_CAP + 1 - s1;
  const int j_dup = p - qd;
  abort = qd >= 0 && j_dup < j_r && nat > 0;
  wlen = abort ? j_dup - 1 : nat;
  const bool midreset = !abort && nat >= j_r;
  const int slot = midreset ? 0 : imin(S.niv, S.cap - 1);
  S.iv[2 * slot] = midreset ? p - nat : p - wlen;
  S.iv[2 * slot + 1] = midreset ? p - j_r : p;
  if (!midreset && S.niv >= S.cap) S.ovf = 1;
  S.niv = midreset ? 1 : S.niv + 1;
  S.size = midreset ? nat - j_r + 1 : s1 + wlen;
  return false;
}

// ---- fm.py -------------------------------------------------------------------
// occ(c, r): the count of char c in rows [0, r), from the rank checkpoints
__device__ inline uint32_t rank_from_blocks(const LadderArgs& A, int r, int c) {
  const uint32_t* got = A.fm_blocks + 9 * take_i(r >> 5, A.n_blocks);
  const int within = r & 31;
  const uint32_t cm = (uint32_t)c * 0x11111111u;
  uint32_t sum = 0;
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = got[5 + i] ^ cm;
    uint32_t y = ~(x | (x >> 1) | (x >> 2) | (x >> 3)) & 0x11111111u;
    const int tk = clampi(within - 8 * i, 0, 8);
    y &= tk >= 8 ? 0x11111111u : (1u << (tk * 4)) - 1u;
    y += y >> 16;
    y += y >> 8;
    y += y >> 4;
    sum += y & 0xFu;
  }
  return ((c >= 1 && c <= 4) ? got[c] : got[0]) + sum;
}

struct Interval {
  int match_len, str_i, n_rows;
  bool fail;
  uint32_t nsp;            // the chase's first row
};

// The reference's occ-chase interval loop (fm._interval_rank_chase)
__device__ inline Interval interval_rank_chase(const LadderArgs& A, int row,
                                               int col_off, int str_idx,
                                               uint32_t sp, uint32_t ep,
                                               int max_rst, int l_min_mth) {
  const uint8_t* crow = A.codes + (size_t)row * A.codes_w;
  Interval r{L_PRE_IDX, str_idx - L_PRE_IDX, 0, false, 0};
  for (;;) {
    const bool offbuf = r.str_i < 0;
    const int c =
        offbuf ? 0 : crow[clampi(col_off + r.str_i, 0, A.codes_w - 1)];
    const uint32_t r_c = A.rank6[clampi(c, 0, 5)];
    const uint32_t nsp = r_c + rank_from_blocks(A, (int)sp, c);
    const uint32_t nep = r_c + rank_from_blocks(A, (int)ep, c);
    const bool ge_min = r.match_len >= l_min_mth - 1;
    const bool stop_a = ge_min && nsp + (uint32_t)max_rst >= nep;
    const bool stop_b = ge_min && !stop_a && r.match_len >= str_idx;
    const bool stop_c = !stop_a && !stop_b && nsp + 1u >= nep;
    r.str_i -= 1;
    if (stop_a || stop_b || stop_c || offbuf) {
      r.fail = stop_b || offbuf || nsp >= nep;
      r.nsp = nsp;
      r.n_rows = r.fail ? 0 : imin((int)(nep - nsp), max_rst);
      return r;
    }
    sp = nsp;
    ep = nep;
    r.match_len += 1;
  }
}

// Position-space interval phase for a bucket of n0 <= SA_CAP rows
// (fm._interval_sa): one LCE a row, then the chase's stop in closed form.
// Writes the first R survivors' walk positions, in row order, to w_pos.
template <int R>
__device__ inline Interval interval_sa(const LadderArgs& A,
                                       const uint32_t* qrow, int col_off,
                                       int str_idx, uint32_t sp0, int n0,
                                       int l_min_mth, int* w_pos) {
  int lden[SA_CAP], pden[SA_CAP], ls[SA_CAP];
  const int cap_l = imax(str_idx - L_PRE_IDX + 1, 0);
  for (int s = 0; s < SA_CAP; ++s) {
    lden[s] = -1;
    pden[s] = 0;
    if (s < n0) {
      const int rowix = (int)(sp0 + (uint32_t)s);
      pden[s] = A.row_pos[clampi(rowix, 0, A.n_text - 1)];
      lden[s] = lce_backward(A, qrow, col_off, str_idx - L_PRE_IDX,
                             pden[s] - 1, cap_l);
    }
    // insertion into the descending order
    int k = s;
    for (; k > 0 && ls[k - 1] < lden[s]; --k) ls[k] = ls[k - 1];
    ls[k] = lden[s];
  }
  const int a_m1 = R + 1 <= SA_CAP ? imax(ls[R < SA_CAP ? R : 0], 0) : 0;
  const int a_2 = imax(ls[1], 0);
  const int gmin_k = l_min_mth - 1 - L_PRE_IDX;
  const int k_a = imax(a_m1, gmin_k);
  const int k_b0 = imax(str_idx - L_PRE_IDX, gmin_k);
  const int k_b = k_b0 < a_m1 ? k_b0 : BIG;
  const int k_c = a_2 < gmin_k ? a_2 : BIG;
  const int k_star = imin(imin(k_a, k_b), k_c);
  const int k_off = str_idx - L_PRE_IDX + 1;
  const bool fail_off = k_star >= k_off;
  const bool is_b = k_star == k_b && !fail_off;
  const int k_eff = imin(k_star, k_off);
  int n_new = 0;
  for (int s = 0; s < SA_CAP; ++s) {
    if (s < n0 && lden[s] >= k_eff + 1) {
      if (n_new < R) w_pos[n_new] = pden[s] - (k_eff + 1);
      ++n_new;
    }
  }
  Interval r{L_PRE_IDX + k_eff, str_idx - L_PRE_IDX - (k_eff + 1), 0,
             fail_off || is_b || n_new == 0, 0};
  r.n_rows = r.fail ? 0 : imin(n_new, R);
  return r;
}

// One MEM probe's result rows (the port's res_* columns of one lane)
template <int R>
struct MemRows {
  int len[R], sp[R], sa[R], sa_l[R];
  bool sa_ok[R], valid[R];
};

// One backward MEM probe (fm.mem_probe, bwt_MEM_search): the 13-mer
// jumpstart, the interval phase, then per result row the walk in position
// space through the lane's SP_SET to a sampled position.
template <int R>
__device__ inline void mem_probe(const LadderArgs& A, int row, int col_off,
                                 int str_idx, int pre_v, IvSet& S,
                                 int l_min_mth, MemRows<R>& out) {
  for (int k = 0; k < R; ++k) {
    out.len[k] = out.sp[k] = out.sa[k] = out.sa_l[k] = 0;
    out.sa_ok[k] = out.valid[k] = false;
  }
  const uint32_t* qrow = A.codes_pk + (size_t)row * A.codes_pk_w;
  const uint32_t sp0 = A.hash13[take_i(pre_v, A.n_hash13)];
  const uint32_t ep0 = A.hash13[take_i(pre_v + 1, A.n_hash13)];
  const int n0 = (int)(ep0 - sp0);
  const bool big = n0 > SA_CAP;
  int w_pos[R];
  const Interval iv =
      big ? interval_rank_chase(A, row, col_off, str_idx, sp0, ep0, R,
                                l_min_mth)
          : interval_sa<R>(A, qrow, col_off, str_idx, sp0, n0, l_min_mth,
                           w_pos);
  const int wmax = imax(str_idx - iv.match_len, 0);
  for (int k = 0; k < iv.n_rows; ++k) {
    const int p =
        big ? A.row_pos[clampi((int)(iv.nsp + (uint32_t)k), 0, A.n_text - 1)]
            : w_pos[k];
    const int nat = lce_backward(A, qrow, col_off, iv.str_i, p - 1, wmax);
    bool abort;
    int wlen;
    if (ivset_walk(S, p, nat, abort, wlen)) continue;     // dup0: no walk
    const int T = (abort || wlen < wmax) ? wlen : wmax - 1;
    int qs = 0;
    const bool found =
        T >= 0 && find_bit_low(A.samp_bits, A.n_samp, p - T, p, qs);
    const int total = (abort ? -1000 : wlen) + iv.match_len + 1;
    out.len[k] = total;
    out.sp[k] = A.isa[clampi(p - wlen, 0, A.n_text - 1)];
    out.sa[k] = found ? A.isa[clampi(qs, 0, A.n_text - 1)] : 0;
    out.sa_ok[k] = found;
    out.sa_l[k] = found ? (p - qs) - T : -(T + 1);
    out.valid[k] = total >= l_min_mth;
  }
}

// ---- mapseed.py --------------------------------------------------------------
// 13-char read-buffer window from `start`, forward (step 1) or backward
// (step -1); GARBAGE outside the buffer (qslice13)
__device__ inline void qslice13(const uint32_t* qrow, int kw, int blen,
                                int start, int step, uint8_t* out) {
  const uint32_t v = word16(qrow, kw, step > 0 ? start : start - LV_L);
  for (int m = 0; m < W13; ++m) {
    const int src = step > 0 ? m : LV_L - m;
    const int idx = start + step * m;
    out[m] = (idx >= 0 && idx < blen) ? (uint8_t)((v >> (2 * src)) & 3u)
                                      : (uint8_t)GARBAGE;
  }
}

// 13-char packed-reference window: chars from `length` on are 0; positions
// outside the reference repeat its first or last char
__device__ inline void get_ref13(const LadderArgs& A, int offset, int length,
                                 bool forward, uint8_t* out) {
  const int start = forward ? imax(offset, 0) : imax(offset, 0) - LV_L;
  const uint32_t v16 = word16(A.ref_pk, A.n_ref_pk, start);
  const uint8_t first = A.ref_pk[0] & 3u;
  const int nl = A.n_bases - 1;
  const uint8_t last = (A.ref_pk[nl >> 4] >> ((nl & 15) * 2)) & 3u;
  uint8_t v[W13];
  for (int m = 0; m < W13; ++m) {
    const int idx = start + m;
    v[m] = idx < 0 ? first : (uint8_t)((v16 >> (2 * m)) & 3u);
    if (idx >= A.n_bases) v[m] = last;
  }
  for (int m = 0; m < W13; ++m)
    out[m] = m < length ? v[forward ? m : LV_L - m] : 0;
}

// leading positions where t == q, capped at limit
__device__ inline int leading_matches(const uint8_t* t, const uint8_t* q,
                                      int limit) {
  uint32_t mk = 0;
  for (int m = 0; m < W13; ++m)
    if (t[m] == q[m] && m < limit) mk |= 1u << m;
  return imin(popc32(((~mk) & (mk + 1u)) - 1u), limit);
}

// gold Locator.get_uni: (row, search_l) -> unitig, its offset, global offset
__device__ inline void get_uni(const LadderArgs& A, int row, int search_l,
                               bool active, int& u, int& uoff, int& g) {
  const int L = A.text_len;
  const int p1 = pymod(A.row_pos[take_i(row, A.n_row_pos)] - 1, L);
  if (active && search_l > 0) {
    const int q = p1 + search_l + 1;
    u = A.pos2uni[clampi(q, 0, L - 1)];
    uoff = q - A.uni_start[take_i(u, A.n_uni_tab)];
    if (uoff == A.uni_len[take_i(u, A.n_uni_tab)]) {
      u += 1;
      uoff = -1;
    }
  } else {
    u = A.pos2uni[p1];
    uoff = p1 - A.uni_start[take_i(u, A.n_uni_tab)] + search_l + 1;
  }
  g = A.rp_global_off[take_i(A.uni_ref_list[take_i(u, A.n_uni_tab)], A.n_rp)] +
      uoff;
}

__device__ inline int uni_len_of(const LadderArgs& A, int u) {
  return A.uni_len[take_i(imin(u, A.n_uni), A.n_uni_tab)];
}

// gold get_new_ed: the re-extension of one side against the true reference
// (left: is_fwd, the read backward from q_off; right: forward)
__device__ inline void get_new_ed(const LadderArgs& A, const uint32_t* qrow,
                                  int blen, int base, int q_off, int t_off,
                                  int l_read, bool is_fwd, int& ed,
                                  int& length, int& l_ext) {
  int max_len;
  if (is_fwd) {
    q_off = imax(q_off, 0);
    max_len = q_off;
  } else {
    max_len = l_read - q_off;
  }
  length = imin(max_len, LV_L);
  l_ext = 0;
  uint8_t q[W13], t[W13];
  if (is_fwd) qslice13(qrow, A.codes_pk_w, blen, base + q_off, -1, q);
  else qslice13(qrow, A.codes_pk_w, blen, base + q_off, 1, q);
  get_ref13(A, t_off, length, !is_fwd, t);
  bool run = length > 0 && t[0] == q[0];
  while (run) {
    const int mtc = leading_matches(t, q, length);
    const bool adv = mtc > 0;
    if (adv) {
      l_ext += mtc;
      max_len -= mtc;
      length = imin(max_len, LV_L);
      if (is_fwd) q_off -= mtc;
      t_off += is_fwd ? -mtc : mtc;
      if (is_fwd) qslice13(qrow, A.codes_pk_w, blen, base + q_off, -1, q);
      else qslice13(qrow, A.codes_pk_w, blen, base + q_off + l_ext, 1, q);
      get_ref13(A, t_off, length, !is_fwd, t);
    }
    run = adv && length > 0;
  }
  ed = lv(t, q, clampi(length, 0, LV_L));
}

// One map_seed (mapseed.map_seed_lanes for one lane): locate the MEM's
// unitig (through its sampled row, or a walk to one), extend with LV on both
// sides, then emit one anchor per reference occurrence of the unitig into
// anc[a_cnt] while a_cnt < a_cap, counting every one. Returns max_s.
__device__ inline int map_seed(const LadderArgs& A, int ridx, int base,
                               int read_len, int direction, int seed_id,
                               int sp_row, int l_m, bool sa_ok, int sa_row,
                               int sa_l, int q_off, int* anc, int& a_cnt) {
  const uint32_t* qrow = A.codes_pk + (size_t)ridx * A.codes_pk_w;
  const int kw = A.codes_pk_w;
  const int blen = A.buf_len[ridx];
  const int L_t = A.n_text;
  const int nq = A.n_q_mem;

  // ---- step 1: prefix
  const int l_pre0 = imin(q_off + 1, LV_L);
  uint8_t q_pre[W13];
  qslice13(qrow, kw, blen, base + q_off, -1, q_pre);
  int b_p = sp_row;
  const bool hash_hit = (b_p & SA_MASK) == 0;
  const int p0 = A.row_pos[clampi(b_p, 0, L_t - 1)];
  const bool do_pre = !sa_ok && !hash_hit;
  const int cap_pre = imax(l_pre0, 1);
  int qs_pre = 0, qh_pre = 0;
  const bool fs_pre = do_pre && find_bit_high(A.samp_bits, A.n_samp,
                                              p0 - cap_pre, p0 - 1, qs_pre);
  const int k_samp = fs_pre ? p0 - qs_pre : 1 << 30;
  const bool fh_pre = do_pre && find_bit_high(A.sep_hash, A.n_sep_hash,
                                              p0 - cap_pre, p0 - 1, qh_pre);
  const int t_hash = fh_pre ? p0 - qh_pre : 1 << 30;
  int s_l = do_pre ? imin(imin(cap_pre, k_samp), t_hash - 1) : 0;
  uint8_t t_pre[W13];
  collect_backward(A, p0 - 1, t_pre);
  for (int m = 0; m < W13; ++m)
    if (!(do_pre && m < s_l)) t_pre[m] = 0;
  if (do_pre) b_p = A.isa[clampi(p0 - s_l, 0, L_t - 1)];
  const bool walk_sampled = hash_hit || (fs_pre && s_l == k_samp);
  const bool have_uni1 = sa_ok || walk_sampled;
  int uni, u_off, t_off;
  get_uni(A, sa_ok ? sa_row : b_p, sa_ok ? sa_l : s_l, have_uni1, uni, u_off,
          t_off);
  bool dead = have_uni1 && uni_len_of(A, uni) < MIN_UNI_L;
  const int l_pre = have_uni1 ? imin(l_pre0, u_off) : s_l;
  if (have_uni1) get_ref13(A, t_off - 1, l_pre, false, t_pre);
  const int d_pre = lv(t_pre, q_pre, clampi(l_pre, 0, LV_L));
  const int q_pre_lv = q_lv_at(A, d_pre, l_pre);
  int s = A.q_mem[clampi(l_m, 0, nq - 1)] + q_pre_lv;
  dead = dead || (s < MIN_S_1 && l_pre == LV_L && !have_uni1);

  // ---- step 2: walk on to a sample for lanes without a unitig
  if (!dead && !have_uni1) {
    const int p2 = p0 - s_l;
    int q2, q2w = 0;
    const bool f2 = find_bit_high(A.samp_bits, A.n_samp, 0, p2 - 1, q2);
    if (!f2) find_bit_high(A.samp_bits, A.n_samp, p2, L_t - 1, q2w);
    b_p = A.isa[clampi(f2 ? q2 : q2w, 0, L_t - 1)];
    s_l += f2 ? p2 - q2 : p2 + (L_t - q2w);
    get_uni(A, b_p, s_l, true, uni, u_off, t_off);
    dead = uni_len_of(A, uni) < MIN_UNI_L;
  }

  // ---- suffix: greedy extension, then LV
  const bool live = !dead;
  const int q_off_r = q_off + l_m + 1;
  uint32_t lms = umin((uint32_t)(uni_len_of(A, uni) - u_off - l_m),
                      (uint32_t)(read_len - q_off_r));
  const bool has_suf = live && lms != 0;
  int l_suf = has_suf ? (int)umin(lms, LV_L) : 0;
  int q_i = q_off_r;
  uint8_t t_suf[W13], q_suf[W13];
  int d_suf = 0;
  if (has_suf) {
    get_ref13(A, t_off + l_m, l_suf, true, t_suf);
    qslice13(qrow, kw, blen, base + q_i, 1, q_suf);
    bool run = l_suf > 0 && t_suf[0] == q_suf[0];
    while (run) {
      const int mtc = leading_matches(t_suf, q_suf, l_suf);
      const bool adv = mtc > 0;
      if (adv) {
        l_m += mtc;
        s = A.q_mem[clampi(l_m, 0, nq - 1)] + q_pre_lv;
        lms -= (uint32_t)mtc;
        l_suf = (int)umin(lms, LV_L);
        q_i += mtc;
        get_ref13(A, t_off + l_m, l_suf, true, t_suf);
        qslice13(qrow, kw, blen, base + q_i, 1, q_suf);
      }
      run = adv && l_suf > 0;
    }
    d_suf = lv(t_suf, q_suf, clampi(l_suf, 0, LV_L));
    s += q_lv_at(A, d_suf, l_suf);
  }
  dead = dead || (live && s <= MIN_S_2 && l_suf == LV_L);

  // ---- fan out over the unitig's reference occurrences
  const int uni_c = imin(uni, A.n_uni);
  const int rl_s = A.uni_ref_list[take_i(uni_c, A.n_uni_tab)];
  const int rl_e = A.uni_ref_list[take_i(imin(uni_c + 1, A.n_uni), A.n_uni_tab)];
  const int n_occ = rl_e - rl_s;
  const bool live2 = !dead && s > 0;
  const bool huge = live2 && n_occ > 50 && n_occ >= 1000;
  const bool rs_l = l_pre < LV_L || d_pre == 0;
  const bool rs_r = l_suf < LV_L || d_suf == 0;
  const bool any_rs = rs_l || rs_r;
  int max_s = 0;
  if (live2 && !huge) {
    for (int ci = rl_s; ci < rl_e; ++ci) {
      const int cic = clampi(ci, 0, A.n_rp - 1);
      const int g_off = A.rp_global_off[cic];
      int lx_l = 0, a_ll = l_pre, a_le = d_pre;
      if (rs_l)
        get_new_ed(A, qrow, blen, base, q_off, g_off + u_off - 1, read_len,
                   true, a_le, a_ll, lx_l);
      int lx_r = 0, a_rl = l_suf, a_re = d_suf;
      if (rs_r)
        get_new_ed(A, qrow, blen, base, q_off + l_m + 1, g_off + u_off + l_m,
                   read_len, false, a_re, a_rl, lx_r);
      const int a_mtch = any_rs ? l_m + lx_l + lx_r : l_m;
      const int a_score =
          any_rs ? A.q_mem[clampi(a_mtch, 0, nq - 1)] +
                       A.q_lv[clampi(a_le, 0, A.q_lv_rows - 1) * A.q_lv_cols +
                              clampi(a_ll, 0, A.q_lv_cols - 1)] +
                       A.q_lv[clampi(a_re, 0, A.q_lv_rows - 1) * A.q_lv_cols +
                              clampi(a_rl, 0, A.q_lv_cols - 1)]
                 : s;
      if (any_rs && a_score < MIN_S_2) continue;      // not emitted
      max_s = imax(max_s, a_score);
      if (a_cnt < A.a_cap) {
        const int ref_id = A.rp_ref_id[cic];
        const int glob = g_off + u_off - lx_l;
        int* rec = anc + (size_t)a_cnt * A_NF;
        rec[0] = a_mtch;
        rec[1] = a_score;
        rec[2] = a_ll;
        rec[3] = a_le;
        rec[4] = a_rl;
        rec[5] = a_re;
        rec[6] = direction;
        rec[7] = glob;
        rec[8] = ref_id;
        rec[9] = glob - A.ref_off[take_i(ref_id, A.n_ref)];
        rec[10] = q_off + 1 - lx_l;
        rec[11] = seed_id;
      }
      ++a_cnt;
    }
  }
  return huge ? 50 : max_s;
}

}  // namespace lad
