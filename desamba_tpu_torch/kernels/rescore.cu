// Per-read 9-mer sparse-DP rescore (src/cly.c:2335-2849) for Hopper.
//
// Replaces the Pallas TPU kernel desamba_tpu/engine/device/rescore_pl.py
// (rescore_kernel_pl, kernel body _make_kernel.kernel). It computes what
// that kernel computes, read for read and bit for bit: the anchor-gap walk
// (run_middle), the right/left window extensions (run_side/fetch_window),
// the 9-mer window matches (sdp_match), the sequential sparse DP over the
// sms node slots (node_dp) and the combine-hash absorption of sibling
// chains (build_hashv). The plain version beside it,
// desamba_tpu_torch/engine/device/rescore_ref.py, is the same program for
// one read, on Python ints, and is what this kernel is held against.
//
// Design: one warp per read, WARPS reads per block, each warp with its own
// region of dynamic shared memory. A read's walk is serial (chain by chain,
// node by node), so every lane holds the same copy of the walk's scalars
// and takes the same branches; only the inner loops are spread over the 32
// lanes:
// - fetch_window: the 128-word reference window is 4 coalesced words per
//   lane; the realignment by the window's char offset takes the next word
//   from the neighbouring lane (__shfl_sync).
// - sdp_match: 32 probe positions (every 4th 9-mer) at a time, one per
//   lane. Each lane builds its 9-mer from the window in shared memory and
//   looks it up in the read's value-sorted table: a binary search over a
//   fence table in shared memory (every stride-th value of both direction
//   tables, built when the read starts), then one over the values between
//   two fences in device memory. At the stride FENCE = 32 that is ~5
//   dependent device loads on one 128-byte line where a search over the
//   whole table took ~14 on as many lines; the whole table (4 x read length
//   bytes per direction) would not fit several warps' shared memory. A
//   lane's hits and their two match-run lengths are its own work; the
//   candidate and node order the serial walk defines (probe index, then hit
//   index) is kept by warp prefix sums of the per-lane counts
//   (__shfl_up_sync).
// - node_dp: the scan over a node's prior slots is a warp-wide max; the
//   scan's early stop becomes the highest slot that stops it (a ballot),
//   and only the slots above it count.
// - the combine-hash scan: one lane per entry, the first match by ballot.
// The read's state lives in shared memory: chains, sms slots, combine-hash
// entries, the window, the read's anchors (the walk's pointer chase) and
// the fence tables. Scalar state that all lanes hold is written by lane 0
// between __syncwarp()s. Rows without chains copy their chains through,
// write zero flags and leave at once.
//
// Long reads: the fence tables grow with the batch's table width K (half
// its F+R buffer, the longest read rounded up to 1,024), 2 * K / 32 words a
// warp at the stride FENCE, so from K ~ 214,000 (A2 = 64) or ~185,000
// (A2 = 512) four warps' regions would pass a block's 227 KB. The stride is
// then FENCE * 2^j for the smallest j whose block fits (fence_shift): the
// fences stay in shared memory, and the search between two fences takes j
// more dependent device loads, over 2^j lines, for that batch only (j = 1
// at a 250-kb read, 5 at a 4-Mb read). Keeping the fences in device memory
// above some width was the other way; it would put the whole search in
// device memory, ~14 dependent loads on as many lines, for every probe of
// every read of the batch. Widths up to ~214,000 keep j = 0, so the layout
// and the search of today's batches do not change.
//
// What bounds it: the longest read's serial walk (one dependent step per
// node, window and anchor), not bytes or operations; the card is far from
// either roofline. Candidates and nodes per window are few (tens), so most
// lanes of a warp idle in node_dp and run_len.
//
// uint32 coordinates travel as int32 bit patterns; every add wraps through
// w32() and the compares are unsigned (ult/ule) exactly where the Pallas
// kernel used po.ult/po.ule/po.umin. Windows that run past the last base
// read the last base, and the one zero row after the packed reference keeps
// the two-row window read in range (rescore_pl.py:1036-1047). The caps that
// keep fallbacks in parity (CF_CAP, F_CAP, H_CAP, S_CAP, MAX_STEPS), the
// bug_zero window truncation and the u32 wraps are kept.
//
// rescore_sharded_kernel is the same body over the reference words cut by
// row range over a mesh's idx axis (desamba_tpu_torch/parallel/sharded.py):
// fetch_window reads them through shard.cuh's ShardTab accessor, a shard
// on another card by peer access. A shard holds whole 128-word rows.
//
// Only the launcher needs nvcc (__CUDACC__); the rest also compiles as host
// C++ over a header that runs the 32 lanes of a warp as coroutines
// (tests/cuda_host/warp_emu.h), which is how the CPU tests run this file.
#include <cstdint>
#include <cuda_runtime.h>

#include "plops.cuh"
#include "shard.cuh"

using po::ule;   // the unsigned compares are the helper library's
using po::ult;

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

#define WARPS 4        // reads (warps) per block
#define FENCE_LOG2 5   // FENCE = 32: the least fence stride of the tables
#define FENCE (1 << FENCE_LOG2)
#define SMEM_MAX 232448  // dynamic shared memory a block may use (227 KB)
#define FULL 0xFFFFFFFFu

enum { C_REF, C_DIR, C_SUM, C_ANUM, C_TST, C_TED, C_QST, C_QED, C_INDEL,
       C_CUR };
enum { FB_MIDW = 1, FB_WRAP = 2, FB_HITS = 4, FB_FCAP = 8, FB_SMS = 16,
       FB_OVER = 32 };

// RT is the reference words' layout (shard.cuh): one pointer (Params), or
// the 128-word rows cut by row range over the mesh's idx axis
// (ShardedParams, the JAX package's shard_full layout)
template <class RT>
struct ParamsT {
  const int* scal;          // (B, 4) [n_chains, n_hash, read_len, buf_len]
  const int* chains;        // (B, C_CAP, CF_N)
  const int* anchors;       // (B, A2, 4) [iir, roff, mlen, pre]
  const int* schash;        // (B, HASH_CAP, 3) [key, ci, s_or_e]
  const unsigned* codes_pk; // (B, nw) packed F+R read buffer
  const int* rk_vals;       // (B, 2, K) value-sorted 9-mers per direction
  const int* rk_pos;        // (B, 2, K) their read positions
  RT ref_words;              // (NR * 128,) packed reference + zero row
  const int* ref_off;       // (nref,)
  const int* ref_len;       // (nref,)
  int* chains_out;          // (B, C_CAP, CF_N)
  int* flags;               // (B, 3) [fallback, reason bits, steps]
  int B, A2, nw, K, NR, nref, n_bases, last_char;
};
using Params = ParamsT<shard::Flat<unsigned>>;
using ShardedParams = ParamsT<shard::ShardTab<unsigned>>;

// ---- the per-warp shared-memory region, in int32 words ---------------------
// chw [C_CAP][CF_N] | hashv [10][HASH_CAP] | sms [4][S_CAP] | wj [128] |
// anc [A2][4] | fence [2][G], G = ceil(K / (FENCE << j)); rounded up to 4
// words. j = fence_shift(A2, K): the least j whose block fits SMEM_MAX, or
// the one that leaves a single fence a direction if none does.
// rescore_pl.smem_bytes and rescore_pl.fence_stride compute the same.
__host__ __device__ inline int fences(int K, int sh) {
  const int b = FENCE_LOG2 + sh;
  return (int)(((long long)K + (1LL << b) - 1) >> b);
}
__host__ __device__ inline int region_words(int A2, int K, int sh) {
  int w = C_CAP * CF_N + 10 * HASH_CAP + 4 * S_CAP + 128 + 4 * A2 +
          2 * fences(K, sh);
  return (w + 3) & ~3;
}
__host__ __device__ inline int fence_shift(int A2, int K) {
  int sh = 0;
  while (fences(K, sh) > 1 &&
         WARPS * 4LL * region_words(A2, K, sh) > SMEM_MAX)
    ++sh;
  return sh;
}
__host__ __device__ inline int warp_words(int A2, int K) {
  return region_words(A2, K, fence_shift(A2, K));
}

__device__ __forceinline__ int w32(long long x) {
  return (int)(unsigned)(unsigned long long)x;
}
__device__ __forceinline__ int iabs(int x) {
  return x < 0 ? (int)(0u - (unsigned)x) : x;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// warp sums and prefix sums of one int per lane
__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(FULL, (unsigned)v);
}
__device__ __forceinline__ int warp_excl_scan(int v, int lane) {
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x - v;
}

// One read's walk. Every lane holds the same scalars; chw ... fence point
// into this warp's shared-memory region. PT: Params or ShardedParams.
template <class PT>
struct ReadT {
  const PT* P;
  int lane;
  int n_chains, n_hash, l_read, buf_len, kw, G;
  int fsh;         // log2 of the fence stride
  const int* sch;
  const unsigned* cpk;
  const int* rkv;
  const int* rkp;
  int* chw;        // [C_CAP][CF_N]
  int* hashv;      // [10][HASH_CAP]
  int* sms;        // [4][S_CAP]
  unsigned* wj;    // [128]
  int* anc;        // [A2][4]
  int* fence;      // [2][G]
};

#define SMS(R, r, s) ((R).sms[(r) * S_CAP + (s)])
#define HV(R, r, e) ((R).hashv[(r) * HASH_CAP + (e)])
#define CHW(R, c) ((R).chw + (c) * CF_N)

template <class PT>
__device__ __forceinline__ int anc_f(const ReadT<PT>& R, int a, int f) {
  return R.anc[clampi(a, 0, R.P->A2 - 1) * 4 + f];
}

// One slot written from the walk's scalars (the same in every lane).
template <class PT>
__device__ void sms_set(ReadT<PT>& R, int slot, int q, int t, int ln,
                        int sc) {
  __syncwarp();
  if (R.lane == 0 && slot >= 0 && slot < S_CAP) {
    SMS(R, 0, slot) = q;
    SMS(R, 1, slot) = t;
    SMS(R, 2, slot) = ln;
    SMS(R, 3, slot) = sc;
  }
  __syncwarp();
}

template <class PT>
__device__ __forceinline__ int sms_get(const ReadT<PT>& R, int r, int slot) {
  return (slot >= 0 && slot < S_CAP) ? SMS(R, r, slot) : (int)0x80000000;
}

// hashv[r][e] for the HASH_CAP entries, one lane each
template <class PT>
__device__ void build_hashv(ReadT<PT>& R) {
  __syncwarp();
  if (R.lane < HASH_CAP) {
    const int e = R.lane;
    const int* s = R.sch + e * 3;
    const int* c = CHW(R, clampi(s[1], 0, C_CAP - 1));
    const int vals[10] = {s[0], s[1], s[2], c[C_QST], c[C_TST], c[C_QED],
                          c[C_TED], c[C_REF], c[C_DIR], c[C_SUM]};
    for (int r = 0; r < 10; ++r) HV(R, r, e) = vals[r];
  }
  __syncwarp();
}

// ---- packed words -----------------------------------------------------------
template <class PT>
__device__ unsigned word16_q(const ReadT<PT>& R, int base) {
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

template <class PT>
__device__ unsigned word16_w(const ReadT<PT>& R, int base) {
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
// k < cap (rescore_pl._run_len_lanes for one candidate). One lane.
template <class PT>
__device__ int run_len(const ReadT<PT>& R, int win_len, int qstart, int wstart,
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

// ---- window fetch -----------------------------------------------------------
// 128 words (2048 chars) of reference from char goff (clamped at 0); chars
// past n_bases replicate the last char, window chars >= bug_zero read 0.
// Lane l loads words l, l + 32, l + 64, l + 96.
template <class PT>
__device__ void fetch_window(ReadT<PT>& R, int goff, int bug_zero) {
  const PT* P = R.P;
  int off0 = goff > 0 ? goff : 0;
  int gw0 = off0 >> 4, cb = off0 & 15;
  int r0 = clampi(gw0 >> 7, 0, P->NR - 2);
  int o = gw0 & 127;
  long long at = (long long)r0 * 128 + o;
  int base_g = w32(at * 16);
  unsigned rep = (unsigned)P->last_char * 0x55555555u;
  int bz = w32((long long)bug_zero + cb);
  unsigned v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int l = R.lane + 32 * k;
    unsigned x = shard::ld(P->ref_words, at + l);
    int nv = clampi(
        w32((long long)P->n_bases - w32((long long)base_g + 16 * l)), 0, 16);
    unsigned keep = nv >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nv)) - 1u);
    x = (x & keep) | (rep & ~keep);
    int nz = clampi(w32((long long)bz - 16 * l), 0, 16);
    v[k] = x & (nz >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nz)) - 1u));
  }
  // window word m takes chars from words m and (m + 1) & 127
  unsigned out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned same = __shfl_sync(FULL, v[k], (R.lane + 1) & 31);
    unsigned wrap = __shfl_sync(FULL, v[(k + 1) & 3], 0);
    unsigned nx = R.lane == 31 ? wrap : same;
    out[k] = cb == 0 ? v[k] : ((v[k] >> (2 * cb)) | (nx << (32 - 2 * cb)));
  }
  __syncwarp();                // every lane is done with the last window
#pragma unroll
  for (int k = 0; k < 4; ++k) R.wj[R.lane + 32 * k] = out[k];
  __syncwarp();
}

// ---- sdp_match --------------------------------------------------------------
// First index of vals[0, rkn) (ascending) that is >= pv, or rkn: a search
// over the fences (fen[g] = vals[g << fsh], g < nfen = ceil(rkn / 2^fsh)),
// then one inside the values that lie between two fences.
__device__ int lower_bound(const int* vals, const int* fen, int nfen, int fsh,
                           int rkn, int pv) {
  int a = 0, b = nfen;
  while (a < b) {
    int m = (a + b) >> 1;
    if (fen[m] < pv) a = m + 1; else b = m;
  }
  if (a == 0) return 0;
  int lo = ((a - 1) << fsh) + 1, hi = min(a << fsh, rkn);
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (vals[mid] < pv) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Append the window's match nodes to sms from slot base_slot; returns the
// number emitted and ORs the FB_HITS/FB_FCAP/FB_SMS reasons into fb. Probe
// p (i = 4 + 4p) goes to lane p % 32 of round p / 32.
template <class PT>
__device__ int sdp_match(ReadT<PT>& R, bool forward, int t_len, int t0j,
                         int q_bg, int q_ed, int t_st, int dslot,
                         int base_slot, bool is_mid, int& fb) {
  const int lane = R.lane;
  int t_kmer_num = w32((long long)t_len - K9 + 1);
  int qbase = dslot == 1 ? 0 : R.l_read;
  int phi = forward ? 0 : ((t0j + t_kmer_num - 1) & 3);
  int rkn = R.l_read >= K9 ? R.l_read - K9 + 1 : 0;
  const int* vals = R.rkv + (long long)dslot * R.P->K;
  const int* pos = R.rkp + (long long)dslot * R.P->K;
  const int* fen = R.fence + dslot * R.G;
  int nfen = min((rkn + (1 << R.fsh) - 1) >> R.fsh, R.G);
  bool qf = ule(q_bg, q_ed);
  int total_cand = 0, lead_cnt = 0, n_new = 0;
  bool hits_over = false;
  int n_probe = t_kmer_num > 4 ? (t_kmer_num - 1) / 4 : 0;
  for (int p0 = 0; p0 < n_probe; p0 += 32) {
    int i = 4 + 4 * (p0 + lane);
    int cnt = 0, lo = 0, tpos = 0;
    if (p0 + lane < n_probe) {
      int j = forward ? i + t0j : t0j + t_kmer_num - 1 - i;
      if (!(j - phi < 0 || j - phi > 4 * 511)) {
        int pv = 0;
        for (int k = 0; k < K9; ++k) {
          int x = j + k;
          pv = (pv << 2) |
               (int)((R.wj[(x >> 4) & 127] >> ((x & 15) << 1)) & 3u);
        }
        lo = lower_bound(vals, fen, nfen, R.fsh, rkn, pv);
        while (cnt <= H_CAP && lo + cnt < rkn && vals[lo + cnt] == pv) ++cnt;
        tpos = j - t0j;
      }
    }
    hits_over |= __ballot_sync(FULL, cnt > H_CAP) != 0u;
    int nh = cnt < H_CAP ? cnt : H_CAP;
    int qp[H_CAP];
    unsigned pass = 0;
#pragma unroll
    for (int h = 0; h < H_CAP; ++h) {
      qp[h] = h < nh ? pos[lo + h] : 0;
      if (h < nh && qf && ule(q_bg, qp[h])) pass |= 1u << h;
    }
    // candidates are numbered in (probe, hit) order across the warp
    int npass = __popc(pass);
    int c = total_cand + warp_excl_scan(npass, lane);
    total_cand += warp_sum(npass);
    int lead = 0;
    unsigned emit = 0;
    int eq[H_CAP], et[H_CAP], eln[H_CAP];
#pragma unroll
    for (int h = 0; h < H_CAP; ++h) {
      eq[h] = et[h] = eln[h] = 0;
      if (!((pass >> h) & 1u)) continue;
      if (c++ >= NCAND) continue;
      int qpos = qp[h];
      int wl = 0, shrt;
      if (forward) {
        wl = t_len + (is_mid ? 0 : OVER);
        shrt = run_len(R, wl, qbase + qpos - 1, t0j + tpos - 1, false, 4);
      } else {
        shrt = run_len(R, t0j + t_len, qbase + qpos + K9, t0j + tpos + K9,
                       true, 4);
      }
      if (!(shrt < 4 || i == 4)) continue;
      ++lead;
      int back, fwd;
      if (forward) {
        int ms_u = w32((long long)q_ed - qpos - 1);
        int b_u = w32((long long)t_len - tpos - 1);
        int cap = w32((long long)(ult(ms_u, b_u) ? ms_u : b_u) + OVER);
        back = shrt;
        fwd = run_len(R, wl, qbase + qpos + K9, t0j + tpos + K9, true, cap);
      } else {
        int cap = min(qpos, tpos) + OVER;
        back = run_len(R, t0j + t_len, qbase + qpos - 1, t0j + tpos - 1,
                       false, cap);
        fwd = shrt;
      }
      int total = back + fwd + 1;
      if (total >= 4) {
        emit |= 1u << h;
        eq[h] = w32((long long)qpos - back);
        et[h] = w32((long long)tpos - back + t_st);
        eln[h] = total;
      }
    }
    lead_cnt += warp_sum(lead);
    // nodes are appended in the same order
    int nem = __popc(emit);
    int slot = base_slot + n_new + warp_excl_scan(nem, lane);
    n_new += warp_sum(nem);
#pragma unroll
    for (int h = 0; h < H_CAP; ++h) {
      if (!((emit >> h) & 1u)) continue;
      if (slot >= 0 && slot < S_CAP) {
        SMS(R, 0, slot) = eq[h];
        SMS(R, 1, slot) = et[h];
        SMS(R, 2, slot) = eln[h];
        SMS(R, 3, slot) = 0;
      }
      ++slot;
    }
  }
  __syncwarp();
  if (hits_over) fb |= FB_HITS;
  if (total_cand > CF_CAP || lead_cnt > F_CAP) fb |= FB_FCAP;
  if (base_slot + n_new + 1 > S_CAP) fb |= FB_SMS;
  return n_new;
}

// ---- node DP (one node against all prior slots) -----------------------------
// Slot s goes to lane s % 32. Scanning down from cur - 1, the serial walk
// stops at the first slot with brk (outside the middle walk): that is the
// highest such slot, and only the slots above it count.
template <class PT>
__device__ int node_dp(ReadT<PT>& R, int cur, bool is_left, bool is_mid) {
  int cq = sms_get(R, 0, cur), ct = sms_get(R, 1, cur);
  int cln = sms_get(R, 2, cur);
  int max_q = 0, max_t = 0, min_q = 0, min_t = 0;
  if (!is_left) {
    max_q = w32((long long)cq + 6);
    max_t = w32((long long)ct + 6);
  } else {
    min_q = w32((long long)cq + cln - 6 + K9 - 1);
    min_t = w32((long long)ct + cln - 6 + K9 - 1);
  }
  int m = cur < S_CAP ? cur : S_CAP;
  int val[S_CAP / 32];
  int top_brk = -1;
#pragma unroll
  for (int k = 0; k < S_CAP / 32; ++k) {
    val[k] = NEG_INF;
    if (32 * k >= m) continue;               // the same in every lane
    int s = R.lane + 32 * k;
    bool brk = false;
    if (s < m) {
      int pq = SMS(R, 0, s), pt = SMS(R, 1, s), plen = SMS(R, 2, s);
      int psc = SMS(R, 3, s);
      bool ok;
      int indel, pen;
      if (!is_left) {
        int pqe = w32((long long)pq + plen + K9 - 1);
        int pte = w32((long long)pt + plen + K9 - 1);
        ok = ule(pqe, max_q) && ule(pte, max_t);
        brk = ult(w32((long long)pt + 600), max_t);
        indel = w32((long long)pq - pt - w32((long long)max_q - max_t));
        pen = (ult(cq, pqe) || ult(ct, pte))
                  ? max(w32((long long)pqe - cq), w32((long long)pte - ct))
                  : 0;
      } else {
        ok = ule(min_q, pq) && ule(min_t, pt);
        brk = ult(w32((long long)min_t + 600), pt);
        indel = w32((long long)pq - pt - w32((long long)min_q - min_t));
        int mq6 = w32((long long)min_q + 6), mt6 = w32((long long)min_t + 6);
        pen = (ult(pq, mq6) || ult(pt, mt6))
                  ? max(w32((long long)mq6 - pq), w32((long long)mt6 - pt))
                  : 0;
      }
      if (ok && iabs(indel) <= 200)
        val[k] = w32((long long)psc + cln - (iabs(indel) >> 3) - pen);
    }
    unsigned bb = __ballot_sync(FULL, brk);
    if (bb) top_brk = 32 * k + 31 - __clz((int)bb);
  }
  int lb = is_mid ? -1 : top_brk;
  int best = NEG_INF;
#pragma unroll
  for (int k = 0; k < S_CAP / 32; ++k)
    if (R.lane + 32 * k > lb) best = max(best, val[k]);
  best = __reduce_max_sync(FULL, best);
  int node_max = max(cln, best);
  __syncwarp();
  if (R.lane == 0 && cur >= 0 && cur < S_CAP) SMS(R, 3, cur) = node_max;
  __syncwarp();
  return node_max;
}

// ---- middle walk ------------------------------------------------------------
// Returns the walk score (+10000 domain); updates fb and steps.
template <class PT>
__device__ int run_middle(ReadT<PT>& R, int a, int dslot, int t_glob, int& fb,
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
template <class PT>
__device__ int run_side(ReadT<PT>& R, bool is_left, int ci, int dslot,
                        int t_glob, int t_length, int score_in, int& fb,
                        int& steps) {
  int* c = CHW(R, ci);
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
      bool hit = false;
      if (R.lane < ne) {
        const int e = R.lane;
        int dis_con, q_pos_con, soe_want;
        if (is_left) {
          dis_con = w32((long long)HV(R, 6, e) - HV(R, 5, e));
          q_pos_con = w32((long long)HV(R, 5, e) - K9);
          soe_want = 1;
        } else {
          dis_con = w32((long long)HV(R, 4, e) - HV(R, 3, e));
          q_pos_con = HV(R, 3, e);
          soe_want = 0;
        }
        hit = HV(R, 0, e) == (dis & 0xFF) && dis == dis_con &&
              HV(R, 1, e) != ci && HV(R, 2, e) != soe_want &&
              iabs(w32((long long)c_q_pos - q_pos_con)) < 8 &&
              HV(R, 7, e) == c[C_REF] && HV(R, 8, e) == c[C_DIR] &&
              HV(R, 9, e) != 0 && HV(R, 1, e) > ci;
      }
      unsigned hb = __ballot_sync(FULL, hit);
      first_e = hb ? __ffs((int)hb) - 1 : -1;
    }
    if (first_e >= 0) {
      int* a_ = CHW(R, clampi(HV(R, 1, first_e), 0, C_CAP - 1));
      // read every field before lane 0 writes (a_ may alias c: each field
      // is then read only by its own update, as in the serial program)
      int sum = w32((long long)c[C_SUM] + a_[C_SUM]);
      int anum = w32((long long)c[C_ANUM] + a_[C_ANUM]);
      int indel = w32((long long)c[C_INDEL] + a_[C_INDEL]);
      int qst = min(c[C_QST], a_[C_QST]), tst = min(c[C_TST], a_[C_TST]);
      int qed = max(c[C_QED], a_[C_QED]), ted = max(c[C_TED], a_[C_TED]);
      int absorbed_cur = a_[C_CUR];
      __syncwarp();
      if (R.lane == 0) {
        c[C_SUM] = sum;
        c[C_ANUM] = anum;
        c[C_INDEL] = indel;
        c[C_QST] = qst;
        c[C_TST] = tst;
        c[C_QED] = qed;
        c[C_TED] = ted;
        a_[C_SUM] = a_[C_TST] = a_[C_TED] = a_[C_QST] = a_[C_QED] = 0;
      }
      __syncwarp();
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
  int bq = SMS(R, 0, mid), bt = SMS(R, 1, mid), bl = SMS(R, 2, mid);
  __syncwarp();
  if (R.lane == 0) {
    if (is_left) {
      c[C_QST] = bq;
      c[C_TST] = bt;
      c[C_SUM] = w32((long long)total - 10000);
    } else {
      c[C_QED] = w32((long long)bq + bl + K9);
      c[C_TED] = w32((long long)bt + bl + K9);
    }
  }
  __syncwarp();
  return total;
}

// One read a warp, over either layout of the reference words
template <class PT>
__device__ inline void rescore_body(const PT& P) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= P.B) return;                      // the same in every lane
  const int* s = P.scal + b * 4;
  const int* chains_in = P.chains + (long long)b * C_CAP * CF_N;
  int* chains_out = P.chains_out + (long long)b * C_CAP * CF_N;
  if (s[0] <= 0) {                           // no chains: nothing to walk
    for (int f = lane; f < C_CAP * CF_N; f += 32) chains_out[f] = chains_in[f];
    if (lane < 3) P.flags[b * 3 + lane] = 0;
    return;
  }
  ReadT<PT> R;
  R.P = &P;
  R.lane = lane;
  R.n_chains = s[0];
  R.n_hash = s[1];
  R.l_read = s[2];
  R.buf_len = s[3];
  R.kw = ((P.nw + 127) / 128) * 128;
  const int sh = fence_shift(P.A2, P.K);
  R.G = fences(P.K, sh);
  R.fsh = FENCE_LOG2 + sh;
  R.sch = P.schash + (long long)b * HASH_CAP * 3;
  R.cpk = P.codes_pk + (long long)b * P.nw;
  R.rkv = P.rk_vals + (long long)b * 2 * P.K;
  R.rkp = P.rk_pos + (long long)b * 2 * P.K;
  int* base = smem + warp * warp_words(P.A2, P.K);
  R.chw = base;
  R.hashv = R.chw + C_CAP * CF_N;
  R.sms = R.hashv + 10 * HASH_CAP;
  R.wj = (unsigned*)(R.sms + 4 * S_CAP);
  R.anc = (int*)(R.wj + 128);
  R.fence = R.anc + 4 * P.A2;
  // stage the chains, the anchors and the fences; clear the slots
  for (int f = lane; f < C_CAP * CF_N; f += 32) R.chw[f] = chains_in[f];
  const int* anc_in = P.anchors + (long long)b * P.A2 * 4;
  for (int f = lane; f < 4 * P.A2; f += 32) R.anc[f] = anc_in[f];
  for (int g = lane; g < 2 * R.G; g += 32) {
    int d = g / R.G, k = min((g - d * R.G) << R.fsh, P.K - 1);
    R.fence[g] = R.rkv[(long long)d * P.K + k];
  }
  for (int f = lane; f < 4 * S_CAP; f += 32) R.sms[f] = 0;
  __syncwarp();

  int rcap = ((P.nref + 127) / 128) * 128;
  int ci_prev = -1, fb = 0, steps = 0;
  while (fb == 0 && steps < MAX_STEPS && ci_prev < R.n_chains) {
    int pick = C_CAP;
    for (int cc = 0; cc < C_CAP; ++cc) {
      if (cc > ci_prev && cc < R.n_chains && CHW(R, cc)[C_SUM] != 0) {
        pick = cc;
        break;
      }
    }
    if (pick >= C_CAP) {
      ci_prev = C_CAP;
      continue;
    }
    int ci = pick;
    int dslot = clampi(CHW(R, ci)[C_DIR], 0, 1);
    int refc = clampi(CHW(R, ci)[C_REF], 0, rcap - 1);
    int t_glob = refc < P.nref ? P.ref_off[refc] : 0;
    int t_length = refc < P.nref ? P.ref_len[refc] : 0;
    build_hashv(R);
    int sc = run_middle(R, CHW(R, ci)[C_CUR], dslot, t_glob, fb, steps);
    sc = run_side(R, false, ci, dslot, t_glob, t_length, sc, fb, steps);
    sc = run_side(R, true, ci, dslot, t_glob, t_length, sc, fb, steps);
    ci_prev = ci;
  }
  for (int f = lane; f < C_CAP * CF_N; f += 32) chains_out[f] = R.chw[f];
  if (lane == 0) {
    P.flags[b * 3 + 0] = fb != 0 ? 1 : 0;
    P.flags[b * 3 + 1] = fb;
    P.flags[b * 3 + 2] = steps;
  }
}

// K1 over the whole reference words, and over their shards (the argument
// block stays in the parameter space, __grid_constant__, where the
// accessor reads a shard's pointer)
__global__ void __launch_bounds__(WARPS * 32) rescore_kernel(Params P) {
  rescore_body(P);
}

__global__ void __launch_bounds__(WARPS * 32)
    rescore_sharded_kernel(const __grid_constant__ ShardedParams P) {
  rescore_body(P);
}

// Dynamic shared memory of one block (bytes) and the fence stride; the
// wrapper passes its own count, and a launch whose count differs, or whose
// block would not fit, is refused.
extern "C" int rescore_smem_bytes(int A2, int K) {
  return WARPS * warp_words(A2, K) * 4;
}
extern "C" int rescore_fence_stride(int A2, int K) {
  return FENCE << fence_shift(A2, K);
}

#ifdef __CUDACC__
// A launch of `kernel` on P: WARPS reads a block, `smem_bytes` of dynamic
// shared memory (refused unless it is this file's own count), on `stream`
// of card `device`, which this library makes current first (the attribute
// and the launch go to the current device). Returns the CUDA error code.
template <class PT>
static int launch(void (*kernel)(PT), const PT& P, int smem_bytes,
                  int device, void* stream) {
  if (P.B <= 0) return 0;
  if (P.A2 <= 0 || P.K <= 0 || P.NR < 2 || smem_bytes > SMEM_MAX ||
      smem_bytes != rescore_smem_bytes(P.A2, P.K))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(P.B + WARPS - 1) / WARPS, WARPS * 32, smem_bytes,
           (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int rescore_launch(
    const int* scal, const int* chains, const int* anchors, const int* schash,
    const unsigned* codes_pk, const int* rk_vals, const int* rk_pos,
    const unsigned* ref_words, const int* ref_off, const int* ref_len,
    int* chains_out, int* flags, int B, int A2, int nw, int K, int NR,
    int nref, int n_bases, int last_char, int smem_bytes, int device,
    void* stream) {
  Params P{scal, chains, anchors, schash, codes_pk, rk_vals, rk_pos,
           ref_words, ref_off, ref_len, chains_out, flags,
           B, A2, nw, K, NR, nref, n_bases, last_char};
  return launch(rescore_kernel, P, smem_bytes, device, stream);
}

// rescore_launch over the reference words' shards: `ref_words` points to
// their accessor (a host struct, passed on by value)
extern "C" int rescore_sharded_launch(
    const int* scal, const int* chains, const int* anchors, const int* schash,
    const unsigned* codes_pk, const int* rk_vals, const int* rk_pos,
    const shard::ShardTab<unsigned>* ref_words, const int* ref_off,
    const int* ref_len, int* chains_out, int* flags, int B, int A2, int nw,
    int K, int NR, int nref, int n_bases, int last_char, int smem_bytes,
    int device, void* stream) {
  ShardedParams P{scal, chains, anchors, schash, codes_pk, rk_vals, rk_pos,
                  *ref_words, ref_off, ref_len, chains_out, flags,
                  B, A2, nw, K, NR, nref, n_bases, last_char};
  return launch(rescore_sharded_kernel, P, smem_bytes, device, stream);
}

// Let card `device` load from card `peer` (a shard's) in this library's
// kernels: this library links its own CUDA runtime, so it enables the
// access itself. 0 once enabled (also where it already was).
extern "C" int rescore_enable_peer(int device, int peer) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)e;
}
#endif
