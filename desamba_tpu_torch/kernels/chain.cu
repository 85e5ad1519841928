// Anchor chaining (src/cly.c:66-349) for Hopper: M2 insertion with the
// resolve-tree sort (chain_kernel, a warp a read) and the M3 sort and
// sparse DP (m3_kernel, a block of W warps a read).
//
// They replace the JAX package's chain_kernel and m3_kernel
// (desamba_tpu/engine/device/chain.py:56-168, 247-419), each a jitted XLA
// loop (a while_loop over anchor slots, a fori_loop over the M3 nodes) that
// steps every read of the batch in lockstep. Each kernel computes what its
// function computes, read for read and bit for bit; their plain versions
// are chain_kernel and m3_kernel of desamba_tpu_torch/engine/device/chain.py.
//
// What bounds them: latency, not bytes or operations. The inputs are a few
// kilobytes a read (chip_smoke.py's chain_bytes), but M2 is a chain of up
// to 64 dependent steps and the M3 DP one step a node of a run, in order.
//
// chain_kernel: a read a warp, lane c < 16 holding chain slot c's 13
// fields in registers. The warp stages its read's anchors in shared memory
// 32 at a time (coalesced), and each step reads its anchor by broadcast
// loads issued a step ahead, so the chain of a step is the match test (same
// ref and direction, |dis - q_t_dis| < 30 as a wrapping int32, ABS_U(t_ed,
// roff) < 400), a ballot and __ffs for the first match (the JAX argmax) and
// the target lane's update. The target lane decides the insertion from its
// own q_ed and writes pre[a] into a staged row (-1 by default), copied out
// coalesced after the 32 steps. The resolve sort is a stable sort by (1 -
// with_top, -score2, slot) (the two stable argsorts of the JAX code): each
// lane ranks its slot by counting over the 16 keys, and the truncation (the
// top 5 and the run of with_top chains after them) is one sum of rank bits
// over the warp.
//
// m3_kernel<W>: one read a block of W warps (8 while a batch fits one
// wave of them, 4 above: the wrapper's m3_warps), its state in dynamic
// shared memory (m3_smem_bytes, small enough for five blocks an SM).
// Stage 1 sorts the (key, slot) pairs with a bitonic network over the block
// (key: ref * 2 + dir, or 2^30 past n_anc, then roff as uint32; the pairs
// are distinct, so this is the permutation of the JAX double argsort;
// block_sort, in registers and shuffles within a warp) and gathers the
// sorted anchors. Block scans of ballots give each sorted slot its run id,
// each run its first slot, and the runs that hold a valid node. Stage 2 is
// the sparse DP: runs are independent (a node's window is its own run, above its nearest break),
// so the warps take the runs of two or more nodes from a shared counter,
// longest first, and each walks its run's nodes in slot order; runs of one
// node are closed forms, 32 at a time. A node's window (the nearest break,
// the run start) and each predecessor's weight c_mlen - (|indel| >> 4) -
// ((max_q - iir) >> 8) (with pass and |indel| <= 200) do not depend on the
// scores, so the warp computes them for the next node while the current
// one reduces. Lane k holds the score of slot ci - 1 - k in a register,
// shifted by one shuffle a node; older predecessors (windows past 32
// slots) come from shared memory, where they were final 32 nodes before.
// The chain of a node is then an add, a max and one __reduce_max_sync; the
// nearest slot that reaches the maximum (the JAX max slot among the
// maxima) is a second reduction, a node late, off the chain. Only the scores and
// pre-links are serial: the chain sums, counts, indels, with_top bits and
// first nodes follow the pre-links by pointer jumping over the block
// afterwards (a log2 of the longest chain rounds). Stage 3 takes each run's
// max and its first node that reaches it as the warp walks the run, ranks
// only the runs that are on by counting (the off runs share one key and
// follow in slot order), writes the first 16 run-chains and scans the
// with_top rows from sorted row 5 with ballots. A read with no anchors (the
// bucket's padding) has one closed form: the sixteen off runs' rows all
// come from the largest (key, slot).
//
// What bounds M3 after this: the chain of the longest run, which one warp
// walks node by node (its reductions, the next node's ballot and
// shared-memory loads), then the sort (45 steps at 512 slots: 39 in
// registers and shuffles, 6 through shared memory between barriers), the
// block scans and the pointer jumping's few rounds. The hot tests use & and
// | on booleans, not && and ||, so that they compile to predicates rather
// than branches that the lanes of a warp take apart.
//
// Integer semantics are the JAX package's: int32 arithmetic wraps (done in
// uint32 here, so no signed overflow), abs(INT_MIN) is INT_MIN, shifts of
// negatives are arithmetic, and the compares are unsigned exactly where the
// JAX code casts to uint32.
//
// Only the launchers need nvcc (__CUDACC__); the rest also compiles as host
// C++ over tests/cuda_host/block_emu.h, which is how the CPU tests run it.
#include <cstdint>
#include <cuda_runtime.h>

namespace chn {

// constants of desamba_tpu_torch/constants.py and engine/device/chain.py
constexpr int C2 = 16;                  // chain slots
constexpr int AF2 = 7;                  // anchor record
constexpr int CH_NF = 13;               // chain record
constexpr int MAX_DIS_MINUS = 30;
constexpr int MAX_WAITING_LEN = 400;
constexpr int MAX_ANCHOR_OVERLAP = 3;
constexpr int M3_ANCHOR_THRESHOLD = 50;
constexpr int M3_RUN_GAP = 2000;
constexpr int CHAIN_KEEP = 5;
constexpr int NEG = -(1 << 30);
constexpr int BIG = 1 << 30;
constexpr unsigned FULL = 0xFFFFFFFFu;

enum { A_IIR, A_ROFF, A_MLEN, A_SCORE, A_REF, A_DIR, A_USELESS };
enum { H_REF, H_QTD, H_SUM, H_ANUM, H_DIR, H_TOP, H_TST, H_TED, H_QST, H_QED,
       H_INDEL, H_CUR, H_CID };

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
  return (int)((unsigned)a << s);
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? (int)(0u - (unsigned)a) : a;
}
// ABS_U (src/cly.c): the unsigned distance, as int32 bits
__device__ __forceinline__ int absu(int a, int b) {
  const unsigned x = (unsigned)a, y = (unsigned)b;
  return (int)(x > y ? x - y : y - x);
}
// The resolve-tree sort key of a chain: (k1, k2) = (1 - with_top,
// -score2) when on, (2, 2^30) when not, as one signed-ordered 64-bit word;
// ties go to the lower slot.
__device__ __forceinline__ unsigned long long resolve_key(bool on,
                                                          const int* h) {
  const int score2 = wsub(wadd(h[H_SUM], wshl(wsub(h[H_QED], h[H_QST]), 1)),
                          wshl(h[H_INDEL], 2));
  const int k1 = on ? wsub(1, h[H_TOP]) : 2;
  const int k2 = on ? (int)(0u - (unsigned)score2) : BIG;
  return ((unsigned long long)((unsigned)k1 ^ 0x80000000u) << 32) |
         ((unsigned)k2 ^ 0x80000000u);
}
// rst of the truncation: base min(5, n), grown by the run of set bits of
// `grow` (bit s: sorted row s is on and has with_top) from bit 5 on
__device__ __forceinline__ int truncate(int n, int run) {
  const int rst = n >= CHAIN_KEEP ? CHAIN_KEEP + run : n;
  return rst < n ? rst : n;
}

}  // namespace chn

constexpr int CHAIN_WARPS = 4;   // M2 warps a block
// M2 shared memory a warp: 32 staged anchors, then their 32 pre words
constexpr int M2_STAGE = 32 * (chn::AF2 + 1);

// M2: anc (B, A2, 7) in gold insertion order, n_anc (B,) -> chains (B, 16,
// 13) sorted and truncated, n_out (B,), pre (B, A2), ovf (B,) (1 byte).
// A warp takes a read: lane c < 16 holds its chain slot c; all 32 lanes
// stage the anchors and copy the pre row out.
__global__ void __launch_bounds__(CHAIN_WARPS * 32)
    chain_kernel(const int* __restrict__ anc, const int* __restrict__ n_anc,
                 int* __restrict__ chains, int* __restrict__ n_out,
                 int* __restrict__ pre, unsigned char* __restrict__ ovf, int B,
                 int A2) {
  using namespace chn;
  extern __shared__ __align__(16) int m2_smem[];
  const int c = threadIdx.x & 31;
  const int b = blockIdx.x * CHAIN_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                         // the whole warp
  int* sa = m2_smem + (threadIdx.x >> 5) * M2_STAGE;
  int* sp = sa + 32 * AF2;                    // pre of anchor k
  const int* ar = anc + (size_t)b * A2 * AF2;
  int* pr = pre + (size_t)b * A2;
  const int na = n_anc[b];
  const int nloop = max(0, min(na, A2));      // slots with a < n_anc
  int h[CH_NF];                               // chain slot c (c < 16)
  for (int f = 0; f < CH_NF; ++f) h[f] = 0;
  int nch = 0;
  bool of = na >= M3_ANCHOR_THRESHOLD;
  for (int a0 = 0; a0 < nloop; a0 += 32) {
    const int cnt = min(32, nloop - a0);
    {                                         // every load before any store
      int v[AF2];
      for (int q = 0; q < AF2; ++q) {
        const int t = c + 32 * q;
        v[q] = t < cnt * AF2 ? ar[a0 * AF2 + t] : 0;
      }
      for (int q = 0; q < AF2; ++q)
        if (c + 32 * q < cnt * AF2) sa[c + 32 * q] = v[q];
    }
    sp[c] = -1;
    __syncwarp();
    int nx[AF2];                              // the next step's anchor
    for (int f = 0; f < AF2; ++f) nx[f] = sa[f];
    for (int k = 0; k < cnt; ++k) {
      int x[AF2];
      for (int f = 0; f < AF2; ++f) x[f] = nx[f];
      if (k + 1 < cnt)
        for (int f = 0; f < AF2; ++f) nx[f] = sa[(k + 1) * AF2 + f];
      const int iir = x[A_IIR], roff = x[A_ROFF];
      const int dis = wsub(roff, iir);
      const int read_r = wadd(iir, x[A_MLEN]);
      const int ref_r = wadd(roff, x[A_MLEN]);
      const int nu = x[A_USELESS] == 0;
      const bool m = (c < nch) & (h[H_DIR] == x[A_DIR]) &
                     (h[H_REF] == x[A_REF]) &
                     (wabs(wsub(dis, h[H_QTD])) < MAX_DIS_MINUS) &
                     (absu(h[H_TED], roff) < MAX_WAITING_LEN);
      const unsigned mm = __ballot_sync(FULL, m);   // lanes c < nch only
      const bool has = mm != 0;
      const int tgt = has ? __ffs((int)mm) - 1 : min(nch, C2 - 1);
      const bool do_new = !has && nch < C2;
      of = of || (!has && nch >= C2);
      if (c == tgt) {
        if (do_new) {
          const int rec[CH_NF] = {x[A_REF], dis, x[A_SCORE], 1, x[A_DIR], nu,
                                  roff, ref_r, iir, read_r, 0, a0 + k, nch};
          for (int f = 0; f < CH_NF; ++f) h[f] = rec[f];
        } else if (has && !(h[H_QED] >= read_r)) {   // insert
          sp[k] = h[H_CUR];
          const int dis_minus = wabs(wsub(dis, h[H_QTD]));
          h[H_QTD] = dis;
          h[H_SUM] = wadd(h[H_SUM], x[A_SCORE]);
          h[H_ANUM] = wadd(h[H_ANUM], 1);
          h[H_TOP] |= nu;
          if ((unsigned)ref_r > (unsigned)h[H_TED]) h[H_TED] = ref_r;
          h[H_QED] = read_r;
          h[H_INDEL] = wadd(h[H_INDEL], dis_minus);
          h[H_CUR] = a0 + k;
        } else if (has) {                     // skipped: with_top still set
          h[H_TOP] |= nu;
        }
      }
      nch += do_new;
    }
    __syncwarp();
    if (c < cnt) pr[a0 + c] = sp[c];
    __syncwarp();                             // before the next chunk
  }
  for (int a = nloop + c; a < A2; a += 32) pr[a] = -1;

  // resolve-tree sort and truncation over the 16 slots
  const int n = min(nch, C2);
  const unsigned long long key = resolve_key(c < n, h);
  int rank = 0;
  for (int d = 0; d < C2; ++d) {
    const unsigned long long kd = __shfl_sync(FULL, key, d);
    rank += kd < key || (kd == key && d < c);
  }
  if (c < C2) {
    int* out = chains + ((size_t)b * C2 + rank) * CH_NF;
    for (int f = 0; f < CH_NF; ++f) out[f] = h[f];
  }
  const unsigned grow = __reduce_add_sync(
      FULL, c < n && rank < n && h[H_TOP] > 0 ? 1u << rank : 0u);
  if (c == 0) {
    n_out[b] = truncate(n, __ffs((int)~(grow >> CHAIN_KEEP)) - 1);
    ovf[b] = of;
  }
}

// ---- M3 --------------------------------------------------------------------
// The block's shared memory: A2 64-bit words (the sort keys; during the DP
// the live runs' first slots and lengths; in stage 3 the on runs' keys),
// then M3_ARRAYS arrays of A2 int32. S_* are in sorted-slot space, R_* in
// run space. Three arrays serve twice, so that 22 words a slot (45,056
// bytes at 512 slots) let five blocks share an SM: the 590 reads of a
// 1,024-read bucket then run as one wave, not two.
enum {
  S_ORDER,    // the sorted slot's original slot (the sort's payload)
  S_IIR, S_ROFF, S_MLEN, S_SCORE, S_REF, S_DIR, S_USE,
  S_RID,      // run id
  R_START,    // a run's first slot; then the runs' dispatch order (R_ORD)
              // and, in stage 3, by rank: the run-chain has with_top (GROW)
  S_SV,       // the DP's scores; after the DP the jumping's pointers (S_ANC)
              // and, in stage 3, each run's rank or on position
  S_PRE,                                // the DP's pre-links
  S_PSUM, S_PCNT, S_PIND, S_PTOP,       // chain sums along the pre-links
  S_ROOT,     // the slot whose iir/roff give q_st/t_st
  R_MAX, R_BSLOT,
  SCR,        // block scans' ballots and prefixes; the dispatch counters
  M3_ARRAYS,
  R_ORD = R_START, GROW = R_START, S_ANC = S_SV
};
constexpr int M3_MAX_A2 = 1024;   // slots a read (the jumping's registers)
// SCR words from the end: the dispatch counters
constexpr int SCR_CTR_RUNS = 1, SCR_CTR_ONES = 2, SCR_N_LONG = 3;

__host__ __device__ inline int m3_words(int A2) {
  return (2 + M3_ARRAYS) * A2;
}

// Exclusive prefix counts of flag(i) over i in [0, n) across the block of
// W warps: out(i, prefix, flag, total) for every i; returns the total. scr
// holds 2 ceil(n / 32) + 1 words. Ends at a barrier, so the outputs are
// visible and scr is free again.
template <int W, class Flag, class Out>
__device__ inline int block_scan(int n, int* scr, Flag flag, Out out) {
  using chn::FULL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (n + 31) >> 5;
  unsigned* bal = (unsigned*)scr;
  int* pfx = scr + nc;
  for (int c = warp; c < nc; c += W) {
    const int i = c * 32 + lane;
    const unsigned b = __ballot_sync(FULL, i < n && flag(i));
    if (lane == 0) bal[c] = b;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int c0 = 0; c0 < nc; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < nc ? __popc(bal[c]) : 0;
      int incl = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += t;
      }
      if (c < nc) pfx[c] = carry + incl - v;
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) scr[2 * nc] = carry;
  }
  __syncthreads();
  const int total = scr[2 * nc];
  for (int i = threadIdx.x; i < n; i += 32 * W) {
    const unsigned b = bal[i >> 5];
    const unsigned below = b & ((1u << (i & 31)) - 1u);
    out(i, pfx[i >> 5] + __popc(below), ((b >> (i & 31)) & 1u) != 0, total);
  }
  __syncthreads();
  return total;
}

// The M3 sort: the block's (key, slot) pairs in ascending order, key = (ref
// * 2 + dir, or 2^30 past n_anc, as signed) then roff as uint32. A bitonic
// network in the form whose every exchange is ascending: each merge of
// blocks of k starts by pairing slot i with i ^ (k - 1), then i ^ j for j =
// k / 4 .. 1. The N = 2^ceil(log2 A2) slots past A2 hold stand-ins for
// +infinity, which never move. Thread t holds slots t E .. t E + E - 1 in
// registers, so a partner at i ^ m is in the thread (m < E), in the warp
// (m < 32 E: one shuffle a word) or in another warp (shared memory between
// two barriers). Writes each sorted slot's original slot to ord.
template <int W, int E>
__device__ inline void block_sort(const int* ar, int na, int A2,
                                  unsigned long long* skey, int* sord) {
  using namespace chn;
  const int t = threadIdx.x, lane = t & 31;
  unsigned long long k[E];
  int o[E];
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    o[e] = i;
    k[e] = ~0ull;
    if (i < A2) {
      const int* r = ar + i * AF2;
      const int hi = i < na ? wadd(wshl(r[A_REF], 1), r[A_DIR]) : BIG;
      k[e] = ((unsigned long long)((unsigned)hi ^ 0x80000000u) << 32) |
             (unsigned)r[A_ROFF];
    }
  }
  // one exchange: keep the lesser pair in the lower slot (selects, no
  // branch: the lanes of a warp take different sides)
  auto keep = [](unsigned long long& ka, int& oa, unsigned long long kb, int ob,
                 bool lower) {
    const bool take = ((kb < ka) | ((kb == ka) & (ob < oa))) == lower;
    ka = take ? kb : ka;
    oa = take ? ob : oa;
  };
  auto in_thread = [&](int m) {          // 0 < m < E
#pragma unroll
    for (int c = 1; c < E; ++c) {         // c: m as a constant
      if (c != m) continue;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < (e ^ c)) {
          const unsigned long long ka = k[e];
          const int oa = o[e];
          keep(k[e], o[e], k[e ^ c], o[e ^ c], true);
          keep(k[e ^ c], o[e ^ c], ka, oa, false);
        }
    }
  };
  auto across = [&](int m) {             // E <= m: another thread's slots
    const int mt = m / E, me = m & (E - 1);        // me: 0 or E - 1
    const bool lower = !(t & (1 << (31 - __clz(mt))));
    if (mt < 32) {
      unsigned long long pk[E];
      int po[E];
      for (int e = 0; e < E; ++e) {
        pk[e] = __shfl_sync(FULL, me ? k[E - 1 - e] : k[e], lane ^ mt);
        po[e] = __shfl_sync(FULL, me ? o[E - 1 - e] : o[e], lane ^ mt);
      }
      for (int e = 0; e < E; ++e) keep(k[e], o[e], pk[e], po[e], lower);
      return;
    }
    for (int e = 0; e < E; ++e) {
      const int i = t * E + e;
      if (i < A2) {
        skey[i] = k[e];
        sord[i] = o[e];
      }
    }
    __syncthreads();
    for (int e = 0; e < E; ++e) {
      const int i = t * E + e, p = i ^ m;
      const bool in = (i < A2) & (p < A2);  // else a stand-in: no move
      const int q = in ? p : 0;
      const unsigned long long kq = skey[q];
      const int oq = sord[q];
      keep(k[e], o[e], in ? kq : k[e], in ? oq : o[e], lower);
    }
    __syncthreads();
  };
  int lg = 0;
  while ((1 << lg) < A2) ++lg;
  for (int lk = 1; lk <= lg; ++lk) {
    const int kk = 1 << lk;
    if (kk <= E) {
      in_thread(kk - 1);
      for (int j = kk >> 2; j >= 1; j >>= 1) in_thread(j);
      continue;
    }
    across(kk - 1);
    for (int j = kk >> 2; j >= E; j >>= 1) across(j);
    for (int j = E / 2; j >= 1; j >>= 1) in_thread(j);
  }
  for (int e = 0; e < E; ++e)
    if (t * E + e < A2) sord[t * E + e] = o[e];
}

// The fixed part of DP node ci's step (run start s): lane k stands for
// predecessor ci - 1 - k (round 0) and ci - 1 - k - 32 r (round r > 0)
// down to the nearest break or s. Round 0's score is the caller's (a
// register); later rounds' scores are final in shared memory.
struct M3Node {
  int score;        // the node's own score
  int w0;           // round 0: the predecessor's weight
  bool adm0;        // round 0: admissible
  int far_v;        // rounds past 0: the lane's best new score (or NEG)
  int far_d;        // ... and its distance, k + 32 r, the nearest on ties
};

__device__ inline M3Node m3_node(const int* S, int A2, int ci, int s,
                                 int lane) {
  using namespace chn;
#define SA(k) (S + (k) * A2)
  M3Node nd;
  nd.score = SA(S_SCORE)[ci];
  const int c_iir = SA(S_IIR)[ci], c_roff = SA(S_ROFF)[ci];
  const int c_mlen = SA(S_MLEN)[ci];
  const int max_q = wadd(c_iir, MAX_ANCHOR_OVERLAP);
  const int max_t = wadd(c_roff, MAX_ANCHOR_OVERLAP);
  const unsigned mq = (unsigned)max_q, mt = (unsigned)max_t;
  const int dqt = wsub(max_q, max_t);
  nd.adm0 = false;
  nd.w0 = 0;
  nd.far_v = NEG;
  nd.far_d = BIG;
  for (int hi = ci - 1, r = 0; hi >= s; hi -= 32, ++r) {
    // selects, no branches: a lane past the run start reads slot s and is
    // masked
    const int j = hi - lane;
    const bool in = j >= s;
    const int jc = in ? j : s;
    const int iir = SA(S_IIR)[jc], roff = SA(S_ROFF)[jc];
    const int mlen = SA(S_MLEN)[jc];
    const bool pass = in & !((unsigned)wadd(iir, mlen) > mq) &
                      !((unsigned)wadd(roff, mlen) > mt);
    const bool brk = pass & (((unsigned)wadd(iir, 1000) < mq) |
                             ((unsigned)wadd(roff, 1000) < mt));
    const unsigned bm = __ballot_sync(FULL, brk);
    const int stop = bm ? __ffs((int)bm) - 1 : 32;   // nearest break
    const int ai = wabs(wsub(wsub(iir, roff), dqt));
    const bool adm = pass & (lane < stop) & (ai <= 200);
    const int w = wsub(wsub(c_mlen, ai >> 4),
                       (int)((unsigned)wsub(max_q, iir) >> 8));
    if (r == 0) {                             // the same in every lane
      nd.adm0 = adm;
      nd.w0 = w;
    } else {
      const int ns = wadd(SA(S_SV)[jc], w);
      const bool better = adm & (ns > nd.far_v);   // strict: the nearer
      nd.far_v = better ? ns : nd.far_v;
      nd.far_d = better ? lane + 32 * r : nd.far_d;
    }
    if (bm) break;
  }
  return nd;
#undef SA
}

// A run's max over its valid nodes and the first node that reaches it
__device__ __forceinline__ void run_track(int sv, int i, int A2, int& m,
                                          int& bs) {
  if (sv > m) {
    m = sv;
    bs = i;
  } else if (sv == m && bs == A2) {
    bs = i;
  }
}

// M3: anc (Bm, A2, 7), n_anc (Bm,) -> chains (Bm, 16, 13), n_out (Bm,),
// pre (Bm, A2) in the original slot space, ovf (Bm,) (1 byte): more than
// 16 chains kept before the clamp. W warps a block, a block a read.
template <int W>
__global__ void __launch_bounds__(W * 32, W == 8 ? 4 : 5)
    m3_kernel(const int* __restrict__ anc, const int* __restrict__ n_anc,
              int* __restrict__ chains, int* __restrict__ n_out,
              int* __restrict__ pre, unsigned char* __restrict__ ovf, int A2) {
  using namespace chn;
  constexpr int T = 32 * W;
  constexpr int JG = (M3_MAX_A2 + T - 1) / T;   // jumping items a thread
  extern __shared__ __align__(16) int m3_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  unsigned long long* key = (unsigned long long*)m3_smem;
  int* S = m3_smem + 2 * A2;
#define SA(k) (S + (k) * A2)
  int* scr = SA(SCR);
  const int* ar = anc + (size_t)b * A2 * AF2;
  int* pr = pre + (size_t)b * A2;
  int* cb = chains + (size_t)b * C2 * CH_NF;
  const int na = n_anc[b];

  if (na <= 0) {
    // No valid slot: every key is (2^30, roff), no run is on and no node
    // moves, so the sixteen rows are the off runs 0..15, each from the
    // last sorted slot: the largest (roff as uint32, slot).
    unsigned br = 0;
    int bi = -1;
    for (int i = tid; i < A2; i += T) {
      const unsigned ro = (unsigned)ar[i * AF2 + A_ROFF];
      if (bi < 0 || ro >= br) {
        br = ro;
        bi = i;
      }
    }
    const unsigned wr = __reduce_max_sync(FULL, br);
    const int wi = __reduce_max_sync(FULL, br == wr ? bi : -1);
    if (lane == 0) {
      scr[2 * warp] = (int)wr;
      scr[2 * warp + 1] = wi;
    }
    __syncthreads();
    unsigned mr = (unsigned)scr[0];
    int o = scr[1];
    for (int v = 1; v < W; ++v) {
      const unsigned r2 = (unsigned)scr[2 * v];
      const int i2 = scr[2 * v + 1];
      if (i2 >= 0 && (o < 0 || r2 > mr || (r2 == mr && i2 > o))) {
        mr = r2;
        o = i2;
      }
    }
    const int* x = ar + o * AF2;
    const int use = x[A_USELESS];
    const int row[CH_NF] = {
        x[A_REF], wsub(x[A_ROFF], x[A_IIR]),
        ((use >> 1) & 1) == 1 ? 1 : x[A_SCORE], 0, x[A_DIR],
        (use & 1) == 0, x[A_ROFF], wadd(x[A_ROFF], x[A_MLEN]), x[A_IIR],
        wadd(x[A_IIR], x[A_MLEN]), 0, o, 0};
    for (int t = tid; t < C2 * CH_NF; t += T) {
      const int f = t % CH_NF;
      cb[t] = f == H_CID ? t / CH_NF : row[f];
    }
    for (int i = tid; i < A2; i += T) pr[i] = -1;
    if (tid == 0) {
      n_out[b] = 0;
      ovf[b] = 0;
    }
    return;
  }

  // ---- stage 1: sort by (valid ? ref * 2 + dir : 2^30, roff u32, slot)
  for (int i = tid; i < A2; i += T) {
    SA(R_MAX)[i] = NEG;
    SA(R_BSLOT)[i] = A2;
  }
  {
    int n2 = 1;
    while (n2 < A2) n2 <<= 1;
    const int per = n2 > T ? n2 / T : 1;          // slots a thread
    if (per == 1)
      block_sort<W, 1>(ar, na, A2, key, SA(S_ORDER));
    else if (per == 2)
      block_sort<W, 2>(ar, na, A2, key, SA(S_ORDER));
    else if (per == 4)
      block_sort<W, 4>(ar, na, A2, key, SA(S_ORDER));
    else
      block_sort<W, 8>(ar, na, A2, key, SA(S_ORDER));
  }
  __syncthreads();
  for (int s = tid; s < A2; s += T) {
    const int o = SA(S_ORDER)[s];
    const int* r = ar + o * AF2;
    SA(S_IIR)[s] = r[A_IIR];
    SA(S_ROFF)[s] = r[A_ROFF];
    SA(S_MLEN)[s] = r[A_MLEN];
    SA(S_SCORE)[s] = r[A_SCORE];
    SA(S_REF)[s] = r[A_REF];
    SA(S_DIR)[s] = r[A_DIR];
    SA(S_USE)[s] = r[A_USELESS];
    SA(S_SV)[s] = o < na ? r[A_SCORE] : NEG;
    SA(S_PRE)[s] = -1;
  }
  __syncthreads();
  auto valid = [&](int s) { return SA(S_ORDER)[s] < na; };
  // runs: a new one at slot 0 and wherever ref or dir changes, the u32 gap
  // reaches M3_RUN_GAP, or the slot is not valid
  auto new_run = [&](int i) {
    return i == 0 ||
           !(SA(S_REF)[i] == SA(S_REF)[i - 1] &&
             SA(S_DIR)[i] == SA(S_DIR)[i - 1] &&
             (unsigned)wsub(SA(S_ROFF)[i], SA(S_ROFF)[i - 1]) <
                 (unsigned)M3_RUN_GAP &&
             valid(i));
  };
  const int runs_all =
      block_scan<W>(A2, scr, new_run, [&](int i, int p, bool f, int) {
        SA(S_RID)[i] = p + f - 1;
        if (f) SA(R_START)[p] = i;
      });
  // the live runs (those with a valid node: a run's only invalid slot is
  // its first), by first slot, and their lengths
  int* live = (int*)key;
  int* len = live + A2;
  const int nl = block_scan<W>(
      A2, scr,
      [&](int i) {
        const int r = SA(S_RID)[i];
        return (i == 0 || SA(S_RID)[i - 1] != r) &&
               (valid(i) || (i + 1 < A2 && SA(S_RID)[i + 1] == r));
      },
      [&](int i, int p, bool f, int) {
        if (f) {
          const int r = SA(S_RID)[i];
          live[p] = i;
          len[p] = (r + 1 < runs_all ? SA(R_START)[r + 1] : A2) - i;
        }
      });
  const int n_runs = nl > 0 ? SA(S_RID)[live[nl - 1]] + 1 : 0;
  // dispatch order: longest first, then by first slot
  int* ord = SA(R_ORD);
  if (tid == 0) {
    scr[A2 - SCR_CTR_RUNS] = 0;
    scr[A2 - SCR_CTR_ONES] = 0;
    scr[A2 - SCR_N_LONG] = 0;
  }
  __syncthreads();
  for (int k = tid; k < nl; k += T) {
    const int lk = len[k];
    int rk = 0;
    for (int k2 = 0; k2 < nl; ++k2) {
      const int l2 = len[k2];
      rk += l2 > lk || (l2 == lk && k2 < k);
    }
    ord[rk] = k;
    if (lk >= 2) atomicAdd((unsigned*)&scr[A2 - SCR_N_LONG], 1u);
  }
  __syncthreads();
  const int n_long = scr[A2 - SCR_N_LONG];

  // ---- stage 2: the sparse DP, a run a warp
  for (;;) {
    int t = 0;
    if (lane == 0) t = (int)atomicAdd((unsigned*)&scr[A2 - SCR_CTR_RUNS], 1u);
    t = __shfl_sync(FULL, t, 0);
    if (t >= n_long) break;
    const int s = live[ord[t]], e = s + len[ord[t]];
    int rm = NEG, rb = A2;
    // the first node: an empty window, so the max is NEG at slot A2 - 1
    int svn = SA(S_SV)[s];
    if (valid(s)) {
      if (s >= 1) {
        const bool tk = NEG > SA(S_SCORE)[s];
        svn = tk ? NEG : SA(S_SCORE)[s];
        if (lane == 0) {
          SA(S_SV)[s] = svn;
          SA(S_PRE)[s] = tk ? A2 - 1 : -1;
        }
      }
      run_track(svn, s, A2, rm, rb);
    }
    int win = lane == 0 ? svn : NEG;          // lane k: sv of slot ci - 1 - k
    M3Node nd = m3_node(S, A2, s + 1, s, lane);
    // the previous node's step, finished off the chain: its lane value,
    // distance and maximum give its nearest slot, a reduction that runs
    // beside this node's
    int pv = 0, pd = 0, pm = 0;
    bool ptk = false;
    for (int ci = s + 1; ci < e; ++ci) {
      const int ns0 = nd.adm0 ? wadd(win, nd.w0) : NEG;
      const bool near = nd.adm0 & (ns0 >= nd.far_v);
      const int v = near ? ns0 : nd.far_v;
      const int d = near ? lane : nd.far_d;
      const int m = __reduce_max_sync(FULL, v);
      const unsigned dmin = __reduce_min_sync(   // the previous node's
          FULL, pv == pm ? (unsigned)pd : (unsigned)BIG);
      const int up = __shfl_up_sync(FULL, win, 1);
      M3Node nx = nd;
      if (ci + 1 < e) nx = m3_node(S, A2, ci + 1, s, lane);
      if (lane == 0 && ci > s + 1)
        SA(S_PRE)[ci - 1] = !ptk ? -1 : pm == NEG ? A2 - 1 : ci - 2 - (int)dmin;
      const bool tk = m > nd.score;           // strict: over the node's own
      const int sv = tk ? m : nd.score;
      win = lane == 0 ? sv : up;
      if (lane == 0) SA(S_SV)[ci] = sv;
      run_track(sv, ci, A2, rm, rb);
      pv = v;
      pd = d;
      pm = m;
      ptk = tk;
      nd = nx;
      // a score is read from shared memory 32 nodes after its write at
      // the earliest: a sync every 16 nodes orders every such pair
      if (((ci - s) & 15) == 0) __syncwarp();
    }
    {
      const unsigned dmin =
          __reduce_min_sync(FULL, pv == pm ? (unsigned)pd : (unsigned)BIG);
      if (lane == 0)
        SA(S_PRE)[e - 1] = !ptk ? -1 : pm == NEG ? A2 - 1 : e - 2 - (int)dmin;
    }
    if (lane == 0) {
      const int r = SA(S_RID)[s];
      SA(R_MAX)[r] = rm;
      SA(R_BSLOT)[r] = rb;
    }
  }
  // runs of one node (valid: they are live), 32 at a time
  for (;;) {
    int t = 0;
    if (lane == 0) t = (int)atomicAdd((unsigned*)&scr[A2 - SCR_CTR_ONES], 32u);
    t = n_long + __shfl_sync(FULL, t, 0) + lane;
    if (__ballot_sync(FULL, t < nl) == 0) break;
    if (t < nl) {
      const int s = live[ord[t]];
      int sv = SA(S_SV)[s];
      if (s >= 1) {
        const bool tk = NEG > SA(S_SCORE)[s];
        sv = tk ? NEG : SA(S_SCORE)[s];
        SA(S_SV)[s] = sv;
        SA(S_PRE)[s] = tk ? A2 - 1 : -1;
      }
      int rm = NEG, rb = A2;
      run_track(sv, s, A2, rm, rb);
      SA(R_MAX)[SA(S_RID)[s]] = rm;
      SA(R_BSLOT)[SA(S_RID)[s]] = rb;
    }
  }
  __syncthreads();

  // ---- the chain sums along the pre-links, by pointer jumping. A node
  // taken from predecessor p adds (eff, 1, d_ind, with_top) to p's sums
  // and keeps p's first node; a node taken at slot A2 - 1 with a NEG max
  // (its own score below NEG) took slot A2 - 1 as it stood then, its
  // initial values; a node not taken is a root of (0, valid, 0, 0).
  for (int i = tid; i < A2; i += T) {
    const int p = SA(S_PRE)[i], use = SA(S_USE)[i];
    if (p < 0) {
      SA(S_PSUM)[i] = 0;
      SA(S_PCNT)[i] = valid(i);
      SA(S_PIND)[i] = 0;
      SA(S_PTOP)[i] = 0;
      SA(S_ANC)[i] = -1;
      SA(S_ROOT)[i] = i;
    } else {
      const bool at_end = p == A2 - 1;
      SA(S_PSUM)[i] = ((use >> 1) & 1) == 1 ? 1 : SA(S_SCORE)[i];
      SA(S_PCNT)[i] = 1 + (at_end && valid(A2 - 1));
      SA(S_PIND)[i] = wsub(wsub(SA(S_IIR)[i], SA(S_IIR)[p]),
                           wsub(SA(S_ROFF)[i], SA(S_ROFF)[p]));
      SA(S_PTOP)[i] = (use & 1) == 0;
      SA(S_ANC)[i] = at_end ? -1 : p;
      SA(S_ROOT)[i] = at_end ? A2 - 1 : i;
    }
  }
  // each round reads every field first (a node that has reached its root
  // reads its own slot twice) and writes them back selected, no branch
  for (;;) {
    __syncthreads();
    int a[JG], root[JG], vs[JG], vc[JG], vi[JG], vt[JG];
    bool more = false;
#pragma unroll
    for (int u = 0; u < JG; ++u) {
      if (T * u >= A2) break;
      const int i = min(tid + T * u, A2 - 1);
      a[u] = SA(S_ANC)[i];
      const int p = a[u] >= 0 ? a[u] : i;
      const bool f = a[u] >= 0;
      more |= f;
      vs[u] = wadd(SA(S_PSUM)[i], f ? SA(S_PSUM)[p] : 0);
      vc[u] = wadd(SA(S_PCNT)[i], f ? SA(S_PCNT)[p] : 0);
      vi[u] = wadd(SA(S_PIND)[i], f ? SA(S_PIND)[p] : 0);
      vt[u] = SA(S_PTOP)[i] | SA(S_PTOP)[p];
      root[u] = SA(S_ROOT)[p];
      a[u] = f ? SA(S_ANC)[p] : -1;
    }
    if (!__syncthreads_or(more)) break;
#pragma unroll
    for (int u = 0; u < JG; ++u) {
      const int i = tid + T * u;
      if (T * u >= A2) break;
      if (i < A2) {
        SA(S_PSUM)[i] = vs[u];
        SA(S_PCNT)[i] = vc[u];
        SA(S_PIND)[i] = vi[u];
        SA(S_PTOP)[i] = vt[u];
        SA(S_ROOT)[i] = root[u];
        SA(S_ANC)[i] = a[u];
      }
    }
  }

  // ---- stage 3: one chain a run, the resolve sort, the truncation
  // the run-chain of run r comes from its node bs, clamped into range as
  // the JAX gather clamps
  auto run_chain = [&](int r, int* h) {
    const int bs = min(SA(R_BSLOT)[r], A2 - 1);
    const int iir = SA(S_IIR)[bs], roff = SA(S_ROFF)[bs];
    const int mlen = SA(S_MLEN)[bs], use = SA(S_USE)[bs];
    const int eff = ((use >> 1) & 1) == 1 ? 1 : SA(S_SCORE)[bs];
    const int root = SA(S_ROOT)[bs];
    h[H_REF] = SA(S_REF)[bs];
    h[H_QTD] = wsub(roff, iir);
    h[H_SUM] = wadd(SA(S_PSUM)[bs], eff);
    h[H_ANUM] = SA(S_PCNT)[bs];
    h[H_DIR] = SA(S_DIR)[bs];
    h[H_TOP] = SA(S_PTOP)[bs] | ((use & 1) == 0);
    h[H_TST] = SA(S_ROFF)[root];
    h[H_TED] = wadd(roff, mlen);
    h[H_QST] = SA(S_IIR)[root];
    h[H_QED] = wadd(iir, mlen);
    h[H_INDEL] = SA(S_PIND)[bs];
    h[H_CUR] = SA(S_ORDER)[bs];
    h[H_CID] = r;
  };
  // on runs rank among themselves by their keys (stored in run order);
  // the off runs all have the key (2, 2^30) and follow, in run order
  unsigned long long* okey = key;
  int* rk = SA(S_ANC);      // an off run's rank, or -1 - its on position
  const int n_on = block_scan<W>(
      A2, scr,
      [&](int r) {
        return r < n_runs && SA(R_MAX)[r] > NEG && SA(R_BSLOT)[r] < A2;
      },
      [&](int r, int p, bool f, int total) {
        if (f) {
          int h[CH_NF];
          run_chain(r, h);
          okey[p] = resolve_key(true, h);
          rk[r] = -1 - p;
        } else {
          rk[r] = total + r - p;
        }
      });
  const int n = n_runs;
  for (int r = tid; r < A2; r += T) {
    int h[CH_NF];
    run_chain(r, h);
    int rank = rk[r];
    if (rank < 0) {
      const int k = -1 - rank;
      const unsigned long long kk = okey[k];
      rank = 0;
      for (int k2 = 0; k2 < n_on; ++k2) {
        const unsigned long long k2k = okey[k2];
        rank += k2k < kk || (k2k == kk && k2 < k);
      }
    }
    SA(GROW)[rank] = rank < n && h[H_TOP] > 0;
    if (rank < C2) {
      int* out = cb + rank * CH_NF;
      for (int f = 0; f < CH_NF; ++f) out[f] = h[f];
    }
  }
  __syncthreads();
  // pre-links back to the original slots
  for (int i = tid; i < A2; i += T) {
    const int p = SA(S_PRE)[i];
    pr[SA(S_ORDER)[i]] = p >= 0 ? SA(S_ORDER)[min(p, A2 - 1)] : -1;
  }
  if (warp == 0) {
    // the run of with_top rows from sorted row 5, within the n rows
    int run = 0;
    for (int s0 = CHAIN_KEEP; s0 < A2; s0 += 32) {
      const int s = s0 + lane;
      const unsigned g = __ballot_sync(FULL, s < n && SA(GROW)[s]);
      if (g != FULL) {
        run += __ffs((int)~g) - 1;
        break;
      }
      run += 32;
    }
    if (lane == 0) {
      const int kept = truncate(n, run);
      n_out[b] = min(kept, C2);
      ovf[b] = kept > C2;
    }
  }
#undef SA
}

// Dynamic shared memory of one M3 block (bytes): the wrapper passes its own
// count, and a launch whose count differs is refused.
extern "C" int m3_smem_bytes(int A2) { return m3_words(A2) * 4; }

#ifdef __CUDACC__
constexpr int CHAIN_SMEM_MAX = 232448;
constexpr int SMEM_DEFAULT = 48 * 1024;   // more needs the opt-in
constexpr int MAX_DEVICES = 64;           // the cards a launcher takes

// Launch on `stream` of card `device`, the card of every pointer: this
// library's current device is made `device` first, since a launch (and the
// shared-memory opt-in) goes to the current one. Return the CUDA error code
// of the launch (0 = launched).
extern "C" int chain_m2_launch(const int* anc, const int* n_anc, int* chains,
                               int* n_out, int* pre, unsigned char* ovf, int B,
                               int A2, int device, void* stream) {
  if (B <= 0) return 0;
  if (A2 <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  chain_kernel<<<(B + CHAIN_WARPS - 1) / CHAIN_WARPS, CHAIN_WARPS * 32,
                 CHAIN_WARPS * M2_STAGE * sizeof(int),
                 (cudaStream_t)stream>>>(anc, n_anc, chains, n_out, pre, ovf,
                                         B, A2);
  return (int)cudaGetLastError();
}

template <int W>
static int m3_launch(const int* anc, const int* n_anc, int* chains,
                     int* n_out, int* pre, unsigned char* ovf, int B, int A2,
                     int smem_bytes, int device, cudaStream_t stream) {
  // the opt-in, once a size and card (the attribute is a card's): not at
  // all up to 48 KB (A2 <= 512), so a launch can be captured in a CUDA graph
  static int opted[MAX_DEVICES];
  if (smem_bytes > SMEM_DEFAULT && smem_bytes > opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        m3_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
    opted[device] = smem_bytes;
  }
  m3_kernel<W><<<B, W * 32, smem_bytes, stream>>>(anc, n_anc, chains, n_out,
                                                  pre, ovf, A2);
  return (int)cudaGetLastError();
}

// warps: the block's warps, 4 or 8
extern "C" int chain_m3_launch(const int* anc, const int* n_anc, int* chains,
                               int* n_out, int* pre, unsigned char* ovf, int B,
                               int A2, int smem_bytes, int warps, int device,
                               void* stream) {
  if (B <= 0) return 0;
  if (A2 < chn::C2 || A2 > M3_MAX_A2 || smem_bytes != m3_smem_bytes(A2) ||
      smem_bytes > CHAIN_SMEM_MAX || device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (warps == 8)
    return m3_launch<8>(anc, n_anc, chains, n_out, pre, ovf, B, A2,
                        smem_bytes, device, (cudaStream_t)stream);
  if (warps == 4)
    return m3_launch<4>(anc, n_anc, chains, n_out, pre, ovf, B, A2,
                        smem_bytes, device, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
#endif
