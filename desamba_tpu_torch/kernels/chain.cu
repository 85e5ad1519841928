// Anchor chaining (src/cly.c:66-349) for Hopper, a warp per read: M2
// insertion with the resolve-tree sort (chain_kernel), and the M3 sort and
// sparse DP (m3_kernel).
//
// They replace the JAX package's chain_kernel and m3_kernel
// (desamba_tpu/engine/device/chain.py:56-168, 247-419), each a jitted XLA
// loop (a while_loop over anchor slots, a fori_loop over the M3 nodes) that
// steps every read of the batch in lockstep; the port ran them as eager
// torch loops of some 45 and 75 small ops a trip (up to 64 and 511 trips a
// call). Each kernel computes what its function computes, read for read and
// bit for bit; their plain versions are chain_kernel and m3_kernel of
// desamba_tpu_torch/engine/device/chain.py.
//
// chain_kernel: lane c < 16 of the warp holds chain slot c's 13 fields in
// registers. The read's anchors come in 32 at a time (lane k loads anchor
// a0 + k) and are broadcast one by one with __shfl_sync; each lane tests
// the match (same ref and direction, |dis - q_t_dis| < 30 as a wrapping
// int32, ABS_U(t_ed, roff) < 400), a ballot and __ffs pick the first match
// (the JAX argmax), and the target lane applies the new, update or skip
// record. The resolve sort is a stable sort by (1 - with_top, -score2,
// slot) (the two stable argsorts of the JAX code): each lane ranks its
// slot by counting over the 16 keys, and the truncation (the top 5 and the
// run of with_top chains after them) is one sum of rank bits.
//
// m3_kernel: one warp a block, the read's state in dynamic shared memory
// (m3_smem_bytes). Stage 1 ranks every anchor slot by the 64-bit key
// (ref * 2 + dir, or 2^30 past n_anc; roff as uint32) and its slot, by
// counting, and scatters the sorted anchors; a ballot scan gives each
// sorted slot its run id and its run's first slot. Stage 2 visits the
// valid nodes in order and scans each one's predecessors in its run from
// the nearest down, 32 at a time: the first break (a ballot) ends the scan
// (the JAX code admits only the slots above the highest break: the same
// set), and the largest new score wins, the nearest slot on ties (the
// JAX max slot among the maxima). Stage 3 takes each run's max and the
// first node that reaches it, builds the run-chains, ranks them by the
// resolve key and writes the first 16; the with_top run after the top 5 is
// scanned by ballots over the ranks and may run past 16 (then ovf).
//
// What bounds them: latency, not bytes or operations. The inputs are a few
// kilobytes a read (chip_smoke.py's chain_bytes), but M2 is a chain of up
// to 64 dependent steps and the M3 DP one of up to 511, each a few
// collectives long. Reads run in parallel, a warp each; a batch of M3
// reads (8 to a few dozen) leaves most of the card idle.
//
// Integer semantics are the JAX package's: int32 arithmetic wraps (done in
// uint32 here, so no signed overflow), abs(INT_MIN) is INT_MIN, shifts of
// negatives are arithmetic, and the compares are unsigned exactly where the
// JAX code casts to uint32.
//
// Only the launchers need nvcc (__CUDACC__); the rest also compiles as host
// C++ over tests/cuda_host/warp_emu.h, which is how the CPU tests run it.
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

constexpr int CHAIN_WARPS = 4;   // M2 reads (warps) a block

// M2: anc (B, A2, 7) in gold insertion order, n_anc (B,) -> chains (B, 16,
// 13) sorted and truncated, n_out (B,), pre (B, A2), ovf (B,) (1 byte).
__global__ void __launch_bounds__(CHAIN_WARPS * 32)
    chain_kernel(const int* __restrict__ anc, const int* __restrict__ n_anc,
                 int* __restrict__ chains, int* __restrict__ n_out,
                 int* __restrict__ pre, unsigned char* __restrict__ ovf, int B,
                 int A2) {
  using namespace chn;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * CHAIN_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                         // the same in every lane
  const int* ar = anc + (size_t)b * A2 * AF2;
  int* pr = pre + (size_t)b * A2;
  const int na = n_anc[b];
  const int nloop = max(0, min(na, A2));      // slots with a < n_anc
  int h[CH_NF];                               // chain slot `lane` (< 16)
  for (int f = 0; f < CH_NF; ++f) h[f] = 0;
  int nch = 0;
  bool of = na >= M3_ANCHOR_THRESHOLD;
  for (int a0 = 0; a0 < nloop; a0 += 32) {
    const int ak = a0 + lane;
    int x[AF2];
    for (int f = 0; f < AF2; ++f) x[f] = ak < nloop ? ar[ak * AF2 + f] : 0;
    int my_pre = -1;
    const int cnt = min(32, nloop - a0);
    for (int k = 0; k < cnt; ++k) {
      const int a = a0 + k;
      const int iir = __shfl_sync(FULL, x[A_IIR], k);
      const int roff = __shfl_sync(FULL, x[A_ROFF], k);
      const int mlen = __shfl_sync(FULL, x[A_MLEN], k);
      const int score = __shfl_sync(FULL, x[A_SCORE], k);
      const int ref = __shfl_sync(FULL, x[A_REF], k);
      const int dir = __shfl_sync(FULL, x[A_DIR], k);
      const int nu = __shfl_sync(FULL, x[A_USELESS], k) == 0;
      const int dis = wsub(roff, iir);
      const int read_r = wadd(iir, mlen);
      const int ref_r = wadd(roff, mlen);
      const bool m = lane < nch && h[H_DIR] == dir && h[H_REF] == ref &&
                     wabs(wsub(dis, h[H_QTD])) < MAX_DIS_MINUS &&
                     absu(h[H_TED], roff) < MAX_WAITING_LEN;
      const unsigned mm = __ballot_sync(FULL, m);
      const bool has = mm != 0;
      const int tgt = has ? __ffs((int)mm) - 1 : min(nch, C2 - 1);
      const int old_qed = __shfl_sync(FULL, h[H_QED], tgt);
      const int old_cur = __shfl_sync(FULL, h[H_CUR], tgt);
      const bool ins = has && !(old_qed >= read_r);
      const bool do_new = !has && nch < C2;
      of = of || (!has && nch >= C2);
      if (lane == tgt) {
        if (do_new) {
          const int rec[CH_NF] = {ref, dis, score, 1, dir, nu, roff, ref_r,
                                  iir, read_r, 0, a, nch};
          for (int f = 0; f < CH_NF; ++f) h[f] = rec[f];
        } else if (ins) {
          const int dis_minus = wabs(wsub(dis, h[H_QTD]));
          h[H_QTD] = dis;
          h[H_SUM] = wadd(h[H_SUM], score);
          h[H_ANUM] = wadd(h[H_ANUM], 1);
          h[H_TOP] |= nu;
          if ((unsigned)ref_r > (unsigned)h[H_TED]) h[H_TED] = ref_r;
          h[H_QED] = read_r;
          h[H_INDEL] = wadd(h[H_INDEL], dis_minus);
          h[H_CUR] = a;
        } else if (has) {                     // skipped: with_top still set
          h[H_TOP] |= nu;
        }
      }
      if (lane == k) my_pre = ins ? old_cur : -1;
      nch += do_new;
    }
    if (ak < nloop) pr[ak] = my_pre;
  }
  for (int a = nloop + lane; a < A2; a += 32) pr[a] = -1;

  // resolve-tree sort and truncation
  const int n = min(nch, C2);
  const unsigned long long key = resolve_key(lane < n, h);
  int rank = 0;
  for (int d = 0; d < C2; ++d) {
    const unsigned long long kd = __shfl_sync(FULL, key, d);
    rank += kd < key || (kd == key && d < lane);
  }
  if (lane < C2) {
    int* out = chains + ((size_t)b * C2 + rank) * CH_NF;
    for (int f = 0; f < CH_NF; ++f) out[f] = h[f];
  }
  const unsigned grow = __reduce_add_sync(
      FULL, lane < C2 && rank < n && h[H_TOP] > 0 ? 1u << rank : 0u);
  if (lane == 0) {
    n_out[b] = truncate(n, __ffs((int)~(grow >> CHAIN_KEEP)) - 1);
    ovf[b] = of;
  }
}

// ---- M3 --------------------------------------------------------------------
// The warp's shared-memory arrays, A2 int32 each after the A2 64-bit keys;
// S_* are in sorted-slot space, R_* in run space.
enum {
  S_IIR, S_ROFF, S_MLEN, S_SCORE, S_REF, S_DIR, S_USE, S_VALID, S_ORDER,
  S_RS,       // the first slot of the slot's run
  S_RID,      // run id
  S_SV, S_PRE, S_PSUM, S_PCNT, S_PIND, S_PTOP, S_PQST, S_PTST,   // DP state
  R_START, R_MAX, R_BSLOT,
  GROW,       // by rank: the sorted run-chain has with_top
  M3_ARRAYS
};

__host__ __device__ inline int m3_words(int A2) {
  return (2 + M3_ARRAYS) * A2;
}

// rank of each owned item i (lane + 32 u) among the A2 keys, by counting
// (key_j, j) < (key_i, i); G items held a pass
template <int G>
__device__ inline void rank_keys(const unsigned long long* keys, int A2,
                                 int g0, int lane, int* rank) {
  unsigned long long ki[G];
  int ii[G];
  for (int u = 0; u < G; ++u) {
    ii[u] = g0 + lane + 32 * u;
    ki[u] = ii[u] < A2 ? keys[ii[u]] : 0ull;
    rank[u] = 0;
  }
  for (int j = 0; j < A2; ++j) {
    const unsigned long long kj = keys[j];
    for (int u = 0; u < G; ++u)
      rank[u] += kj < ki[u] || (kj == ki[u] && j < ii[u]);
  }
}

constexpr int RANK_G = 8;

// M3: anc (Bm, A2, 7), n_anc (Bm,) -> chains (Bm, 16, 13), n_out (Bm,),
// pre (Bm, A2) in the original slot space, ovf (Bm,) (1 byte): more than
// 16 chains kept before the clamp. One warp a block.
__global__ void __launch_bounds__(32)
    m3_kernel(const int* __restrict__ anc, const int* __restrict__ n_anc,
              int* __restrict__ chains, int* __restrict__ n_out,
              int* __restrict__ pre, unsigned char* __restrict__ ovf, int A2) {
  using namespace chn;
  extern __shared__ __align__(16) int m3_smem[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  unsigned long long* key = (unsigned long long*)m3_smem;
  int* S = m3_smem + 2 * A2;
#define SA(k) (S + (k) * A2)
  const int* ar = anc + (size_t)b * A2 * AF2;
  const int na = n_anc[b];

  // ---- stage 1: stable sort by (valid ? ref * 2 + dir : 2^30, roff u32)
  for (int i = lane; i < A2; i += 32) {
    const int* r = ar + i * AF2;
    const int hi = i < na ? wadd(wshl(r[A_REF], 1), r[A_DIR]) : BIG;
    key[i] = ((unsigned long long)((unsigned)hi ^ 0x80000000u) << 32) |
             (unsigned)r[A_ROFF];
  }
  __syncwarp();
  for (int g0 = 0; g0 < A2; g0 += 32 * RANK_G) {
    int rank[RANK_G];
    rank_keys<RANK_G>(key, A2, g0, lane, rank);
    for (int u = 0; u < RANK_G; ++u) {
      const int i = g0 + lane + 32 * u, s = rank[u];
      if (i >= A2) break;
      const int* r = ar + i * AF2;
      const bool valid = i < na;
      SA(S_IIR)[s] = r[A_IIR];
      SA(S_ROFF)[s] = r[A_ROFF];
      SA(S_MLEN)[s] = r[A_MLEN];
      SA(S_SCORE)[s] = r[A_SCORE];
      SA(S_REF)[s] = r[A_REF];
      SA(S_DIR)[s] = r[A_DIR];
      SA(S_USE)[s] = r[A_USELESS];
      SA(S_VALID)[s] = valid;
      SA(S_ORDER)[s] = i;
      SA(S_SV)[s] = valid ? r[A_SCORE] : NEG;
      SA(S_PRE)[s] = -1;
      SA(S_PSUM)[s] = 0;
      SA(S_PCNT)[s] = valid;
      SA(S_PIND)[s] = 0;
      SA(S_PTOP)[s] = 0;
      SA(S_PQST)[s] = r[A_IIR];
      SA(S_PTST)[s] = r[A_ROFF];
    }
  }
  __syncwarp();
  // runs: a new one at slot 0 and wherever ref or dir changes, the u32 gap
  // reaches M3_RUN_GAP, or the slot is not valid
  int rid_in = -1, rs_in = 0;
  for (int base = 0; base < A2; base += 32) {
    const int i = base + lane;
    bool nr = false;
    if (i == 0) {
      nr = true;
    } else if (i < A2) {
      nr = !(SA(S_REF)[i] == SA(S_REF)[i - 1] &&
             SA(S_DIR)[i] == SA(S_DIR)[i - 1] &&
             (unsigned)wsub(SA(S_ROFF)[i], SA(S_ROFF)[i - 1]) <
                 (unsigned)M3_RUN_GAP &&
             SA(S_VALID)[i]);
    }
    const unsigned below = __ballot_sync(FULL, nr) & ((2u << lane) - 1u);
    const int rid = rid_in + __popc(below);
    const int rs = below ? base + 31 - __clz((int)below) : rs_in;
    if (i < A2) {
      SA(S_RID)[i] = rid;
      SA(S_RS)[i] = rs;
    }
    rid_in = __shfl_sync(FULL, rid, 31);
    rs_in = __shfl_sync(FULL, rs, 31);
  }
  __syncwarp();

  // ---- stage 2: the sparse DP, node by node
  for (int ci = 1; ci < A2; ++ci) {
    if (!SA(S_VALID)[ci]) continue;           // the same in every lane
    const int c_iir = SA(S_IIR)[ci], c_roff = SA(S_ROFF)[ci];
    const int c_mlen = SA(S_MLEN)[ci];
    const int max_t = wadd(c_roff, MAX_ANCHOR_OVERLAP);
    const int max_q = wadd(c_iir, MAX_ANCHOR_OVERLAP);
    const unsigned mq = (unsigned)max_q, mt = (unsigned)max_t;
    const int dqt = wsub(max_q, max_t);
    const int lo = SA(S_RS)[ci];
    int best_m = NEG, best = A2 - 1;          // the JAX max over all slots
    for (int hi = ci - 1; hi >= lo; hi -= 32) {
      const int j = hi - lane;
      bool in = j >= lo, pass = false, brk = false;
      int iir = 0, roff = 0, mlen = 0, sv = 0;
      if (in) {
        iir = SA(S_IIR)[j];
        roff = SA(S_ROFF)[j];
        mlen = SA(S_MLEN)[j];
        sv = SA(S_SV)[j];
        pass = !((unsigned)wadd(iir, mlen) > mq) &&
               !((unsigned)wadd(roff, mlen) > mt);
        brk = pass && ((unsigned)wadd(iir, 1000) < mq ||
                       (unsigned)wadd(roff, 1000) < mt);
      }
      const unsigned bm = __ballot_sync(FULL, brk);
      const int stop = bm ? __ffs((int)bm) - 1 : 32;   // nearest break
      int ns = NEG;
      if (in && lane < stop && pass) {
        const int indel = wsub(wsub(iir, roff), dqt);
        const int ai = wabs(indel);
        if (ai <= 200)
          ns = wsub(wsub(wadd(sv, c_mlen), ai >> 4),
                    (int)((unsigned)wsub(max_q, iir) >> 8));
      }
      const int cm = __reduce_max_sync(FULL, ns);
      if (cm > best_m) {                      // strict: the nearer slot wins
        best_m = cm;
        best = hi - (__ffs((int)__ballot_sync(FULL, ns == cm)) - 1);
      }
      if (bm) break;
    }
    if (lane == 0) {
      const int c_score = SA(S_SCORE)[ci], use = SA(S_USE)[ci];
      if (best_m > c_score) {
        const int bb = best;
        const int eff = ((use >> 1) & 1) == 1 ? 1 : c_score;
        const int d_ind = wsub(wsub(c_iir, SA(S_IIR)[bb]),
                               wsub(c_roff, SA(S_ROFF)[bb]));
        SA(S_SV)[ci] = best_m;
        SA(S_PRE)[ci] = bb;
        SA(S_PSUM)[ci] = wadd(SA(S_PSUM)[bb], eff);
        SA(S_PCNT)[ci] = wadd(SA(S_PCNT)[bb], 1);
        SA(S_PIND)[ci] = wadd(SA(S_PIND)[bb], d_ind);
        SA(S_PTOP)[ci] = SA(S_PTOP)[bb] | ((use & 1) == 0);
        SA(S_PQST)[ci] = SA(S_PQST)[bb];
        SA(S_PTST)[ci] = SA(S_PTST)[bb];
      } else {
        SA(S_SV)[ci] = c_score;
        SA(S_PRE)[ci] = -1;
        SA(S_PSUM)[ci] = 0;
        SA(S_PCNT)[ci] = 1;
        SA(S_PIND)[ci] = 0;
        SA(S_PTOP)[ci] = 0;
        SA(S_PQST)[ci] = c_iir;
        SA(S_PTST)[ci] = c_roff;
      }
    }
    __syncwarp();
  }

  // ---- stage 3: one chain a run, the resolve sort, the truncation
  int nr_valid = -1;
  for (int i = lane; i < A2; i += 32) {
    if (SA(S_VALID)[i]) nr_valid = max(nr_valid, SA(S_RID)[i]);
    if (SA(S_RS)[i] == i) SA(R_START)[SA(S_RID)[i]] = i;
  }
  const int n_runs = __reduce_max_sync(FULL, nr_valid) + 1;
  __syncwarp();
  const int runs_all = SA(S_RID)[A2 - 1] + 1;
  // each run's max over its valid nodes and the first node that reaches it
  for (int r = lane; r < A2; r += 32) {
    int m = NEG, bs = A2;
    if (r < runs_all) {
      const int end = r + 1 < runs_all ? SA(R_START)[r + 1] : A2;
      for (int i = SA(R_START)[r]; i < end; ++i) {
        if (!SA(S_VALID)[i]) continue;
        const int sv = SA(S_SV)[i];
        if (sv > m) {
          m = sv;
          bs = i;
        } else if (sv == m && bs == A2) {
          bs = i;
        }
      }
    }
    SA(R_MAX)[r] = m;
    SA(R_BSLOT)[r] = bs;
  }
  __syncwarp();
  // the run-chains' resolve keys (a run-chain's fields come from its node
  // bs, clamped into range as the JAX gather clamps)
  auto run_chain = [&](int r, int* h) {
    const int bs = min(SA(R_BSLOT)[r], A2 - 1);
    const int iir = SA(S_IIR)[bs], roff = SA(S_ROFF)[bs];
    const int mlen = SA(S_MLEN)[bs], use = SA(S_USE)[bs];
    const int eff = ((use >> 1) & 1) == 1 ? 1 : SA(S_SCORE)[bs];
    h[H_REF] = SA(S_REF)[bs];
    h[H_QTD] = wsub(roff, iir);
    h[H_SUM] = wadd(SA(S_PSUM)[bs], eff);
    h[H_ANUM] = SA(S_PCNT)[bs];
    h[H_DIR] = SA(S_DIR)[bs];
    h[H_TOP] = SA(S_PTOP)[bs] | ((use & 1) == 0);
    h[H_TST] = SA(S_PTST)[bs];
    h[H_TED] = wadd(roff, mlen);
    h[H_QST] = SA(S_PQST)[bs];
    h[H_QED] = wadd(iir, mlen);
    h[H_INDEL] = SA(S_PIND)[bs];
    h[H_CUR] = SA(S_ORDER)[bs];
    h[H_CID] = r;
  };
  for (int r = lane; r < A2; r += 32) {
    int h[CH_NF];
    run_chain(r, h);
    const bool on = r < n_runs && SA(R_MAX)[r] > NEG && SA(R_BSLOT)[r] < A2;
    key[r] = resolve_key(on, h);
  }
  __syncwarp();
  const int n = min(n_runs, A2);
  for (int g0 = 0; g0 < A2; g0 += 32 * RANK_G) {
    int rank[RANK_G];
    rank_keys<RANK_G>(key, A2, g0, lane, rank);
    for (int u = 0; u < RANK_G; ++u) {
      const int r = g0 + lane + 32 * u;
      if (r >= A2) break;
      int h[CH_NF];
      run_chain(r, h);
      SA(GROW)[rank[u]] = h[H_TOP] > 0;
      if (rank[u] < C2) {
        int* out = chains + ((size_t)b * C2 + rank[u]) * CH_NF;
        for (int f = 0; f < CH_NF; ++f) out[f] = h[f];
      }
    }
  }
  __syncwarp();
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
  // pre-links back to the original slots
  int* pr = pre + (size_t)b * A2;
  for (int i = lane; i < A2; i += 32) {
    const int p = SA(S_PRE)[i];
    pr[SA(S_ORDER)[i]] =
        p >= 0 ? SA(S_ORDER)[min(p, A2 - 1)] : -1;
  }
  if (lane == 0) {
    const int kept = truncate(n, run);
    n_out[b] = min(kept, C2);
    ovf[b] = kept > C2;
  }
#undef SA
}

// Dynamic shared memory of one M3 block (bytes): the wrapper passes its own
// count, and a launch whose count differs, or whose block would not fit
// 227 KB, is refused.
extern "C" int m3_smem_bytes(int A2) { return m3_words(A2) * 4; }

#ifdef __CUDACC__
constexpr int CHAIN_SMEM_MAX = 232448;

// Launch on `stream`; return the CUDA error code of the launch (0 =
// launched).
extern "C" int chain_m2_launch(const int* anc, const int* n_anc, int* chains,
                               int* n_out, int* pre, unsigned char* ovf, int B,
                               int A2, void* stream) {
  if (B <= 0) return 0;
  if (A2 <= 0) return (int)cudaErrorInvalidValue;
  chain_kernel<<<(B + CHAIN_WARPS - 1) / CHAIN_WARPS, CHAIN_WARPS * 32, 0,
                 (cudaStream_t)stream>>>(anc, n_anc, chains, n_out, pre, ovf,
                                         B, A2);
  return (int)cudaGetLastError();
}

extern "C" int chain_m3_launch(const int* anc, const int* n_anc, int* chains,
                               int* n_out, int* pre, unsigned char* ovf, int B,
                               int A2, int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  if (A2 < chn::C2 || smem_bytes != m3_smem_bytes(A2) ||
      smem_bytes > CHAIN_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      m3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  m3_kernel<<<B, 32, smem_bytes, (cudaStream_t)stream>>>(
      anc, n_anc, chains, n_out, pre, ovf, A2);
  return (int)cudaGetLastError();
}
#endif
