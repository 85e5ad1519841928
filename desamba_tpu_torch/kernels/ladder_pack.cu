// The two ends of the classify ladders for Hopper: the read codes packed
// before B2 and B3 run (pack2_kernel) and their anchor rows packed after
// (anchor_pack_kernel).
//
// They replace what the JAX package's fast_ladder and slow_ladder
// (desamba_tpu/engine/device/ladder.py:98-208, 211-329) compute inside
// their one jitted program besides the ladder itself: codes_pk =
// pack2(codes_fr) (:125, :232; textwalk.py:37-45) and the flat anchor pack
// with its info rows (pack_anchors, :39-63, and pack_info, :90-95, called
// at :205-207 and :326-328). The port's plain versions are
// desamba_tpu_torch/engine/device/textwalk.py pack2 and
// engine/device/ladder.py pack_anchors and pack_info: a dozen eager ops
// around every ladder launch, two of them host syncs (a boolean-mask
// scatter and the overflow's .any()). With these kernels a ladder call is
// three launches on one stream and no host sync; the caller's one fetch
// of the info rows is the call's only one, as in the JAX design.
//
// pack2_kernel: (n, l) uint8 codes -> (n, ceil(l / 16)) int32 words, char
// j of a word at bits 2j..2j+1, summed as uint32 (the JAX sum, which wraps;
// for codes 0-3 the bits are disjoint). A thread a word: one 16-byte load
// where the rows are whole 16-byte words (the main path's rows are a
// multiple of 2,048 bytes), a byte at a time for a row's short last word
// otherwise. Bound: bytes, the codes read once and the words written once
// (5/4 of the codes); a warp's 32 loads are 512 consecutive bytes.
//
// anchor_pack_kernel: from the ladder's per-lane rows anchors (nb, a_cap,
// 12) and counts a_cnt, with cnt = min(a_cnt, a_cap) and base the exclusive
// prefix of cnt over the lanes, it writes lane i's valid rows to packed
// rows base_i + slot (those below pack_cap), each with a 13th column
// row[1] < top_i (top_i = max(35, the largest row[1] of the lane's valid
// rows)); every packed row past the last one written is 0; the info rows
// [base, a_cnt, flag, iv_ovf]; and the pack overflow, any(base + cnt >
// pack_cap), which is total > pack_cap since base + cnt only grows (the
// ladder kernels write counts of 0 and up). It reads no row past a lane's
// count, so the ladder's anchor rows need no zero fill.
//
// One launch, no block waiting on another: block b owns a contiguous
// range of `chunk` lanes (at most a lane a thread) and first reads every
// lane's count (4 bytes a lane, from L2; nb is a few hundred to tens of
// thousands of lanes), which gives both its range's offset (the counts
// before it) and the total; it scans its lanes (warp scans by shuffles,
// the warps' totals through shared memory behind one barrier); then its
// packed rows, which are one contiguous range, go a row a thread: each
// thread finds its row's lane by a binary search of the bases in shared
// memory, loads the row's 48 bytes (every row of the block at once, two a
// thread held in registers) and folds its score into the lane's top by a
// shared-memory atomicMax; after a barrier the rows, each with its mark,
// are staged in shared memory a block of them at a time and written out
// as consecutive words. Each block also zeroes its share of the rows past
// the total. What bounds it is its launch and two dependent rounds of
// loads (the counts,
// then the rows), not bytes: a call moves under a few megabytes. On the
// card a warp a lane, which took a block's lanes one after another at a
// round of row loads each, ran 3.6-12.5 us a call; a thread writing its
// 52-byte row word by word, each warp store strewn over 13 sectors, ran
// 3.6-24.1 us, growing with the rows (PERF.md). A second launch for the
// scan, or the last-block-done pattern at the end of B2/B3, would add a
// launch or a dependent round through device memory. Reading the counts
// in every block costs blocks x nb x 4 bytes from L2, which the grid keeps
// near 4 MB at the path's 2,048-32,768 lanes (anchor_pack_blocks).
//
// Only the launchers need nvcc (__CUDACC__); the kernels also compile as
// host C++ over tests/cuda_host/block_emu.h, which is how the CPU tests run
// them.
#include <cuda_runtime.h>

constexpr int PACK_A_NF = 12;           // a ladder anchor row (mapseed.A_NF)
constexpr int PACK_P_NF = 13;           // a packed row: an anchor, its mark
constexpr int PACK_TOP_FLOOR = 35;      // the least top score of a lane
constexpr int PACK2_THREADS = 256;
constexpr int PACK_THREADS = 512;       // the anchor pack's block: 16 warps
constexpr int PACK_WARPS = PACK_THREADS / 32;
constexpr int PACK_MAX_BLOCKS = 132;    // one block an SM of the H100
constexpr int PACK_HOLD = 2;            // packed rows a thread holds
// shared words of a block: the lanes' bases and the end, their top scores,
// the two count sums of each warp, each warp's scan total, the lane across
// pack_cap, a packed row a thread staged (30,920 bytes in all)
constexpr int PACK_SMEM_WORDS =
    2 * PACK_THREADS + 1 + 3 * PACK_WARPS + 1 + PACK_THREADS * PACK_P_NF;
constexpr unsigned PACK_FULL = 0xFFFFFFFFu;

// The anchor pack's grid at nb lanes: blocks of PACK_THREADS, a lane a warp
// up to one block an SM, but fewer where every block's reading of all nb
// counts would pass PACK_COUNT_READS in all (4 MB from L2), and never
// fewer than a lane a thread needs; one block for no lanes.
constexpr int PACK_COUNT_READS = 1 << 20;
extern "C" int anchor_pack_threads() { return PACK_THREADS; }
extern "C" int anchor_pack_blocks(int nb) {
  if (nb <= 0) return 1;
  const int least = (nb + PACK_THREADS - 1) / PACK_THREADS;
  int want = (nb + PACK_WARPS - 1) / PACK_WARPS;
  want = want < PACK_MAX_BLOCKS ? want : PACK_MAX_BLOCKS;
  const int budget = PACK_COUNT_READS / nb;
  want = want < budget ? want : budget;
  return want > least ? want : least;
}

// out[k] for word k = row * w + col of the packed codes: chars col * 16 ..
// col * 16 + 15 of the row. `wide`: l % 16 == 0 and codes 16-byte aligned.
__global__ void __launch_bounds__(PACK2_THREADS)
    pack2_kernel(const unsigned char* __restrict__ codes,
                 int* __restrict__ out, long long words, int l, int w,
                 int wide) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= words) return;
  const long long row = k / w;
  const int col = (int)(k - row * w);
  const unsigned char* src = codes + row * l + (long long)col * 16;
  unsigned v = 0;
  if (wide) {
    const int4 q = *(const int4*)src;
    const unsigned part[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z,
                              (unsigned)q.w};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v += ((part[j >> 2] >> (8 * (j & 3))) & 0xFFu) << (2 * j);
  } else {
    const int m = l - col * 16 < 16 ? l - col * 16 : 16;
    for (int j = 0; j < m; ++j) v += (unsigned)src[j] << (2 * j);
  }
  out[k] = (int)v;
}

// One anchor row of a lane by one thread: its 12 words, three 16-byte loads
// (the launcher takes 16-byte aligned anchors, so every 48-byte row is).
__device__ __forceinline__ void pack_load_row(const int* rec, int* v) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int4 w = *((const int4*)rec + q);
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
}

// Row t of a block's staged rows (13 shared words a row: a stride that is
// odd, so a warp's 32 rows fall in 32 banks): the anchor and its mark.
__device__ __forceinline__ void pack_stage_row(int* s_rows, int t,
                                               const int* v, int top) {
  int* d = s_rows + t * PACK_P_NF;
#pragma unroll
  for (int col = 0; col < PACK_A_NF; ++col) d[col] = v[col];
  d[PACK_A_NF] = v[1] < top;
}

// Packed rows [r0, r0 + cnt), staged in s_rows, written as consecutive
// words: a warp's store is 128 contiguous bytes, where a thread a 52-byte
// row strewed each store over 13 sectors.
__device__ __forceinline__ void pack_write_rows(int* packed,
                                                const int* s_rows, int r0,
                                                int cnt, int t, int nt) {
  int* d = packed + (size_t)r0 * PACK_P_NF;
  for (int w = t; w < cnt * PACK_P_NF; w += nt) d[w] = s_rows[w];
}

// The block's lane (0 .. n-1) of packed row k: the last j with
// base[j] <= k, for base[0] <= k < base[n] (that lane holds a row there).
__device__ __forceinline__ int pack_lane_of(const int* base, int n, int k) {
  int a = 0, b = n;
  while (b - a > 1) {
    const int m = (a + b) >> 1;
    if (base[m] <= k)
      a = m;
    else
      b = m;
  }
  return a;
}

// The flat anchor pack (see the note at the top). Block b owns lanes
// [b * chunk, min(nb, (b + 1) * chunk)), at most blockDim.x of them (a
// multiple of 32 up to PACK_THREADS); anchors and a_cnt 16-byte aligned;
// packed (pack_cap, 13), info (nb, 4), *ovf one byte.
__global__ void __launch_bounds__(PACK_THREADS)
    anchor_pack_kernel(const int* __restrict__ anchors,
                       const int* __restrict__ a_cnt,
                       const int* __restrict__ flag,
                       const int* __restrict__ iv_ovf,
                       int* __restrict__ packed, int* __restrict__ info,
                       unsigned char* __restrict__ ovf, int nb, int a_cap,
                       int pack_cap, int chunk) {
  extern __shared__ __align__(16) int pack_smem[];
  int* s_base = pack_smem;                         // the lanes' bases, end
  int* s_top = s_base + PACK_THREADS + 1;          // the lanes' top scores
  unsigned* s_sum = (unsigned*)(s_top + PACK_THREADS);
  unsigned* s_scan = s_sum + 2 * PACK_WARPS;
  int* s_strad = (int*)(s_scan + PACK_WARPS);      // the lane across pack_cap
  int* s_rows = s_strad + 1;                       // staged packed rows
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const long long lo_l = (long long)blockIdx.x * chunk;
  const int lo = lo_l < nb ? (int)lo_l : nb;
  const int n = lo + chunk < nb ? chunk : nb - lo;
  // this thread's lane's count and flags, loaded beside the sums' loads
  const int a = t < n ? a_cnt[lo + t] : 0;
  const int fl = t < n ? flag[lo + t] : 0;
  const int iv = t < n ? iv_ovf[lo + t] : 0;

  // 1. the counts before this block's lanes, and all of them (uint32 sums
  // wrap as the plain version's int32 cumsum), 16 bytes a load, eight
  // loads in flight a thread
  unsigned before = 0, all = 0;
  const int n4 = nb >> 2;
#pragma unroll 8
  for (int q = t; q < n4; q += nt) {
    const int4 v = ((const int4*)a_cnt)[q];
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned c = (unsigned)(w[e] < a_cap ? w[e] : a_cap);
      all += c;
      if (4 * q + e < lo) before += c;
    }
  }
  for (int i = 4 * n4 + t; i < nb; i += nt) {
    const int x = a_cnt[i];
    const unsigned c = (unsigned)(x < a_cap ? x : a_cap);
    all += c;
    if (i < lo) before += c;
  }
  before = __reduce_add_sync(PACK_FULL, before);
  all = __reduce_add_sync(PACK_FULL, all);
  if (lane == 0) {
    s_sum[wp] = before;
    s_sum[PACK_WARPS + wp] = all;
  }
  if (t == 0) *s_strad = -1;
  __syncthreads();  // the warps' count sums are in
  before = all = 0;
  for (int k = 0; k < nw; ++k) {
    before += s_sum[k];
    all += s_sum[PACK_WARPS + k];
  }
  const int total = (int)all;
  if (blockIdx.x == 0 && t == 0) *ovf = total > pack_cap;

  // 2. the rows past the last one written, [min(total, pack_cap), pack_cap),
  // are 0: the block's share of them
  {
    const long long first = (long long)(total < pack_cap ? total : pack_cap) *
                            PACK_P_NF;
    const long long span = (long long)pack_cap * PACK_P_NF - first;
    if (span > 0) {
      const long long z0 = first + span * blockIdx.x / gridDim.x;
      const long long z1 = first + span * (blockIdx.x + 1) / gridDim.x;
      for (long long k = z0 + t; k < z1; k += nt) packed[k] = 0;
    }
  }

  // 3. the lanes' bases: warp scans by shuffles, the warps' totals through
  // shared memory; the info rows
  const unsigned c = t < n ? (unsigned)(a < a_cap ? a : a_cap) : 0u;
  unsigned x = c;                                 // the warp's inclusive scan
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(PACK_FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_scan[wp] = x;
  __syncthreads();  // the warps' scan totals are in
  unsigned off = before;
  for (int k = 0; k < wp; ++k) off += s_scan[k];
  if (t < n) {
    const int base = (int)(off + x - c);
    s_base[t] = base;
    s_top[t] = PACK_TOP_FLOOR;
    if (t == n - 1) s_base[n] = (int)(off + x);
    if (base < pack_cap && base + (int)c > pack_cap) *s_strad = t;
    int* row = info + (size_t)(lo + t) * 4;
    row[0] = base;
    row[1] = a;
    row[2] = fl;
    row[3] = iv;
  }
  __syncthreads();  // the bases are in

  // 4. the block's packed rows [k0, k1), a row a thread (its lane by a
  // search of the bases), each lane's top score a shared max over its
  // rows (and, for the lane across pack_cap, its rows past it too); then
  // each row written with its mark
  const int k0 = n > 0 ? s_base[0] : 0;
  const int k1 = n > 0 ? (s_base[n] < pack_cap ? s_base[n] : pack_cap) : 0;
  const int strad = *s_strad;
  if (strad >= 0) {
    const int* src = anchors + (size_t)(lo + strad) * a_cap * PACK_A_NF;
    const int cnt = s_base[strad + 1] - s_base[strad];
    for (int r = pack_cap - s_base[strad] + t; r < cnt; r += nt)
      atomicMax(s_top + strad, src[r * PACK_A_NF + 1]);
  }
  if (k1 - k0 <= PACK_HOLD * nt) {
    // every row of the block held in registers across the barrier
    int v[PACK_HOLD][PACK_A_NF], jm[PACK_HOLD];
#pragma unroll
    for (int m = 0; m < PACK_HOLD; ++m) {
      const int k = k0 + t + m * nt;
      jm[m] = -1;
      if (k < k1) {
        const int j = pack_lane_of(s_base, n, k);
        pack_load_row(
            anchors + ((size_t)(lo + j) * a_cap + (k - s_base[j])) * PACK_A_NF,
            v[m]);
        atomicMax(s_top + j, v[m][1]);
        jm[m] = j;
      }
    }
    __syncthreads();  // the lanes' top scores are in
#pragma unroll
    for (int m = 0; m < PACK_HOLD; ++m) {
      const int r0 = k0 + m * nt;
      if (r0 >= k1) break;
      if (m > 0) __syncthreads();  // the staged rows before are written out
      if (jm[m] >= 0) pack_stage_row(s_rows, t, v[m], s_top[jm[m]]);
      __syncthreads();  // the staged rows are in
      pack_write_rows(packed, s_rows, r0, k1 - r0 < nt ? k1 - r0 : nt, t, nt);
    }
  } else {
    // more rows than the block holds: the scores first, then the rows, a
    // block of them at a time
#pragma unroll 4
    for (int k = k0 + t; k < k1; k += nt) {
      const int j = pack_lane_of(s_base, n, k);
      atomicMax(s_top + j,
                anchors[((size_t)(lo + j) * a_cap + (k - s_base[j])) *
                            PACK_A_NF + 1]);
    }
    __syncthreads();  // the lanes' top scores are in, two passes
    for (int r0 = k0; r0 < k1; r0 += nt) {
      const int k = r0 + t;
      if (r0 > k0) __syncthreads();  // the staged rows are out, two passes
      if (k < k1) {
        const int j = pack_lane_of(s_base, n, k);
        int v[PACK_A_NF];
        pack_load_row(
            anchors + ((size_t)(lo + j) * a_cap + (k - s_base[j])) * PACK_A_NF,
            v);
        pack_stage_row(s_rows, t, v, s_top[j]);
      }
      __syncthreads();  // the staged rows are in, two passes
      pack_write_rows(packed, s_rows, r0, k1 - r0 < nt ? k1 - r0 : nt, t, nt);
    }
  }
}

#ifdef __CUDACC__
// ---- launchers: contiguous tensors on card `device` (made this library's
// current device first), on `stream`; each returns the CUDA error code of
// its launch (0 = launched) ------------------------------------------------

// codes (n, l) uint8, out (n, w) int32 with w = ceil(l / 16)
extern "C" int ladder_pack2_launch(const unsigned char* codes, int* out,
                                   int n, int l, int w, int device,
                                   cudaStream_t stream) {
  if (n < 0 || l < 0 || w != (l + 15) / 16) return (int)cudaErrorInvalidValue;
  const long long words = (long long)n * w;
  if (words == 0) return 0;
  const long long blocks = (words + PACK2_THREADS - 1) / PACK2_THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  int e = (int)cudaSetDevice(device);
  if (e != 0) return e;
  const int wide = l % 16 == 0 && ((size_t)codes & 15) == 0;
  pack2_kernel<<<(unsigned)blocks, PACK2_THREADS, 0, stream>>>(
      codes, out, words, l, w, wide);
  return (int)cudaGetLastError();
}

// anchors (nb, a_cap, 12) and a_cnt 16-byte aligned, a_cnt, flag, iv_ovf
// (nb,) int32; packed (pack_cap, 13), info (nb, 4) int32; ovf one byte
extern "C" int ladder_anchor_pack_launch(const int* anchors, const int* a_cnt,
                                         const int* flag, const int* iv_ovf,
                                         int* packed, int* info,
                                         unsigned char* ovf, int nb,
                                         int a_cap, int pack_cap, int device,
                                         cudaStream_t stream) {
  if (nb < 0 || a_cap < 1 || pack_cap < 0 || ((size_t)anchors & 15) ||
      ((size_t)a_cnt & 15))
    return (int)cudaErrorInvalidValue;
  int e = (int)cudaSetDevice(device);
  if (e != 0) return e;
  const int blocks = anchor_pack_blocks(nb);
  const int chunk = nb > 0 ? (nb + blocks - 1) / blocks : 1;
  anchor_pack_kernel<<<blocks, PACK_THREADS, PACK_SMEM_WORDS * sizeof(int),
                       stream>>>(anchors, a_cnt, flag, iv_ovf, packed, info,
                                 ovf, nb, a_cap, pack_cap, chunk);
  return (int)cudaGetLastError();
}
#endif
