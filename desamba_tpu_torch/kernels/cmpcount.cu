// Compare-count lookup for Hopper, by sorting and searching each row.
//
//   out[b, p] = sum_{r < R} #{k < K : t[b, k] < q[b, p] + r}
//
// all int32: a signed compare, q + r and the sum wrap as int32 (the
// adds go through uint32, so they wrap without undefined behaviour).
//
// Replaces the Pallas TPU kernels tools/gather_bench.py (pallas_cc,
// pl.pallas_call at :112: one program, the whole (B, K) sorted table and
// (B, P) queries in VMEM) and tools/gather_bench2.py (cc_pallas, :87: a
// grid of B/8 steps of 8 lanes over an unsorted table). One kernel serves
// both, one block per table row (lane): the TPU's 8-lane grid step was a
// VMEM tiling choice, not part of the function.
//
// The count of entries below x is the position where x would be inserted
// into the row sorted ascending (lower_bound), whatever the order of the
// row as given. So a block
//   1. copies its row into shared memory, padded with INT32_MAX to N words,
//      the least power of two above K and at least 8 (a pad is below no
//      threshold, so it never counts, and the row's last word is always a
//      pad), and checks in the same pass that the row ascends
//      (__syncthreads_and);
//   2. only if it does not, sorts it in place with a bitonic sort
//      (ascending; order among equal values does not change a count). Each
//      thread holds 8 words in registers and runs up to three of the sort's
//      compare-exchange stages on them between two barriers: first it sorts
//      runs of 8, then each merge of size 2^lg takes ceil(lg / 3) passes
//      (24 passes and barriers at N = 2,048, not the 66 of one stage a
//      pass);
//   3. gives each query to one thread, which runs the R searches for
//      x_r = q + r (wrapping, so each search stands alone) four at a time,
//      interleaved: log2(N) dependent shared-memory loads each, a
//      branchless binary lifting over the padded row.
// Shared memory holds word i of the row at i + i / 32: the searches of a
// warp's threads at one step meet at words 32 apart (step - 1 mod step),
// which without the skip word would all fall in one bank.
//
// What bounds it on this card: the bytes, about 3.1 MB at the tools'
// shapes (B 512, K 1,152, P 176, R 16), which HBM moves in about a
// microsecond; the least work, one search a threshold on a sorted row (and
// a comparison sort on an unsorted one), is far below the card's int32
// rate. What is left is the SMs' instruction rate for shared-memory loads,
// stores and integer operations: each block reads its row once, its sort is
// 2,048 x 66 element-stages, its searches 2,816 chains of 11 loads. A row
// of N words takes 4 (N + N / 32) bytes of dynamic shared memory, so K is
// at most 32,767 (N 32,768, 135,168 bytes).
#include <cuda_runtime.h>

constexpr int CMPCOUNT_PAD = 0x7fffffff;       // INT32_MAX
constexpr int CMPCOUNT_MAX_N = 32768;          // words of one padded row
constexpr int CMPCOUNT_THREADS = 256;          // a block, on the card

// The padded row length: the least power of two above K, at least 8.
__host__ __device__ constexpr int cmpcount_row_words(int K) {
  int n = 8;
  while (n <= K) n <<= 1;
  return n;
}

// Where word i of the row lies in shared memory: a skip word every 32.
__host__ __device__ constexpr int cmpcount_slot(int i) { return i + (i >> 5); }

// Ints of dynamic shared memory a block needs for a row of K entries.
__host__ __device__ constexpr int cmpcount_smem_words(int K) {
  return cmpcount_slot(cmpcount_row_words(K));
}

// After it, a <= b if up, else a >= b.
__device__ __forceinline__ void cmpcount_cx(int& a, int& b, bool up) {
  const int lo = min(a, b), hi = max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// One block per row b of t. Any block size works (the launcher uses
// CMPCOUNT_THREADS); the block needs cmpcount_smem_words(K) ints of
// dynamic shared memory.
__global__ void cmpcount_kernel(const int* __restrict__ q,
                                const int* __restrict__ t,
                                int* __restrict__ out, int P, int K, int R) {
  extern __shared__ int s_row[];
  const int N = cmpcount_row_words(K);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;
  const int* row = t + b * K;

  // 1. stage the row and check that it ascends
  int ascends = 1;
#pragma unroll 4
  for (int k = tid; k < N; k += nt) {
    const int v = k < K ? row[k] : CMPCOUNT_PAD;
    s_row[cmpcount_slot(k)] = v;
    if (k + 1 < K && v > row[k + 1]) ascends = 0;
  }

  // 2. sort only a row that does not ascend (every thread sees the same
  // answer, so the passes' barriers are reached by all). Bitonic: the
  // merge of size 2^lg runs stages j = 2^(lg-1) .. 1, each compare-
  // exchanging words i and i + j (bit j of i clear), ascending where bit
  // lg of i is clear; the last merge (2^lg = N) sorts the row ascending.
  if (!__syncthreads_and(ascends)) {
    // merges of size 2, 4 and 8 on runs of 8 words: each run sorted,
    // ascending where bit 3 of its position is clear
    for (int g = tid; g < N / 8; g += nt) {
      int v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = s_row[cmpcount_slot(8 * g + e)];
#pragma unroll
      for (int lg = 1; lg <= 3; ++lg)
#pragma unroll
        for (int j = 1 << (lg - 1); j > 0; j >>= 1)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (!(e & j))
              cmpcount_cx(v[e], v[e + j],
                          lg == 3 ? (g & 1) == 0 : ((e >> lg) & 1) == 0);
#pragma unroll
      for (int e = 0; e < 8; ++e) s_row[cmpcount_slot(8 * g + e)] = v[e];
    }
    __syncthreads();
    // merges of size 16 .. N: a pass runs the stages of bits top .. c
    // (c = top - 2, or 0) on groups of the 8 words whose positions differ
    // only in bits c .. c + 2; bit lg is the same for all 8
    for (int lg = 4; (1 << lg) <= N; ++lg) {
      for (int top = lg - 1; top >= 0; top -= 3) {
        const int c = top >= 2 ? top - 2 : 0;
        for (int g = tid; g < N / 8; g += nt) {
          const int base = ((g >> c) << (c + 3)) | (g & ((1 << c) - 1));
          const bool up = ((base >> lg) & 1) == 0;
          int v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = s_row[cmpcount_slot(base + (e << c))];
#pragma unroll
          for (int lb = 2; lb >= 0; --lb)
            if (c + lb <= top)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                if (!(e & (1 << lb))) cmpcount_cx(v[e], v[e | (1 << lb)], up);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            s_row[cmpcount_slot(base + (e << c))] = v[e];
        }
        __syncthreads();
      }
    }
  }

  // 3. one thread per query, its R searches four at a time. The count of
  // words below x is the least i with row[i] >= x; with row[N - 1] a pad
  // it is below N, so log2(N) halving steps find it.
  for (int p = tid; p < P; p += nt) {
    const unsigned qv = (unsigned)q[b * P + p];
    unsigned acc = 0;
    int r = 0;
    for (; r + 4 <= R; r += 4) {
      const int x0 = (int)(qv + (unsigned)r), x1 = (int)(qv + (unsigned)r + 1u);
      const int x2 = (int)(qv + (unsigned)r + 2u),
                x3 = (int)(qv + (unsigned)r + 3u);
      int p0 = 0, p1 = 0, p2 = 0, p3 = 0;
      for (int step = N >> 1; step > 0; step >>= 1) {
        p0 += s_row[cmpcount_slot(p0 + step - 1)] < x0 ? step : 0;
        p1 += s_row[cmpcount_slot(p1 + step - 1)] < x1 ? step : 0;
        p2 += s_row[cmpcount_slot(p2 + step - 1)] < x2 ? step : 0;
        p3 += s_row[cmpcount_slot(p3 + step - 1)] < x3 ? step : 0;
      }
      acc += (unsigned)(p0 + p1 + p2 + p3);
    }
    for (; r < R; ++r) {
      const int x = (int)(qv + (unsigned)r);
      int pos = 0;
      for (int step = N >> 1; step > 0; step >>= 1)
        pos += s_row[cmpcount_slot(pos + step - 1)] < x ? step : 0;
      acc += (unsigned)pos;
    }
    out[b * P + p] = (int)acc;
  }
}

// Only the launcher needs nvcc (__CUDACC__); the rest also compiles as host
// C++ over the block stand-in of the tests (tests/cuda_host/block_emu.h).
#ifdef __CUDACC__
// q (B, P), t (B, K), out (B, P): contiguous int32 on the card. Launches
// on `stream` and returns the CUDA error code of the launch (0 = launched).
extern "C" int cmpcount_launch(const int* q, const int* t, int* out, int B,
                               int P, int K, int R, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (K < 0 || R < 0 || K >= CMPCOUNT_MAX_N)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cmpcount_smem_words(K) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cmpcount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cmpcount_kernel<<<B, CMPCOUNT_THREADS, smem, (cudaStream_t)stream>>>(
      q, t, out, P, K, R);
  return (int)cudaGetLastError();
}
#endif
