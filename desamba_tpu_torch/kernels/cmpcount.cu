// Compare-count lookup ("searchsorted" by counting) for Hopper.
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
// both: `lanes` is the number of table rows a block holds, 1 for the
// first and 8 for the second. The table need not be sorted: the count
// below q does not depend on order, so the kernel counts and never
// searches.
//
// What bounds it on this card: integer operations. The work is
// B * P * K * R compare-and-adds, 1,660,944,384 at the tools' shapes
// (B 512, K 1,152, P 176, R 16), against about 3.1 MB of input and output,
// which HBM moves in about a microsecond. The design keeps every operand
// of the inner loop on chip: a block copies its lanes' table rows into
// shared memory once (8 x 1,153 x 4 = 36,896 bytes for 8 lanes), then one
// thread per query walks k with the R repeats inside, its count in a
// register. Queries of one lane are neighbouring threads, so a warp reads
// one t[k] at a time, a shared-memory broadcast; the rows are padded to
// K + 1 words so that a warp straddling two lanes reads two banks. Making
// it fast (fewer operations per element, more blocks in flight for the
// 8-lane grid) is later work.
#include <cuda_runtime.h>

__global__ void cmpcount_kernel(const int* __restrict__ q,
                                const int* __restrict__ t,
                                int* __restrict__ out, int B, int P, int K,
                                int R, int lanes) {
  extern __shared__ int s_t[];               // lanes rows of K + 1 words
  const int stride = K + 1;
  const int lane0 = blockIdx.x * lanes;
  const int nl = min(lanes, B - lane0);
  for (int i = threadIdx.x; i < nl * K; i += blockDim.x) {
    const int l = i / K;
    s_t[l * stride + (i - l * K)] = t[(size_t)lane0 * K + i];
  }
  __syncthreads();
  // query j of the block is (lane lane0 + j / P, probe j % P): the lanes'
  // query rows are contiguous, as are their output rows
  for (int j = threadIdx.x; j < nl * P; j += blockDim.x) {
    const int* row = s_t + (j / P) * stride;
    const unsigned qv = (unsigned)q[(size_t)lane0 * P + j];
    unsigned acc = 0;
    for (int k = 0; k < K; ++k) {
      const int v = row[k];
#pragma unroll 4
      for (int r = 0; r < R; ++r)
        acc += v < (int)(qv + (unsigned)r) ? 1u : 0u;
    }
    out[(size_t)lane0 * P + j] = (int)acc;
  }
}

// q (B, P), t (B, K), out (B, P): contiguous int32 on the card. Launches
// on `stream` and returns the CUDA error code of the launch (0 = launched).
extern "C" int cmpcount_launch(const int* q, const int* t, int* out, int B,
                               int P, int K, int R, int lanes,
                               void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (K < 0 || R < 0 || lanes <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)lanes * (K + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cmpcount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // one thread per query, as few passes as 1,024 threads allow
  const int nq = lanes * P;
  const int passes = (nq + 1023) / 1024;
  const int threads = ((nq + passes - 1) / passes + 31) / 32 * 32;
  const int blocks = (B + lanes - 1) / lanes;
  cmpcount_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      q, t, out, B, P, K, R, lanes);
  return (int)cudaGetLastError();
}
