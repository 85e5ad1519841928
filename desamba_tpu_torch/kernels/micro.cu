// Primitive benches for Hopper: what one gather, one dynamic-offset load in
// a sequential loop, one block, one asynchronous copy and one launch cost.
//
// Replaces the Pallas TPU kernels of tools/pallas_micro.py (rowgather :68,
// egather :104, dynslice :137, gridstep :164, dmaloop :206),
// tools/pallas_micro3.py (emptyk :58, the two dynamic-slice kernels built at
// :92, lgather :118, rgather :152, gridstep :179, dmaloop :217) and
// tools/pallas_micro2.py (scalarloop :58, dynal :81, dynrow :107, oneprog
// :130, vecwork :157). Sites that differ only in a shape, a stride, a mask
// or a trip count share a kernel. Each kernel computes what its TPU
// kernels compute, bit for bit (sums and products wrap as int32: they go
// through unsigned), and keeps real the one primitive they price:
//
// - dynslice_kernel: one block of 128 threads (thread = lane) walks the
//   trips in order, one coalesced 512-byte row per load, from a table that
//   stays in device memory (2 MB: L2-resident, too large for shared memory,
//   where the TPU held it in VMEM). The loop is not closed in a formula and
//   not spread over blocks: the trip is what is priced.
// - rowgather/egather/colgather: a gather is native here, one load per
//   thread; tables that fit are staged in shared memory. Every trip's load
//   is performed.
// - gridstep_kernel: one block per TPU program, so its time over the grid
//   is the card's cost of scheduling a block; with one block it is the
//   empty kernel, the launch floor.
// - dmaloop_kernel: the TPU's serial make_async_copy start/wait of 4 KB is
//   cp.async here, 16 bytes a thread over 256 threads
//   (__pipeline_memcpy_async, commit, wait for all), started and waited
//   each trip, then summed from shared memory after a barrier. Not TMA: the
//   simple form is enough to price a serial asynchronous copy.
// - scalarloop_kernel: one thread. oneprog_kernel: one block of 1,024
//   threads, each iterating the dependent multiply-add chain.
//   vecwork_kernel: a grid over all SMs, the int32 elementwise rate.
//
// What bounds them: the loops, latency (one block, dependent or serial
// work by design); the gathers and vecwork, integer operations and L2 or
// shared-memory loads. None is near the card's memory rate.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define RW 128   // row width (lanes) of every table

// out[g, :] = sum_{r < reps} tab[(idx[g, 0] + r) & row_mask, :]
// grid: one block per gathered row, 128 threads.
__global__ void rowgather_kernel(const int* __restrict__ tab,
                                 const int* __restrict__ idx,
                                 int* __restrict__ out, int row_mask,
                                 int reps) {
  const int g = blockIdx.x, l = threadIdx.x;
  const unsigned base = (unsigned)idx[(size_t)g * RW];
  unsigned acc = 0;
  for (int r = 0; r < reps; ++r)
    acc += (unsigned)tab[(size_t)((base + (unsigned)r) & (unsigned)row_mask) *
                             RW + l];
  out[(size_t)g * RW + l] = (int)acc;
}

// out[b, n] = sum_{r < reps} tab[b, (idx[b, n] + r) & (ek - 1)]
// grid: one block per table row b, which it stages in shared memory.
__global__ void egather_kernel(const int* __restrict__ tab,
                               const int* __restrict__ idx,
                               int* __restrict__ out, int ek, int en,
                               int reps) {
  extern __shared__ int s_row[];
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < ek; i += blockDim.x)
    s_row[i] = tab[(size_t)b * ek + i];
  __syncthreads();
  for (int n = threadIdx.x; n < en; n += blockDim.x) {
    const unsigned base = (unsigned)idx[(size_t)b * en + n];
    unsigned acc = 0;
    for (int r = 0; r < reps; ++r)
      acc += (unsigned)s_row[(base + (unsigned)r) & (unsigned)(ek - 1)];
    out[(size_t)b * en + n] = (int)acc;
  }
}

// out[r, :] = sum_{i < n} tab[off_i + r, :] for r < ROWS, where
// off_i = ((s + i * mul) * scale) & mask and a slice of SL >= ROWS rows is
// loaded each trip (the rows past ROWS are loaded and dropped, as the TPU
// kernel loads an (8, 128) slice and keeps its first row).
// One block of 128 threads.
template <int SL, int ROWS>
__global__ void dynslice_kernel(const int* __restrict__ tab,
                                const int* __restrict__ s_ptr,
                                int* __restrict__ out, int n, int mul,
                                int scale, int mask) {
  const int l = threadIdx.x;
  const unsigned s = (unsigned)*s_ptr;
  unsigned acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0;
  for (unsigned i = 0; i < (unsigned)n; ++i) {
    const unsigned off =
        ((s + i * (unsigned)mul) * (unsigned)scale) & (unsigned)mask;
    const int* p = tab + (size_t)off * RW + l;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] += (unsigned)p[r * RW];
#pragma unroll
    for (int r = ROWS; r < SL; ++r) {
      int dropped;    // performed: the compiler may not remove a volatile asm
      asm volatile("ld.global.s32 %0, [%1];"
                   : "=r"(dropped)
                   : "l"(__cvta_generic_to_global(p + r * RW)));
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) out[r * RW + l] = (int)acc[r];
}

// out[r, l] = sum_{i < n} tab[(idx[r, l] + i) & (rows - 1), l]
// grid: one block of 128 threads per index row; STAGE copies the table into
// shared memory first.
template <bool STAGE>
__global__ void colgather_kernel(const int* __restrict__ tab,
                                 const int* __restrict__ idx,
                                 int* __restrict__ out, int rows, int n) {
  extern __shared__ int s_tab[];
  const int l = threadIdx.x;
  if (STAGE) {
    for (int i = l; i < rows * RW; i += blockDim.x) s_tab[i] = tab[i];
    __syncthreads();
  }
  const int* t = STAGE ? s_tab : tab;
  const unsigned base = (unsigned)idx[(size_t)blockIdx.x * RW + l];
  const unsigned m = (unsigned)(rows - 1);
  unsigned acc = 0;
  for (unsigned i = 0; i < (unsigned)n; ++i)
    acc += (unsigned)t[(size_t)((base + i) & m) * RW + l];
  out[(size_t)blockIdx.x * RW + l] = (int)acc;
}

// block i writes x[8i : 8i + 8, :] + (base + i): an (8, 128) tile is 256
// threads x 16 bytes.
__global__ void gridstep_kernel(const int4* __restrict__ x,
                                int4* __restrict__ out, int base) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  const unsigned add = (unsigned)base + blockIdx.x;
  int4 v = x[i];
  v.x = (int)((unsigned)v.x + add);
  v.y = (int)((unsigned)v.y + add);
  v.z = (int)((unsigned)v.z + add);
  v.w = (int)((unsigned)v.w + add);
  out[i] = v;
}

// out[r, :] = sum_{i < n} hbm[off_i + r, :] for r < ROWS (8 or 1),
// off_i = ((s + 37 i) * 8) & mask: each trip copies the 8-row slice (4 KB)
// into shared memory with cp.async, waits for it, and adds from there.
// One block of 256 threads.
template <int ROWS>
__global__ void dmaloop_kernel(const int* __restrict__ hbm,
                               const int* __restrict__ s_ptr,
                               int* __restrict__ out, int n, int mask) {
  __shared__ __align__(16) int scratch[8 * RW];
  const int t = threadIdx.x, l = t & (RW - 1), half = t >> 7;
  const unsigned s = (unsigned)*s_ptr;
  unsigned acc[4] = {0, 0, 0, 0};
  for (unsigned i = 0; i < (unsigned)n; ++i) {
    const unsigned off = ((s + i * 37u) * 8u) & (unsigned)mask;
    __pipeline_memcpy_async(scratch + t * 4, hbm + (size_t)off * RW + t * 4,
                            16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();                   // every thread's 16 bytes have landed
    if (ROWS == 8) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] += (unsigned)scratch[(half * 4 + k) * RW + l];
    } else if (half == 0) {
      acc[0] += (unsigned)scratch[l];
    }
    __syncthreads();                   // before the next copy overwrites it
  }
  if (ROWS == 8) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(half * 4 + k) * RW + l] = (int)acc[k];
  } else if (half == 0) {
    out[l] = (int)acc[0];
  }
}

// out[:] = sum_{i < n} ((s + 7 i) & 1023), computed by one thread and
// written to all 1,024 words by the block.
__global__ void scalarloop_kernel(const int* __restrict__ s_ptr,
                                  int* __restrict__ out, int n) {
  __shared__ unsigned tot;
  if (threadIdx.x == 0) {
    const unsigned s = (unsigned)*s_ptr;
    unsigned acc = 0;
    for (unsigned i = 0; i < (unsigned)n; ++i) acc += (s + 7u * i) & 1023u;
    tot = acc;
  }
  __syncthreads();
  out[threadIdx.x] = (int)tot;
}

// out = x + acc_n, acc_0 = 0, acc_{i+1} = acc_i * 3 + i: every one of the
// block's 1,024 threads runs the chain.
__global__ void oneprog_kernel(const int* __restrict__ x,
                               int* __restrict__ out, int n) {
  unsigned acc = 0;
  for (unsigned i = 0; i < (unsigned)n; ++i) acc = acc * 3u + i;
  out[threadIdx.x] = (int)((unsigned)x[threadIdx.x] + acc);
}

// out[s, l] += sum_{r < passes} (v ^ (v >> min(r + 1, 31))) over this
// block's (8, 128) tile of v; out starts at 0. An arithmetic shift by 32 or
// more fills with the sign, which is the shift by 31.
// grid: one block of 1,024 threads per tile.
__global__ void vecwork_kernel(const int* __restrict__ v, int* out,
                               int passes) {
  const int x = v[(size_t)blockIdx.x * 1024 + threadIdx.x];
  unsigned acc = 0;
#pragma unroll 4
  for (int r = 0; r < passes; ++r) acc += (unsigned)(x ^ (x >> min(r + 1, 31)));
  atomicAdd((unsigned*)out + threadIdx.x, acc);
}

// ---- launchers: contiguous int32 tensors on the card; each launches on
// `stream` and returns the CUDA error code of the launch (0 = launched) ------

static inline bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// tab (rows, 128), idx (g, 128), out (g, 128); rows a power of two
extern "C" int micro_rowgather(const int* tab, const int* idx, int* out,
                               int g, int rows, int reps, void* stream) {
  if (g <= 0 || !pow2(rows) || reps < 0) return (int)cudaErrorInvalidValue;
  rowgather_kernel<<<g, RW, 0, (cudaStream_t)stream>>>(tab, idx, out,
                                                       rows - 1, reps);
  return (int)cudaGetLastError();
}

// tab (eb, ek), idx (eb, en), out (eb, en); ek a power of two, a row of the
// table within 48 KB of shared memory
extern "C" int micro_egather(const int* tab, const int* idx, int* out, int eb,
                             int ek, int en, int reps, void* stream) {
  if (eb <= 0 || en <= 0 || !pow2(ek) || ek > 12288 || reps < 0)
    return (int)cudaErrorInvalidValue;
  egather_kernel<<<eb, 512, (size_t)ek * sizeof(int), (cudaStream_t)stream>>>(
      tab, idx, out, ek, en, reps);
  return (int)cudaGetLastError();
}

// tab (rows, 128) with every off_i + sl <= rows (the caller checks), s (1,),
// out (rows_out, 128); (sl, rows_out) one of (8, 8), (8, 1), (1, 1)
extern "C" int micro_dynslice(const int* tab, const int* s, int* out, int n,
                              int mul, int scale, int mask, int sl,
                              int rows_out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (sl == 8 && rows_out == 8)
    dynslice_kernel<8, 8><<<1, RW, 0, st>>>(tab, s, out, n, mul, scale, mask);
  else if (sl == 8 && rows_out == 1)
    dynslice_kernel<8, 1><<<1, RW, 0, st>>>(tab, s, out, n, mul, scale, mask);
  else if (sl == 1 && rows_out == 1)
    dynslice_kernel<1, 1><<<1, RW, 0, st>>>(tab, s, out, n, mul, scale, mask);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// tab (rows, 128), idx (r, 128), out (r, 128); rows a power of two; stage:
// copy the table into shared memory (it must fit 48 KB)
extern "C" int micro_colgather(const int* tab, const int* idx, int* out,
                               int r, int rows, int n, int stage,
                               void* stream) {
  if (r <= 0 || !pow2(rows) || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (stage) {
    const size_t smem = (size_t)rows * RW * sizeof(int);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    colgather_kernel<true><<<r, RW, smem, st>>>(tab, idx, out, rows, n);
  } else {
    colgather_kernel<false><<<r, RW, 0, st>>>(tab, idx, out, rows, n);
  }
  return (int)cudaGetLastError();
}

// x and out (8 * nprog, 128), 16-byte aligned
extern "C" int micro_gridstep(const int* x, int* out, int nprog, int base,
                              void* stream) {
  if (nprog <= 0) return (int)cudaErrorInvalidValue;
  gridstep_kernel<<<nprog, 256, 0, (cudaStream_t)stream>>>(
      (const int4*)x, (int4*)out, base);
  return (int)cudaGetLastError();
}

// hbm (rows, 128) with mask + 8 < rows, 16-byte aligned; s (1,);
// out (rows_out, 128), rows_out 8 or 1
extern "C" int micro_dmaloop(const int* hbm, const int* s, int* out, int n,
                             int mask, int rows_out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows_out == 8)
    dmaloop_kernel<8><<<1, 256, 0, st>>>(hbm, s, out, n, mask);
  else if (rows_out == 1)
    dmaloop_kernel<1><<<1, 256, 0, st>>>(hbm, s, out, n, mask);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// s (1,), out (8, 128)
extern "C" int micro_scalarloop(const int* s, int* out, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  scalarloop_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(s, out, n);
  return (int)cudaGetLastError();
}

// x and out (8, 128)
extern "C" int micro_oneprog(const int* x, int* out, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  oneprog_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// v (8 * nblk, 128); out (8, 128), zeroed by the caller
extern "C" int micro_vecwork(const int* v, int* out, int nblk, int passes,
                             void* stream) {
  if (nblk <= 0 || passes < 0) return (int)cudaErrorInvalidValue;
  vecwork_kernel<<<nblk, 1024, 0, (cudaStream_t)stream>>>(v, out, passes);
  return (int)cudaGetLastError();
}
