// Primitive benches for Hopper: what a gather, dynamic-offset row loads, a
// block, an asynchronous copy and a launch cost.
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
// - dynslice_kernel: the trips are split over a grid that fills the card,
//   each block a contiguous range of them (the wrapper's split,
//   tools/micro.py grid_split). A warp loads each of its trips' rows
//   coalesced, 16 bytes a lane of a 512-byte row, from a table that stays
//   in device memory (2 MB: L2-resident, too large for shared memory, where
//   the TPU held it in VMEM), and sums them in registers; the block's sums
//   meet in shared memory and go into the zeroed output with one integer
//   atomicAdd per word, exact in any order. Every trip's summed rows are
//   loaded: the offsets are not closed in a formula, so the kernel stays
//   right for any offset sequence, as the library call does. Rows of a
//   slice that change no output (seven of K6.1a's eight) are not loaded,
//   so the 8-row and the 1-row slice of K6.1 run the same kernel. It does
//   not price a serial trip (PERF.md keeps what a one-block loop of them
//   cost); it is bound by how fast the SMs read the table's rows from
//   their caches.
// - rowgather/egather/colgather: a gather is native here, one load per
//   thread; tables that fit are staged in shared memory. Every trip's load
//   is performed.
// - gridstep_kernel: one block per TPU program, so its time over the grid
//   is the card's cost of scheduling a block; with one block it is the
//   empty kernel, the launch floor.
// - dmaloop_kernel: the TPU's make_async_copy of a 4-KB slice is cp.async
//   here, 16 bytes a thread over 256 threads (__pipeline_memcpy_async), and
//   every trip still copies its whole slice into shared memory. The trips
//   are split over a grid that fills the card (tools/micro.py
//   grid_split), each block a contiguous range of them, and a block keeps
//   DMA_STAGES - 1 copies in flight in a ring of DMA_STAGES slots: one
//   barrier a trip, after which the next copy goes into the slot every
//   thread has finished reading, where the one-block loop started, waited
//   and summed one copy at a time behind two barriers. Block sums go into
//   the zeroed output by integer atomicAdd, exact in any order. Not TMA:
//   cp.async's ring is enough to keep the copies in flight. Its 4-KB slices
//   come from a 16-MB table (8 MB of it addressed), so they are served
//   from L2.
// - scalarloop_kernel: the trips are split over a grid that fills the card
//   (grid_split), each thread taking every SL_THREADS-th trip of its
//   block's range, and every trip is computed (the offsets are not closed
//   in a formula, as the tool counts one add a trip). Warp sums by
//   __reduce_add_sync, the block's into a zeroed word by integer
//   atomicAdd; the last block to finish (a counter beside it) writes the
//   total to the 1,024 outputs.
// - oneprog_kernel: one block of 1,024 threads, each iterating the
//   dependent multiply-add chain. vecwork_kernel: a grid over all SMs, the
//   int32 elementwise rate.
//
// What bounds them: the one-block loop (oneprog), latency (dependent work
// by design); dynslice and dmaloop, L2 reads; scalarloop, the launch and
// its atomics; the gathers and vecwork, integer operations and L2 or
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

// out[r, :] += sum_{i in this block's trips} tab[off_i + r, :] for r < ROWS,
// off_i = ((s + i * mul) * scale) & mask; block b takes the trips
// [b * chunk, min(n, (b + 1) * chunk)), and out starts at 0. Warp w of the
// block takes every DS_WARPS-th trip from the range's start + w, U trips at
// a time so that U * ROWS row loads are in flight per lane.
#define DS_WARPS 8
template <int ROWS>
__global__ void __launch_bounds__(DS_WARPS * 32)
    dynslice_kernel(const int4* __restrict__ tab, const int* __restrict__ s_ptr,
                    int* __restrict__ out, int n, int chunk, int mul,
                    int scale, int mask) {
  constexpr int U = 8 / ROWS;
  __shared__ uint4 red[DS_WARPS][ROWS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned s = (unsigned)*s_ptr;
  const unsigned first = blockIdx.x * (unsigned)chunk;
  const unsigned last = min((unsigned)n, first + (unsigned)chunk);
  uint4 acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = make_uint4(0, 0, 0, 0);
  auto row = [&](unsigned i) {
    const unsigned off =
        ((s + i * (unsigned)mul) * (unsigned)scale) & (unsigned)mask;
    return tab + (size_t)off * (RW / 4) + lane;
  };
  auto add = [](uint4& a, int4 v) {
    a.x += (unsigned)v.x;
    a.y += (unsigned)v.y;
    a.z += (unsigned)v.z;
    a.w += (unsigned)v.w;
  };
  unsigned i = first + warp;
  for (; i + (U - 1) * DS_WARPS < last; i += U * DS_WARPS) {
    int4 v[U][ROWS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int4* p = row(i + u * DS_WARPS);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) v[u][r] = __ldg(p + r * (RW / 4));
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) add(acc[r], v[u][r]);
  }
  for (; i < last; i += DS_WARPS) {
    const int4* p = row(i);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) add(acc[r], __ldg(p + r * (RW / 4)));
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  for (int w = threadIdx.x; w < ROWS * RW; w += DS_WARPS * 32) {
    unsigned sum = 0;
#pragma unroll
    for (int k = 0; k < DS_WARPS; ++k)
      sum += ((const unsigned*)red[k][w / RW])[w % RW];
    atomicAdd((unsigned*)out + w, sum);
  }
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

// out[r, :] += sum_{i in this block's trips} hbm[off_i + r, :] for r < ROWS
// (8 or 1), off_i = ((s + 37 i) * 8) & mask; block b takes the trips
// [b * chunk, min(n, (b + 1) * chunk)), and out starts at 0. Trip k of the
// block copies its 8-row slice (4 KB) into ring slot k % DMA_STAGES with
// cp.async, DMA_STAGES - 1 trips ahead of the one being summed. 256
// threads, 16 bytes each a copy.
#define DMA_STAGES 4
template <int ROWS>
__global__ void __launch_bounds__(256)
    dmaloop_kernel(const int* __restrict__ hbm, const int* __restrict__ s_ptr,
                   int* __restrict__ out, int n, int chunk, int mask) {
  __shared__ __align__(16) int ring[DMA_STAGES][8 * RW];
  const int t = threadIdx.x, l = t & (RW - 1), half = t >> 7;
  const unsigned s = (unsigned)*s_ptr;
  const unsigned first = blockIdx.x * (unsigned)chunk;
  const int cnt = (int)(min((unsigned)n, first + (unsigned)chunk) - first);
  // one commit group a trip, empty past the range, so that group k is
  // always trip k
  auto fetch = [&](int k) {
    if (k < cnt) {
      const unsigned off = ((s + (first + k) * 37u) * 8u) & (unsigned)mask;
      __pipeline_memcpy_async(ring[k % DMA_STAGES] + t * 4,
                              hbm + (size_t)off * RW + t * 4, 16);
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int k = 0; k < DMA_STAGES - 1; ++k) fetch(k);
  unsigned acc[4] = {0, 0, 0, 0};
  for (int k = 0; k < cnt; ++k) {
    __pipeline_wait_prior(DMA_STAGES - 2);   // this thread's trip k landed
    __syncthreads();   // every thread's; and slot (k - 1) % DMA_STAGES read
    fetch(k + DMA_STAGES - 1);               // into that slot
    const int* slot = ring[k % DMA_STAGES];
    if (ROWS == 8) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] += (unsigned)slot[(half * 4 + j) * RW + l];
    } else if (half == 0) {
      acc[0] += (unsigned)slot[l];
    }
  }
  if (ROWS == 8) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      atomicAdd((unsigned*)out + (half * 4 + j) * RW + l, acc[j]);
  } else if (half == 0) {
    atomicAdd((unsigned*)out + l, acc[0]);
  }
}

// out[:] = sum_{i < n} ((s + 7 i) & 1023) as wrapping int32, in all 1,024
// words. Block b sums the trips [b * chunk, min(n, (b + 1) * chunk)), thread
// t of it every SL_THREADS-th from the range's start + t, into acc[0]
// (zeroed); acc[1] (zeroed) counts the blocks done, and the last one writes
// the total.
#define SL_THREADS 256
__global__ void __launch_bounds__(SL_THREADS)
    scalarloop_kernel(const int* __restrict__ s_ptr, unsigned* acc,
                      int* __restrict__ out, int n, int chunk) {
  __shared__ unsigned part[SL_THREADS / 32];
  __shared__ unsigned total;
  __shared__ bool last;
  const unsigned s = (unsigned)*s_ptr;
  const unsigned first = blockIdx.x * (unsigned)chunk;
  const unsigned end = min((unsigned)n, first + (unsigned)chunk);
  unsigned sum = 0;
  for (unsigned i = first + threadIdx.x; i < end; i += SL_THREADS)
    sum += (s + 7u * i) & 1023u;
  sum = __reduce_add_sync(0xFFFFFFFFu, sum);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned b = 0;
#pragma unroll
    for (int w = 0; w < SL_THREADS / 32; ++w) b += part[w];
    atomicAdd(acc, b);
    __threadfence();              // the sum is in before the block counts
    last = atomicAdd(acc + 1, 1u) == gridDim.x - 1;
    if (last) total = atomicAdd(acc, 0u);   // every block's sum is in
  }
  __syncthreads();
  if (last)
    for (int w = threadIdx.x; w < 8 * RW; w += SL_THREADS) out[w] = (int)total;
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

// the most blocks of one grid-split kernel the card holds at once (blocks
// per SM at full occupancy x SMs), for the wrapper's split: kernel 0
// dynslice<8>, 1 dynslice<1>, 2 dmaloop<8>, 3 dmaloop<1>, 4 scalarloop;
// -(CUDA error) on failure
extern "C" int micro_resident_blocks(int kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) switch (kernel) {
      case 0:
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dynslice_kernel<8>, DS_WARPS * 32, 0);
        break;
      case 1:
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dynslice_kernel<1>, DS_WARPS * 32, 0);
        break;
      case 2:
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dmaloop_kernel<8>, 256, 0);
        break;
      case 3:
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dmaloop_kernel<1>, 256, 0);
        break;
      case 4:
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, scalarloop_kernel, SL_THREADS, 0);
        break;
      default:
        e = cudaErrorInvalidValue;
    }
  return e == cudaSuccess ? per_sm * sms : -(int)e;
}

// a grid of `blocks` blocks of `chunk` trips covers n trips, the last block
// holding at least one
static inline bool split_ok(int n, int blocks, int chunk) {
  return n > 0 && blocks > 0 && chunk > 0 &&
         (long long)blocks * chunk >= n && (long long)(blocks - 1) * chunk < n;
}

// tab (rows, 128), 16-byte aligned, with every off_i + rows_out <= rows
// (the caller checks); s (1,); out (rows_out, 128) zeroed; blocks * chunk
// >= n > (blocks - 1) * chunk; rows_out 8 or 1
extern "C" int micro_dynslice(const int* tab, const int* s, int* out, int n,
                              int blocks, int chunk, int mul, int scale,
                              int mask, int rows_out, void* stream) {
  if (!split_ok(n, blocks, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int4* t4 = (const int4*)tab;
  if (rows_out == 8)
    dynslice_kernel<8><<<blocks, DS_WARPS * 32, 0, st>>>(t4, s, out, n, chunk,
                                                         mul, scale, mask);
  else if (rows_out == 1)
    dynslice_kernel<1><<<blocks, DS_WARPS * 32, 0, st>>>(t4, s, out, n, chunk,
                                                         mul, scale, mask);
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
// out (rows_out, 128) zeroed, rows_out 8 or 1; the split as for dynslice
extern "C" int micro_dmaloop(const int* hbm, const int* s, int* out, int n,
                             int blocks, int chunk, int mask, int rows_out,
                             void* stream) {
  if (!split_ok(n, blocks, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows_out == 8)
    dmaloop_kernel<8><<<blocks, 256, 0, st>>>(hbm, s, out, n, chunk, mask);
  else if (rows_out == 1)
    dmaloop_kernel<1><<<blocks, 256, 0, st>>>(hbm, s, out, n, chunk, mask);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// s (1,), acc (2,) zeroed, out (8, 128); the split as for dynslice
extern "C" int micro_scalarloop(const int* s, int* acc, int* out, int n,
                                int blocks, int chunk, void* stream) {
  if (!split_ok(n, blocks, chunk)) return (int)cudaErrorInvalidValue;
  scalarloop_kernel<<<blocks, SL_THREADS, 0, (cudaStream_t)stream>>>(
      s, (unsigned*)acc, out, n, chunk);
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
