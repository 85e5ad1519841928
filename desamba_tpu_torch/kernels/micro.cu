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
// - lgather_kernel (K6.2): the trips are split over a grid that fills the
//   card (tools/micro.py grid_split; two blocks of 1,024 threads a SM),
//   each block a contiguous range of them. A block stages the (32, 128)
//   table in shared memory once; each thread sums one output over every
//   trip of the range and adds it into the zeroed output with one integer
//   atomicAdd, exact in any order. A warp's 32 loads of a trip are 32
//   neighbouring columns, so they fall in 32 distinct banks (word
//   row * 128 + l lies in bank l % 32). Bound: each SM's shared memory
//   serves one 128-byte warp load a clock, 132 x 128 B x 1.98 GHz = 33.45
//   TB/s, so K6.2's 2^21 x 1,024 loads take at least 0.257 ms, twice its
//   operations bound. The loop is issue-bound near that floor, so a trip's
//   address costs two instructions: the table sits at a shared-space
//   address aligned to its size (the block takes twice the table), and the
//   next row is an add and one mask-and-OR (LOP3) of the address, loaded
//   by PTX ld.shared with no window base added (a C++ pointer into shared
//   memory added it, a third instruction a trip, and ran slower).
//   Every trip's gather is a load from shared memory: nothing is folded by
//   the table's period and no address is loop-invariant. SASS (cuobjdump,
//   sm_90a): the trip loop runs 8 trips in 32 instructions, 8 LDS, a
//   VIADD and a LOP3 for each trip's address, 4 IADD3 that add two loads
//   each, and the loop's count and branch.
// - oneprog_kernel (K5.c): acc_{i+1} = 3 acc_i + i is the affine map
//   a -> 3 a + i, so each thread folds a contiguous span of trips into a
//   map a -> A a + B, one trip at a time (A <- 3 A, B <- 3 B + i), and the
//   maps are composed in trip order (composition is associative, not
//   commutative): a block's as a tree in shared memory, the blocks' by the
//   last block to finish (a counter and __threadfence, as scalarloop);
//   acc_n is the composed B. The trips are split over a grid (grid_split,
//   at least 2,048 trips a block of 256 threads: 256 blocks at n = 2^19).
//   Not one block: its 512 steps a thread are few, but 32 warps x 512 x
//   ~2.3 instructions on one SM's four schedulers are issue-bound; over
//   the card the kernel is its launch, 8 steps a thread, a fence and the
//   last block's tree. SASS: B's step is one IMAD (3 B + i) and an add of
//   the unrolled trip's offset to i, every trip; the compiler merges A's
//   updates of 16 unrolled trips into one multiply by 3^16, A's own
//   arithmetic, which the chain does not need.
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
// - rgather_kernel (K6.3): the 2-MB table is too large to stage whole, so
//   a block stages one column (16 KB at 4,096 rows) in a run of shared
//   words and takes a range of the trips for every output of that column;
//   the 128 columns x the trip ranges (tools/micro.py grid_split) take one
//   block of 1,024 threads a SM (a second block on a SM would stage a
//   second column for no more loads a clock), one range a column on 132
//   SMs. A warp takes one output at a time, its 32 lanes 32
//   consecutive trips, so a warp's 32 loads are 32 consecutive words of
//   the column: 32 banks, no conflict. The staged column runs RG_PAD rows
//   past its end (rows 0, 1, ... again), so a lane's RG_UNROLL loads from
//   any start row below `rows` need no wrap: each is an LDS at an
//   immediate offset from one address, and the start row is wrapped once
//   per RG_UNROLL trips (an add and a mask). The warp's sum goes through
//   __reduce_add_sync, and lane 0 adds it into the zeroed output by
//   integer atomicAdd, exact in any order. One column a block, not a group:
//   a block of 8 columns (one 32-byte sector of a row) fills the card with
//   8 trip ranges a column group, so every output pays its setup and its
//   warp sum 8 times for 1,024 trips each, and ran slower (PERF.md).
//   Bound: the card's shared-memory rate, as for K6.2: 2^28 loads of 4 B
//   at 33.45 TB/s take at least 0.0321 ms, twice the operations bound.
//   Staging reads every row's 32-byte sector for one word of it (128 x
//   4,352 sectors, 17.8 MB from L2), a few microseconds not overlapped
//   with the trips. Every trip's gather is a load from shared memory:
//   nothing is folded by the column's period.
// - egather_kernel (K4.2): 4,096 outputs, each the sum of an 80-byte
//   window of its 16-KB table row; the whole 128-KB table stays in L2
//   across calls. What bounds it is the launch and its chain of dependent
//   loads, not bytes. Where one block a table row (8 blocks) loaded its row
//   into shared memory before it loaded an index, a thread's chain was the
//   strided staging loop, a barrier, then its index, then its window. Here
//   the row's 16-byte words go by cp.async into shared memory of 4 blocks
//   a row (32 blocks of 128 threads, a thread an output) while each thread
//   loads its index: one round trip for both, one barrier, then the window
//   from shared memory. The other candidate, a group of 8 threads an
//   output loading its window straight from L2 with no staging, pays two
//   dependent round trips (the index, then the window) and ran 1.06x and
//   1.08x slower in two runs on the card (PERF.md).
// - rowgather_kernel (K4.1): 256 outputs, each the sum of 20 rows of 512
//   bytes gathered from a 2-MB table that stays in L2 across calls. What
//   bounds it is the launch and its chain of dependent loads: the row's
//   index, then its rows. A block a row of 128 threads loaded the index
//   and then walked the rows in a loop of runtime length, a few loads in
//   flight at a time. Here a warp takes a row, its lanes 16 bytes each of
//   a 512-byte row, and after the one index load issues all RG4_UNROLL
//   (20, the tool's count) row loads at once, unrolled at compile time,
//   with a runtime loop for any further groups and a tail. One warp a
//   block (256 blocks for the tool's 256 rows): on the card it ran 2.02
//   us against the parent's 2.34 in one call, where two warps a block ran
//   2.44 against the parent's 2.38 in another (PERF.md); what is left is
//   the launch, the index's round trip and the rows' (2.6 MB from L2).
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
// - vecwork_kernel: a grid over all SMs, the int32 elementwise rate.
//
// What bounds the rest: dynslice and dmaloop, L2 reads; scalarloop, the
// launch and its atomics; the other gathers and vecwork, integer
// operations and L2 or shared-memory loads. None is near the card's memory
// rate.
#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_pipeline.h>
#endif

#define RW 128   // row width (lanes) of every table

// The five kernels below (and their helpers) also compile as host C++
// (tests/cuda_host/micro_emu.cpp runs them over block_emu.h); the rest of
// the file needs nvcc (__CUDACC__).

static inline bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// a grid of `blocks` blocks of `chunk` trips covers n trips, the last block
// holding at least one
static inline bool split_ok(int n, int blocks, int chunk) {
  return n > 0 && blocks > 0 && chunk > 0 &&
         (long long)blocks * chunk >= n && (long long)(blocks - 1) * chunk < n;
}

// A 32-bit load from the shared-space address a (on the card one LDS
// whose address is a itself, with no window base added in the loop).
__device__ __forceinline__ unsigned ld_shared_u32(unsigned a) {
#ifdef __CUDA_ARCH__
  unsigned v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
#else
  return *(const unsigned*)__cvta_shared_to_generic(a);
#endif
}

// out[r, l] += sum over this block's trips i of
// tab[(idx[r, l] + i) & (rows - 1), l], for the nout = r * 128 outputs;
// block b takes the trips [b * chunk, min(n, (b + 1) * chunk)), and out
// starts at 0. The block stages the table in shared memory at a
// shared-space address aligned to the table's size (so the dynamic shared
// memory is twice the table), which lets one mask and one OR wrap a
// trip's address; thread t sums outputs t, t + blockDim, ... over every
// trip of the range.
#define LG_THREADS 1024
__global__ void __launch_bounds__(LG_THREADS)
    lgather_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                   int* __restrict__ out, int rows, int nout, int n,
                   int chunk) {
  extern __shared__ int s_lg[];
  const unsigned size = (unsigned)rows * RW * 4u;   // bytes, a power of two
  const unsigned s0 = (unsigned)__cvta_generic_to_shared(s_lg);
  const unsigned at = (s0 + size - 1) & ~(size - 1);
  int* t = s_lg + (at - s0) / 4;
  for (int w = threadIdx.x; w < rows * RW; w += blockDim.x) t[w] = tab[w];
  __syncthreads();
  const unsigned first = blockIdx.x * (unsigned)chunk;
  const unsigned cnt = min((unsigned)n, first + (unsigned)chunk) - first;
  for (int o = threadIdx.x; o < nout; o += blockDim.x) {
    // trip `first`'s word: row (idx + first) & (rows - 1), column o % 128
    unsigned a = at | (((((unsigned)idx[o] + first) & (unsigned)(rows - 1)) *
                        RW + (unsigned)(o & (RW - 1))) * 4u);
    unsigned acc = 0;
#pragma unroll 8
    for (unsigned i = 0; i < cnt; ++i) {
      acc += ld_shared_u32(a);
      a = ((a + RW * 4u) & (size - 1)) | at;   // the next row, wrapped
    }
    atomicAdd((unsigned*)out + o, acc);
  }
}

// out[o, l] += sum over this block's trips i of
// tab[(idx[o, l] + i) & (rows - 1), l] for the r outputs o of column l =
// b / splits of block b, which takes the trips [k * chunk, min(n, (k + 1) *
// chunk)), k = b % splits; out starts at 0. Shared memory (dynamic,
// rg_smem bytes): the column staged, its row j (j < rows + RG_PAD) at word
// j holding tab[j & (rows - 1), l]. Lane k of a warp takes the trips
// first + k + 32 m of the warp's output.
#define RG_THREADS 1024
#define RG_UNROLL 8        // a lane's loads from one address
#define RG_PAD 256         // rows a staged column runs on: RG_UNROLL steps
#define RG_MAX_SMEM 232448 // a block's shared memory, bytes (227 KB)
#define RG_BATCH 8         // a thread's loads in flight while staging
static_assert(RG_PAD == 32 * RG_UNROLL, "a lane's loads stay in the pad");

static inline long long rg_smem(int rows) { return 4LL * (rows + RG_PAD); }
// what micro_rgather launches: r >= 1 output rows, rows a power of two
// whose staged column fits a block, and `splits` ranges of `chunk` trips
// that cover n
static inline bool rg_args_ok(int r, int rows, int n, int splits,
                              int chunk) {
  return r > 0 && pow2(rows) && rg_smem(rows) <= RG_MAX_SMEM &&
         split_ok(n, splits, chunk);
}

__global__ void __launch_bounds__(RG_THREADS)
    rgather_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                   int* __restrict__ out, int rows, int r, int n, int splits,
                   int chunk) {
  extern __shared__ unsigned s_rg[];
  const unsigned mask = (unsigned)(rows - 1);
  const int l = (int)(blockIdx.x / splits);
  const unsigned first = (blockIdx.x % splits) * (unsigned)chunk;
  const unsigned cnt = min((unsigned)n, first + (unsigned)chunk) - first;
  // stage the column, RG_BATCH loads in flight a thread
  const int words = rows + RG_PAD;
  for (int j0 = threadIdx.x; j0 < words; j0 += RG_BATCH * blockDim.x) {
    unsigned v[RG_BATCH];
#pragma unroll
    for (int k = 0; k < RG_BATCH; ++k) {
      const int j = j0 + k * (int)blockDim.x;
      v[k] = j < words ? (unsigned)tab[(size_t)((unsigned)j & mask) * RW + l]
                       : 0u;
    }
#pragma unroll
    for (int k = 0; k < RG_BATCH; ++k) {
      const int j = j0 + k * (int)blockDim.x;
      if (j < words) s_rg[j] = v[k];
    }
  }
  __syncthreads();
  const unsigned lane = threadIdx.x & 31;
  const unsigned steps = cnt > lane ? (cnt - lane + 31) / 32 : 0;
  const int warps = (int)(blockDim.x / 32);
  int o = (int)(threadIdx.x / 32);
  unsigned next = o < r ? (unsigned)idx[o * RW + l] : 0u;
  for (; o < r; o += warps) {
    const unsigned start = next;
    if (o + warps < r) next = (unsigned)idx[(o + warps) * RW + l];
    unsigned p = (start + first + lane) & mask, acc = 0;
    for (unsigned g = steps / RG_UNROLL; g; --g) {
#pragma unroll
      for (int u = 0; u < RG_UNROLL; ++u) acc += s_rg[p + 32 * u];
      p = (p + RG_PAD) & mask;
    }
    for (unsigned u = 0; u < steps % RG_UNROLL; ++u) acc += s_rg[p + 32 * u];
    acc = __reduce_add_sync(0xFFFFFFFFu, acc);
    if (lane == 0) atomicAdd((unsigned*)out + o * RW + l, acc);
  }
}

// The maps a -> A a + B of a block's threads, (a, b) thread t's, composed
// in thread order into (pa[0], pb[0]), a tree in shared memory: at level s
// thread t's span is followed by the span s threads on, and (A2, B2) after
// (A1, B1) is (A2 A1, A2 B1 + B2). Every thread of the block calls it.
__device__ void compose_maps(unsigned* pa, unsigned* pb, unsigned a,
                             unsigned b) {
  const unsigned t = threadIdx.x, nt = blockDim.x;
  pa[t] = a;
  pb[t] = b;
  for (unsigned s = 1; s < nt; s <<= 1) {
    __syncthreads();
    if ((t & (2 * s - 1)) == 0 && t + s < nt) {
      const unsigned a2 = pa[t + s], b2 = pb[t + s];
      pb[t] = a2 * pb[t] + b2;
      pa[t] = a2 * pa[t];
    }
  }
  __syncthreads();
}

// out = x + acc_n for the (8, 128) tile x, acc_0 = 0, acc_{i+1} = 3 acc_i + i
// (mod 2^32). Block b takes the trips [b * chunk, min(n, (b + 1) * chunk)),
// thread t of it a contiguous span of ceil(trips / blockDim) of them, which
// it folds into the map a -> A a + B one trip at a time; the block's maps
// compose in trip order into one, which goes into maps[2 b], maps[2 b + 1]
// (scratch); count (zeroed) counts the blocks done, and the last one
// composes the blocks' maps in block order and writes x + the composed B
// (the map applied to acc_0 = 0). Shared memory (dynamic): two words a
// thread and the last-block flag.
#define OP_THREADS 256
__global__ void __launch_bounds__(OP_THREADS)
    oneprog_kernel(const int* __restrict__ x, unsigned* count,
                   unsigned* maps, int* __restrict__ out, int n, int chunk) {
  extern __shared__ unsigned s_op[];
  const unsigned t = threadIdx.x, nt = blockDim.x;
  unsigned* pa = s_op;
  unsigned* pb = s_op + nt;
  unsigned* last = s_op + 2 * nt;
  const unsigned first = blockIdx.x * (unsigned)chunk;
  const unsigned cnt = min((unsigned)n, first + (unsigned)chunk) - first;
  const unsigned c = (cnt + nt - 1) / nt;
  const unsigned hi = first + min(cnt, t * c + c);
  unsigned a = 1, b = 0;
  for (unsigned i = first + min(cnt, t * c); i < hi; ++i) {
    a *= 3u;
    b = b * 3u + i;
  }
  compose_maps(pa, pb, a, b);
  if (t == 0) {
    maps[2 * blockIdx.x] = pa[0];
    maps[2 * blockIdx.x + 1] = pb[0];
    __threadfence();              // the map is out before the block counts
    *last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!*last) return;
  // every block's map is out: thread t composes a contiguous run of them
  // (read past L1, which may hold none of this launch's words)
  const unsigned g = gridDim.x, cb = (g + nt - 1) / nt;
  a = 1;
  b = 0;
  for (unsigned k = min(g, t * cb); k < min(g, t * cb + cb); ++k) {
    const unsigned a2 = __ldcg(maps + 2 * k), b2 = __ldcg(maps + 2 * k + 1);
    b = a2 * b + b2;
    a = a2 * a;
  }
  compose_maps(pa, pb, a, b);
  for (unsigned w = t; w < 8 * RW; w += nt)
    out[w] = (int)((unsigned)x[w] + pb[0]);
}

// out[g, :] = sum_{r < reps} tab[(idx[g, 0] + r) & row_mask, :], a warp a
// gathered row (blockDim.x / 32 rows a block), lane l summing columns
// 4 l .. 4 l + 3: one 16-byte load a row where tab and out are 16-byte
// aligned (WIDE), else four 4-byte ones. Sums wrap as int32 (unsigned).
#define RG4_WARPS 1       // warps (gathered rows) a block
#define RG4_UNROLL 20     // row loads in flight after the index: the tool's

template <bool WIDE>
__device__ __forceinline__ int4 rg4_load(const int* p) {
  if (WIDE) return __ldg((const int4*)p);
  return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <bool WIDE>
__global__ void __launch_bounds__(RG4_WARPS * 32)
    rowgather_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                     int* __restrict__ out, int g, int row_mask, int reps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= g) return;
  const unsigned base = (unsigned)__ldg(idx + (size_t)row * RW);
  const unsigned mask = (unsigned)row_mask;
  const int* col = tab + 4 * lane;
  unsigned s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int r = 0;
  for (; r + RG4_UNROLL <= reps; r += RG4_UNROLL) {
    int4 v[RG4_UNROLL];
#pragma unroll
    for (int u = 0; u < RG4_UNROLL; ++u)
      v[u] = rg4_load<WIDE>(col +
                            (size_t)((base + (unsigned)(r + u)) & mask) * RW);
#pragma unroll
    for (int u = 0; u < RG4_UNROLL; ++u) {
      s0 += (unsigned)v[u].x;
      s1 += (unsigned)v[u].y;
      s2 += (unsigned)v[u].z;
      s3 += (unsigned)v[u].w;
    }
  }
  for (; r < reps; ++r) {
    const int4 v =
        rg4_load<WIDE>(col + (size_t)((base + (unsigned)r) & mask) * RW);
    s0 += (unsigned)v.x;
    s1 += (unsigned)v.y;
    s2 += (unsigned)v.z;
    s3 += (unsigned)v.w;
  }
  int* o = out + (size_t)row * RW + 4 * lane;
  if (WIDE) {
    *(int4*)o = make_int4((int)s0, (int)s1, (int)s2, (int)s3);
  } else {
    o[0] = (int)s0;
    o[1] = (int)s1;
    o[2] = (int)s2;
    o[3] = (int)s3;
  }
}

// out[b, n] = sum_{r < reps} tab[b, (idx[b, n] + r) & (ek - 1)]. Grid
// (eb, en / EG_THREADS): block (b, k) takes outputs k * EG_THREADS ... of
// row b, a thread an output. Each thread loads its index first; meanwhile
// the block stages row b in shared memory by asynchronous copies (cp.async,
// 16 bytes each where the row is whole 16-byte words, else 4), so the
// index and the row come in one round trip; after one barrier each thread
// sums its window from shared memory.
#define EG_THREADS 128
#define EG_MAX_EK 12288   // words of a staged row: 48 KB of shared memory

static inline bool egather_args_ok(int eb, int ek, int en, int reps) {
  return eb > 0 && en > 0 && pow2(ek) && ek <= EG_MAX_EK && reps >= 0 &&
         (en + EG_THREADS - 1) / EG_THREADS <= 65535;
}

__global__ void __launch_bounds__(EG_THREADS)
    egather_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                   int* __restrict__ out, int ek, int en, int reps,
                   int wide) {
  extern __shared__ __align__(16) int s_eg[];
  const int b = blockIdx.x, n = blockIdx.y * blockDim.x + threadIdx.x;
  const unsigned base =
      n < en ? (unsigned)__ldg(idx + (size_t)b * en + n) : 0u;
  const int* row = tab + (size_t)b * ek;
  if (wide) {
    for (int i = threadIdx.x; i < ek / 4; i += blockDim.x)
      __pipeline_memcpy_async((int4*)s_eg + i, (const int4*)row + i, 16);
  } else {
    for (int i = threadIdx.x; i < ek; i += blockDim.x)
      __pipeline_memcpy_async(s_eg + i, row + i, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (n >= en) return;
  unsigned acc = 0;
  for (int r = 0; r < reps; ++r)
    acc += (unsigned)s_eg[(base + (unsigned)r) & (unsigned)(ek - 1)];
  out[(size_t)b * en + n] = (int)acc;
}

#ifdef __CUDACC__

#define OP_SMEM ((2 * OP_THREADS + 1) * sizeof(unsigned))

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

// tab (rows, 128), idx (g, 128), out (g, 128); rows a power of two
extern "C" int micro_rowgather(const int* tab, const int* idx, int* out,
                               int g, int rows, int reps, void* stream) {
  if (g <= 0 || !pow2(rows) || reps < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (g + RG4_WARPS - 1) / RG4_WARPS;
  const bool wide = ((size_t)tab & 15) == 0 && ((size_t)out & 15) == 0;
  (wide ? rowgather_kernel<true> : rowgather_kernel<false>)
      <<<blocks, RG4_WARPS * 32, 0, (cudaStream_t)stream>>>(
          tab, idx, out, g, rows - 1, reps);
  return (int)cudaGetLastError();
}

// tab (eb, ek), idx (eb, en), out (eb, en); ek a power of two, a row of the
// table within 48 KB of shared memory
extern "C" int micro_egather(const int* tab, const int* idx, int* out, int eb,
                             int ek, int en, int reps, void* stream) {
  if (!egather_args_ok(eb, ek, en, reps)) return (int)cudaErrorInvalidValue;
  const int wide = ek % 4 == 0 && ((size_t)tab & 15) == 0;
  egather_kernel<<<dim3(eb, (en + EG_THREADS - 1) / EG_THREADS), EG_THREADS,
                   (size_t)ek * sizeof(int), (cudaStream_t)stream>>>(
      tab, idx, out, ek, en, reps, wide);
  return (int)cudaGetLastError();
}

// lgather_kernel may take `smem` bytes of dynamic shared memory (above
// 48 KB only after opting in)
static cudaError_t lgather_opt_in(int smem) {
  return smem <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(lgather_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem);
}

// the most blocks of one grid-split kernel the card holds at once (blocks
// per SM at full occupancy x SMs), for the wrapper's split: kernel 0
// dynslice<8>, 1 dynslice<1>, 2 dmaloop<8>, 3 dmaloop<1>, 4 scalarloop,
// 5 lgather with `smem` bytes of dynamic shared memory a block, 6 oneprog;
// -(CUDA error) on failure
extern "C" int micro_resident_blocks(int kernel, int smem) {
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
      case 5:
        e = lgather_opt_in(smem);
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, lgather_kernel, LG_THREADS, smem);
        break;
      case 6:
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, oneprog_kernel, OP_THREADS, OP_SMEM);
        break;
      default:
        e = cudaErrorInvalidValue;
    }
  return e == cudaSuccess ? per_sm * sms : -(int)e;
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

// tab (rows, 128), idx (r, 128), out (r, 128) zeroed; one column staged a
// block (rg_args_ok); `splits` ranges of `chunk` trips cover n, as for
// dynslice, for each of the 128 columns
extern "C" int micro_rgather(const int* tab, const int* idx, int* out, int r,
                             int rows, int n, int splits, int chunk,
                             void* stream) {
  if (!rg_args_ok(r, rows, n, splits, chunk))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)rg_smem(rows);   // above 48 KB only after opting in
  const cudaError_t e =
      smem <= 48 * 1024
          ? cudaSuccess
          : cudaFuncSetAttribute(rgather_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
  if (e != cudaSuccess) return (int)e;
  rgather_kernel<<<splits * RW, RG_THREADS, smem, (cudaStream_t)stream>>>(
      tab, idx, out, rows, r, n, splits, chunk);
  return (int)cudaGetLastError();
}

// tab (rows, 128), rows a power of two, staged in shared memory (the
// table within 48 KB, twice its size a block); idx (r, 128); out (r, 128)
// zeroed; the split as for dynslice
extern "C" int micro_lgather(const int* tab, const int* idx, int* out, int r,
                             int rows, int n, int blocks, int chunk,
                             void* stream) {
  const int smem = 2 * rows * RW * (int)sizeof(int);
  if (r <= 0 || !pow2(rows) || smem > 96 * 1024 ||
      !split_ok(n, blocks, chunk))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = lgather_opt_in(smem);
  if (e != cudaSuccess) return (int)e;
  lgather_kernel<<<blocks, LG_THREADS, smem, (cudaStream_t)stream>>>(
      tab, idx, out, rows, r * RW, n, chunk);
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

// x and out (8, 128); scratch (1 + 2 * blocks,) zeroed; the split as for
// dynslice
extern "C" int micro_oneprog(const int* x, int* scratch, int* out, int n,
                             int blocks, int chunk, void* stream) {
  if (!split_ok(n, blocks, chunk)) return (int)cudaErrorInvalidValue;
  oneprog_kernel<<<blocks, OP_THREADS, OP_SMEM, (cudaStream_t)stream>>>(
      x, (unsigned*)scratch, (unsigned*)scratch + 1, out, n, chunk);
  return (int)cudaGetLastError();
}

// v (8 * nblk, 128); out (8, 128), zeroed by the caller
extern "C" int micro_vecwork(const int* v, int* out, int nblk, int passes,
                             void* stream) {
  if (nblk <= 0 || passes < 0) return (int)cudaErrorInvalidValue;
  vecwork_kernel<<<nblk, 1024, 0, (cudaStream_t)stream>>>(v, out, passes);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
