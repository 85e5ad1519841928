// Capability probes for Hopper: one tiny kernel per probe body.
//
// Replaces the Pallas calls of tools/pallas_caps.py: `call` (pl.pallas_call
// at :36, twelve kernel bodies run as thirteen probes), `f_smem` (:153, a
// 1-element output) and `f_s2` (:225, a (1, 1) scalar operand). On the TPU
// a probe asked whether a primitive lowers at all. Here everything
// compiles, so a probe asks whether the card's form of the primitive is
// right: a gather is an indexed load, a dynamic roll or slice is index
// arithmetic, a reduction or a scan across lanes is warp collectives and
// one barrier, a scalar operand is a one-word load. Indices and starts
// follow the JAX body's rules in interpret mode: take_along_axis counts a
// negative index from the end and reads INT32_MIN for one still outside;
// a dynamic slice or row write counts a negative start from the end and
// clamps it so that the slice lies inside.
//
// One block of 128 threads (thread = lane) over an (8, 128) int32 output
// tile, inputs read from device memory; the elementwise probes (p_u32,
// p_u8) take 16-byte words of the tile, and p_s2 is one block of 256
// threads, each one 16-byte load and store. What bounds them: the launch
// (NVIDIA H100: 1.21 us in a replayed CUDA graph, PERF.md) and the chain of
// dependent loads; each moves a few KB. So every pointer is __restrict__,
// and a probe issues the loads of all 8 rows before its first store: a
// register a row, and where an address needs a loaded word (a gather's
// index, a slice's start) one round trip for the words, then one for the
// rows. The reductions and the scan take all 8 rows at once: a warp
// collective a row, the 4 warps' partial results in shared memory, one
// barrier.
//
// The probe bodies compile as host C++ too (tests/cuda_host/caps_emu.cpp
// runs them over block_emu.h); the launcher needs nvcc (__CUDACC__).
#include "plops.cuh"

#define ROWS 8
#define WARPS (po::LANES / 32)
#define FULL 0xffffffffu
#define S2_THREADS 256
#define N_PROBES 13     // the PROBE kernels of caps_launch's table; p_s2 is
                        // probe N_PROBES

#define PROBE(name)                                                     \
  __global__ void __launch_bounds__(po::LANES)                          \
      name(const int* __restrict__ a, const int* __restrict__ b,        \
           int* __restrict__ out, int n)
#define AT(r) ((r) * po::LANES + l)

// v[r] = a[r, l] for the 8 rows: every load issued before any is used
__device__ __forceinline__ void load_rows(const int* __restrict__ a, int l,
                                          int (&v)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = a[AT(r)];
}
__device__ __forceinline__ void store_rows(int* __restrict__ out, int l,
                                           const int (&v)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) out[AT(r)] = v[r];
}
// take_along_axis's index into n entries: a negative one counts from the
// end (the caller reads INT32_MIN where the result is still outside)
__device__ __forceinline__ int take_index(int i, int n) {
  return i < 0 ? i + n : i;
}
// a dynamic start of a `size`-long slice of n entries: a negative one
// counts from the end, then clamped so that the slice lies inside
__device__ __forceinline__ int slice_start(int s, int n, int size) {
  return min(max(s < 0 ? s + n : s, 0), n - size);
}

// a, b: the probe's inputs (b is its index tile or its scalars, and repeats
// a where there is one input); n: the row count of a for p_take0.

// :50 take_along_axis along rows: out[r, l] = a[b[r, l], l]; the eight
// index loads, then the eight table loads
PROBE(p_take0) {
  const int l = po::lane_iota();
  int v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = take_index(b[AT(r)], n);
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    v[r] = (unsigned)v[r] < (unsigned)n ? a[v[r] * po::LANES + l]
                                        : po::I32_MIN;
  store_rows(out, l, v);
}
// :73 take_along_axis along lanes: out[r, l] = a[r, b[r, l]]
PROBE(p_take1) {
  const int l = po::lane_iota();
  int v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = take_index(b[AT(r)], po::LANES);
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    v[r] = (unsigned)v[r] < (unsigned)po::LANES ? a[r * po::LANES + v[r]]
                                                : po::I32_MIN;
  store_rows(out, l, v);
}
// :87 roll by b[0] along lanes: out[r, l] = a[r, l - s]. The rows and the
// shift are loaded at once; the rows go through shared memory, since a
// lane reads another warp's word.
PROBE(p_roll1) {
  __shared__ int tile[ROWS * po::LANES];
  const int l = po::lane_iota();
  const unsigned s = (unsigned)b[0];
  int v[ROWS];
  load_rows(a, l, v);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) tile[AT(r)] = v[r];
  __syncthreads();
  const int src = (int)(((unsigned)l - s) & (po::LANES - 1));
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = tile[r * po::LANES + src];
  store_rows(out, l, v);
}
// :97 roll by b[0] along rows: out[r, l] = a[r - s, l]. The rows and the
// shift are loaded at once; the rows rotate in registers by s mod 8, one
// select stage a bit of it.
PROBE(p_roll0) {
  const int l = po::lane_iota();
  const unsigned t = (unsigned)b[0] & (ROWS - 1);
  int v[ROWS];
  load_rows(a, l, v);
#pragma unroll
  for (int k = 1; k < ROWS; k <<= 1) {
    int w[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) w[r] = (t & k) ? v[(r - k) & (ROWS - 1)]
                                                  : v[r];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) v[r] = w[r];
  }
  store_rows(out, l, v);
}
// :111 a (8, 512): out = a[:, o : o + 128], o = b[0] as a start
PROBE(p_lane_ds) {
  const int l = po::lane_iota();
  const int o = slice_start(b[0], 512, po::LANES);
  int v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = a[r * 512 + o + l];
  store_rows(out, l, v);
}
// :121 a (64, 512): the (8, 128) slice at (b[0], b[1]) as starts
PROBE(p_ds2d) {
  const int l = po::lane_iota();
  const int o0 = slice_start(b[0], 64, ROWS);
  const int o1 = slice_start(b[1], 512, po::LANES);
  int v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = a[(o0 + r) * 512 + o1 + l];
  store_rows(out, l, v);
}
// :137 uint32 xor-shift, multiply, shift; thread t takes 16-byte words t
// and t + 128 of the tile
__device__ __forceinline__ int u32hash(int x) {
  unsigned v = (unsigned)x;
  v ^= v >> 7;
  v *= 0x9E3779B1u;
  return (int)(v >> 16);
}
PROBE(p_u32) {
  const int t = threadIdx.x;
  const int4* __restrict__ a4 = (const int4*)a;
  int4* __restrict__ o4 = (int4*)out;
  int4 x[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) x[k] = a4[k * po::LANES + t];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    o4[k * po::LANES + t] = make_int4(u32hash(x[k].x), u32hash(x[k].y),
                                      u32hash(x[k].z), u32hash(x[k].w));
}
// :148 the tile's sum into a 1-element output
PROBE(p_sum) {
  __shared__ int scratch[4];
  const int l = po::lane_iota();
  unsigned col = 0;
  for (int r = 0; r < ROWS; ++r) col += (unsigned)a[AT(r)];
  const int tot = po::block_sum((int)col, scratch);
  if (l == 0) out[0] = tot;
}
// :163 a while loop with a scalar state and row reads: every row's sum in
// one batched reduction first, then the loop reads them
PROBE(p_while) {
  __shared__ unsigned part[ROWS][WARPS];
  const int l = po::lane_iota();
  int v[ROWS];
  load_rows(a, l, v);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const unsigned s = __reduce_add_sync(FULL, (unsigned)v[r]);
    if ((l & 31) == 0) part[r][l >> 5] = s;
  }
  __syncthreads();
  int i = 0;
  unsigned acc = 0;
  while (i < ROWS) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += part[i][w];
    i += 1;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = (int)acc;
  store_rows(out, l, v);
}
// :183 a (32, 128) uint8: out = int32(a)[:8] + 1; thread t takes bytes
// 4t.. and 512 + 4t.. of the first 8 rows, so 16-byte words t and t + 128
// of the output
PROBE(p_u8) {
  const int t = threadIdx.x;
  const unsigned* __restrict__ a32 = (const unsigned*)a;
  int4* __restrict__ o4 = (int4*)out;
  unsigned x[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) x[k] = a32[k * po::LANES + t];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    o4[k * po::LANES + t] = make_int4(
        (int)(x[k] & 255u) + 1, (int)((x[k] >> 8) & 255u) + 1,
        (int)((x[k] >> 16) & 255u) + 1, (int)(x[k] >> 24) + 1);
}
// :191 max + (first) argmax along lanes, to every lane: each warp's max of
// a row and the first of its lanes that holds it, then the first warp
// with the row's max
PROBE(p_argmax) {
  __shared__ int wmax[ROWS][WARPS], wlane[ROWS][WARPS];
  const int l = po::lane_iota();
  int v[ROWS];
  load_rows(a, l, v);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int m = __reduce_max_sync(FULL, v[r]);
    const unsigned hit = __ballot_sync(FULL, v[r] == m);
    if ((l & 31) == 0) {
      wmax[r][l >> 5] = m;
      wlane[r][l >> 5] = (l & ~31) + __ffs((int)hit) - 1;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int m = wmax[r][0], am = wlane[r][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      if (wmax[r][w] > m) {
        m = wmax[r][w];
        am = wlane[r][w];
      }
    v[r] = (int)((unsigned)m + (unsigned)am);
  }
  store_rows(out, l, v);
}
// :201 zeros, then row b[0] (a start, as a 1-row slice) = a[0, :]
PROBE(p_dynrow) {
  const int l = po::lane_iota();
  const int s = slice_start(b[0], ROWS, 1);
  const int x = a[l];
  int v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = r == s ? x : 0;
  store_rows(out, l, v);
}
// :212 inclusive prefix sum along lanes: a shuffle scan of each row in
// each warp, then the totals of the warps below
PROBE(p_cumsum) {
  __shared__ unsigned wtot[ROWS][WARPS];
  const int l = po::lane_iota(), wl = l & 31, w = l >> 5;
  int v[ROWS];
  load_rows(a, l, v);
  unsigned u[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) u[r] = (unsigned)v[r];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const unsigned t = __shfl_up_sync(FULL, u[r], d);
      if (wl >= d) u[r] += t;
    }
  }
  if (wl == 31) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) wtot[r][w] = u[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int k = 0; k < WARPS - 1; ++k)
      if (k < w) u[r] += wtot[r][k];
    v[r] = (int)u[r];
  }
  store_rows(out, l, v);
}
// :220 the tile plus a (1, 1) scalar operand, its own kernel: 256 threads,
// one int4 of the tile each, the scalar loaded once.
__global__ void __launch_bounds__(S2_THREADS)
    p_s2(const int4* __restrict__ a, const int* __restrict__ s,
         int4* __restrict__ out) {
  const unsigned v = (unsigned)*s;
  int4 x = a[threadIdx.x];
  x.x = (int)((unsigned)x.x + v);
  x.y = (int)((unsigned)x.y + v);
  x.z = (int)((unsigned)x.z + v);
  x.w = (int)((unsigned)x.w + v);
  out[threadIdx.x] = x;
}

typedef void (*probe_fn)(const int*, const int*, int*, int);
// the launcher's order (tools/caps.py KERNELS); p_s2 follows as probe 13
static const probe_fn PROBES[N_PROBES] = {
    p_take0, p_take1, p_roll1, p_roll0, p_lane_ds, p_ds2d, p_u32, p_sum,
    p_while, p_u8, p_argmax, p_dynrow, p_cumsum};
#define P_U32 6
#define P_U8 9

// whether probe `probe` takes these arguments: a probe that loads or
// stores 16-byte words (p_u32, p_u8, p_s2) needs a and out 16-byte aligned
static inline bool caps_args_ok(int probe, const void* a, const void* out,
                                int n) {
  if (probe < 0 || probe > N_PROBES || n < 0) return false;
  const bool wide = probe == P_U32 || probe == P_U8 || probe == N_PROBES;
  return !wide || !((((size_t)a) | ((size_t)out)) & 15);
}
static inline int caps_threads(int probe) {
  return probe == N_PROBES ? S2_THREADS : po::LANES;
}
static_assert(S2_THREADS * 4 == ROWS * po::LANES, "p_s2: one int4 a thread");
static_assert(2 * 4 * po::LANES == ROWS * po::LANES,
              "p_u32, p_u8: two int4 of the tile a thread");

#ifdef __CUDACC__
// a, b, out: contiguous tensors on the card. Launches probe number `probe`
// (the order of PROBES, p_s2 last) on `stream` and returns the CUDA error
// code of the launch (0 = launched).
extern "C" int caps_launch(int probe, const int* a, const int* b, int* out,
                           int n, void* stream) {
  if (!caps_args_ok(probe, a, out, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (probe == N_PROBES)
    p_s2<<<1, S2_THREADS, 0, st>>>((const int4*)a, b, (int4*)out);
  else
    PROBES[probe]<<<1, caps_threads(probe), 0, st>>>(a, b, out, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
