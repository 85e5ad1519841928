// Capability probes for Hopper: one tiny kernel per probe body.
//
// Replaces the Pallas calls of tools/pallas_caps.py: `call` (pl.pallas_call
// at :36, twelve kernel bodies run as thirteen probes), `f_smem` (:153, a
// 1-element output) and `f_s2` (:225, a (1, 1) scalar operand). On the TPU
// a probe asked whether a primitive lowers at all. Here everything
// compiles, so a probe asks whether the card's form of the primitive is
// right: a gather is an indexed load, a dynamic roll or slice is index
// arithmetic, a reduction or a scan across lanes goes through the helpers
// of plops.cuh (block_max, block_sum, lane_scan, shuffle_lanes), a scalar
// operand is a one-word load.
//
// One block of 128 threads (thread = lane) over an (8, 128) int32 output
// tile, inputs read from device memory; p_s2 alone is one block of 256
// threads, each one 16-byte load and store of the tile. What bounds them:
// the launch; each moves a few KB. They exist to be right, not to be timed.
#include "plops.cuh"

#define ROWS 8

#define PROBE(name) \
  __global__ void name(const int* a, const int* b, int* out, int n)
#define AT(r) ((r) * po::LANES + l)

// a, b: the probe's inputs (b is its index tile or its scalars, and repeats
// a where there is one input); n: the row count of a for p_take0.

// :50 take_along_axis along rows: out[r, l] = a[b[r, l], l] (I32_MIN
// where an index is outside the table, so that nothing outside it is read)
PROBE(p_take0) {
  const int l = po::lane_iota();
  for (int r = 0; r < ROWS; ++r) {
    const int i = b[AT(r)];
    out[AT(r)] = (unsigned)i < (unsigned)n ? a[AT(i)] : po::I32_MIN;
  }
}
// :73 take_along_axis along lanes: out[r, l] = a[r, b[r, l]]
PROBE(p_take1) {
  const int l = po::lane_iota();
  for (int r = 0; r < ROWS; ++r)
    out[AT(r)] = po::shuffle_lanes(a, r, b[AT(r)] & (po::LANES - 1));
}
// :87 roll by b[0] along lanes: out[r, l] = a[r, l - s]
PROBE(p_roll1) {
  const int l = po::lane_iota();
  for (int r = 0; r < ROWS; ++r)
    out[AT(r)] = po::shuffle_lanes(a, r, (l - b[0]) & (po::LANES - 1));
}
// :97 roll by b[0] along rows: out[r, l] = a[r - s, l]
PROBE(p_roll0) {
  const int l = po::lane_iota();
  for (int r = 0; r < ROWS; ++r) out[AT(r)] = a[AT((r - b[0]) & (ROWS - 1))];
}
// :111 a (8, 512): out = a[:, b[0] : b[0] + 128]
PROBE(p_lane_ds) {
  const int l = po::lane_iota();
  for (int r = 0; r < ROWS; ++r) out[AT(r)] = a[r * 512 + b[0] + l];
}
// :121 a (64, 512): the (8, 128) slice at (b[0], b[1]), its start clamped
// into the array as dynamic_slice does
PROBE(p_ds2d) {
  const int l = po::lane_iota();
  const int o0 = min(max(b[0], 0), 64 - ROWS);
  const int o1 = min(max(b[1], 0), 512 - po::LANES);
  for (int r = 0; r < ROWS; ++r) out[AT(r)] = a[(o0 + r) * 512 + o1 + l];
}
// :137 uint32 xor-shift, multiply, shift
PROBE(p_u32) {
  const int l = po::lane_iota();
  for (int r = 0; r < ROWS; ++r) {
    unsigned v = (unsigned)a[AT(r)];
    v ^= v >> 7;
    v *= 0x9E3779B1u;
    out[AT(r)] = (int)(v >> 16);
  }
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
// :163 a while loop with a scalar state and row reads
PROBE(p_while) {
  __shared__ int scratch[4];
  const int l = po::lane_iota();
  int i = 0;
  unsigned acc = 0;
  while (i < ROWS) {
    acc += (unsigned)po::block_sum(a[AT(i)], scratch);
    i += 1;
  }
  for (int r = 0; r < ROWS; ++r) out[AT(r)] = (int)acc;
}
// :183 a (32, 128) uint8: out = int32(a)[:8] + 1
PROBE(p_u8) {
  const int l = po::lane_iota();
  const unsigned char* a8 = (const unsigned char*)a;
  for (int r = 0; r < ROWS; ++r) out[AT(r)] = (int)a8[AT(r)] + 1;
}
// :191 max + (first) argmax along lanes, to every lane
PROBE(p_argmax) {
  __shared__ int scratch[4];
  const int l = po::lane_iota();
  for (int r = 0; r < ROWS; ++r) {
    const int v = a[AT(r)];
    const int m = po::block_max(v, scratch);
    // the first lane holding m: the largest 127 - lane among them
    const int am = po::LANES - 1 - po::block_max(
        v == m ? po::LANES - 1 - l : -1, scratch);
    out[AT(r)] = (int)((unsigned)m + (unsigned)am);
  }
}
// :201 zeros, then row b[0] = a[0, :]
PROBE(p_dynrow) {
  const int l = po::lane_iota();
  for (int r = 0; r < ROWS; ++r) out[AT(r)] = r == b[0] ? a[l] : 0;
}
// :212 inclusive prefix sum along lanes
PROBE(p_cumsum) {
  __shared__ int scratch[4];
  const int l = po::lane_iota();
  for (int r = 0; r < ROWS; ++r)
    out[AT(r)] = po::lane_scan(a[AT(r)], scratch);
}
// :220 the tile plus a (1, 1) scalar operand, outside the PROBE macro: its
// pointers are __restrict__, so no load waits for a store (through the
// macro's pointers, which may alias, each row's loads waited for the row
// before it to be stored), and the scalar is loaded once. 256 threads, one
// int4 of the tile each: every load is issued before the one store.
#define S2_THREADS 256
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

// a, b, out: contiguous tensors on the card (for p_s2, a and out 16-byte
// aligned). Launches probe number `probe` (the order above, p_s2 last) on
// `stream` and returns the CUDA error code of the launch (0 = launched).
extern "C" int caps_launch(int probe, const int* a, const int* b, int* out,
                           int n, void* stream) {
  typedef void (*probe_fn)(const int*, const int*, int*, int);
  static const probe_fn probes[] = {
      p_take0, p_take1, p_roll1, p_roll0, p_lane_ds, p_ds2d, p_u32, p_sum,
      p_while, p_u8, p_argmax, p_dynrow, p_cumsum};
  const int count = (int)(sizeof(probes) / sizeof(probes[0]));
  if (probe < 0 || probe > count || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (probe == count) {
    if ((((size_t)a) | ((size_t)out)) & 15) return (int)cudaErrorInvalidValue;
    static_assert(S2_THREADS * 4 == ROWS * po::LANES, "one int4 a thread");
    p_s2<<<1, S2_THREADS, 0, st>>>((const int4*)a, b, (int4*)out);
  } else {
    probes[probe]<<<1, po::LANES, 0, st>>>(a, b, out, n);
  }
  return (int)cudaGetLastError();
}
