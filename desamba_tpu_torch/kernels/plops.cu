// Harness of the tile helpers of plops.cuh: one kernel per test body.
//
// Replaces the Pallas call of tests/test_plops.py (run1, pl.pallas_call at
// :16), which runs seven kernel bodies over the TPU helper library
// desamba_tpu/engine/device/plops.py. Each kernel here writes the output
// tile its body writes, so the two can be held against each other element
// for element; the lanes, offsets and values a body fixes are arguments
// here. Three more bodies cover the helpers that file never calls directly
// (umin, ule, reverse_lanes).
//
// One block of 128 threads, thread = lane; the input tiles are copied into
// shared memory first, as the TPU bodies read theirs from VMEM. What bounds
// them: nothing but the launch; a body moves a few KB and does a few
// operations per word. They exist to be right, not to be timed.
#include "plops.cuh"

extern __shared__ int s_mem[];

__device__ __forceinline__ void load_tile(int* dst, const int* src, int R) {
  for (int r = 0; r < R; ++r)
    dst[r * po::LANES + threadIdx.x] = src[r * po::LANES + threadIdx.x];
}

// test_plops.py:25-35. out = bcast_lane(x, lane_b); then out[0, 0] =
// extract(x, lane_e), out[0, 1] = extract_rc(x, row_rc, lane_rc), out[1, :]
// = set_lane(x, lane_s1, new1)[1], out[3, :] = set_lane(x, lane_s2, new2)[3].
__global__ void k_bcast_extract_setlane(const int* v, int* out, int R,
                                        int lane_b, int lane_e, int row_rc,
                                        int lane_rc, int lane_s1, int new1,
                                        int lane_s2, int new2) {
  int* x = s_mem;
  load_tile(x, v, R);
  __syncthreads();
  const int l = po::lane_iota();
  const int s = po::extract(x, lane_e);
  const int s2 = po::extract_rc(x, R, row_rc, lane_rc);
  for (int r = 0; r < R; ++r) {
    int val = po::bcast_lane(x, r, lane_b);
    if (r == 0 && l == 0) val = s;
    if (r == 0 && l == 1) val = s2;
    if (r == 1) val = po::set_lane(x[po::LANES + l], lane_s1, new1);
    if (r == 3) val = po::set_lane(x[3 * po::LANES + l], lane_s2, new2);
    out[r * po::LANES + l] = val;
  }
}

// test_plops.py:48-50. out = ult(a, b) as 0/1; out[0, 10] = umax_reduce(a).
__global__ void k_unsigned(const int* a, const int* b, int* out, int R) {
  int* x = s_mem;
  int* scratch = s_mem + R * po::LANES;
  load_tile(x, a, R);
  __syncthreads();
  const int l = po::lane_iota();
  const int um = po::umax_reduce(x, R, scratch);
  for (int r = 0; r < R; ++r) {
    int val = po::ult(x[r * po::LANES + l], b[r * po::LANES + l]) ? 1 : 0;
    if (r == 0 && l == 10) val = um;
    out[r * po::LANES + l] = val;
  }
}

// test_plops.py:62-63. out = roll_flat(pair, off, rows_out).
__global__ void k_roll_flat(const int* pair, int* out, int off,
                            int rows_out) {
  int* x = s_mem;
  load_tile(x, pair, 2);
  __syncthreads();
  for (int s = 0; s < rows_out; ++s)
    out[s * po::LANES + threadIdx.x] = po::roll_flat(x, off, s);
}

// test_plops.py:75-77. out = tab[idx], tab (n_rows, 128) read flat.
__global__ void k_gather_rows_table(const int* tab, const int* idx, int* out,
                                    int R, int n_rows) {
  int* t = s_mem;
  load_tile(t, tab, n_rows);
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    const int i = r * po::LANES + threadIdx.x;
    out[i] = po::gather_rows_table(t, n_rows, idx[i]);
  }
}

// test_plops.py:87-88.
__global__ void k_prefix_sum_colmajor(const int* v, int* out, int R) {
  int* x = s_mem;
  int* scratch = s_mem + R * po::LANES;
  load_tile(x, v, R);
  __syncthreads();
  po::prefix_sum_colmajor(x, R, out, scratch);
}

// test_plops.py:100-101 (colmajor != 0), and reverse_lanes (colmajor == 0).
__global__ void k_reverse(const int* v, int* out, int R, int colmajor) {
  int* x = s_mem;
  load_tile(x, v, R);
  __syncthreads();
  for (int r = 0; r < R; ++r)
    out[r * po::LANES + threadIdx.x] =
        colmajor ? po::reverse_colmajor(x, R, r) : po::reverse_lanes(x, r);
}

// test_plops.py:112-113 (op 0: popc32(a)); op 1: umin(a, b); op 2: ule(a, b)
// as 0/1.
__global__ void k_elementwise(const int* a, const int* b, int* out, int R,
                              int op) {
  for (int r = 0; r < R; ++r) {
    const int i = r * po::LANES + threadIdx.x;
    out[i] = op == 0 ? po::popc32(a[i])
             : op == 1 ? po::umin(a[i], b[i])
                       : (po::ule(a[i], b[i]) ? 1 : 0);
  }
}

enum { B_BCAST, B_UNSIGNED, B_ROLL_FLAT, B_GATHER, B_PREFIX, B_REV_COLMAJOR,
       B_POPC, B_UMIN, B_ULE, B_REV_LANES };

// a, b, out: contiguous int32 tiles on the card (b unused by most bodies).
// R is the row count of a and out (of idx for the gather, whose table a has
// n_rows rows); p0.. are the body's integer arguments. Launches on `stream`
// and returns the CUDA error code of the launch (0 = launched).
extern "C" int plops_launch(int body, const int* a, const int* b, int* out,
                            int R, int n_rows, int p0, int p1, int p2, int p3,
                            int p4, int p5, int p6, int p7, void* stream) {
  if (R <= 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t tile = (size_t)R * po::LANES * sizeof(int);
  const size_t scratch = 4 * sizeof(int);
  if (tile + scratch > 48 * 1024 ||
      (size_t)n_rows * po::LANES * sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  switch (body) {
    case B_BCAST:
      if (R < 4) return (int)cudaErrorInvalidValue;
      k_bcast_extract_setlane<<<1, po::LANES, tile, st>>>(
          a, out, R, p0, p1, p2, p3, p4, p5, p6, p7);
      break;
    case B_UNSIGNED:
      k_unsigned<<<1, po::LANES, tile + scratch, st>>>(a, b, out, R);
      break;
    case B_ROLL_FLAT:
      k_roll_flat<<<1, po::LANES, 2 * po::LANES * sizeof(int), st>>>(
          a, out, p0, R);
      break;
    case B_GATHER:
      k_gather_rows_table<<<1, po::LANES,
                            (size_t)n_rows * po::LANES * sizeof(int), st>>>(
          a, b, out, R, n_rows);
      break;
    case B_PREFIX:
      k_prefix_sum_colmajor<<<1, po::LANES, tile + scratch, st>>>(a, out, R);
      break;
    case B_REV_COLMAJOR:
    case B_REV_LANES:
      k_reverse<<<1, po::LANES, tile, st>>>(a, out, R,
                                            body == B_REV_COLMAJOR);
      break;
    case B_POPC:
    case B_UMIN:
    case B_ULE:
      k_elementwise<<<1, po::LANES, 0, st>>>(
          a, b, out, R, body == B_POPC ? 0 : (body == B_UMIN ? 1 : 2));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
