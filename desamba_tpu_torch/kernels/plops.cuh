// Vector helpers over an (R, 128) int32 tile, for Hopper.
//
// Counterpart of desamba_tpu/engine/device/plops.py, the helper library of
// the TPU's per-read kernel. That file builds, from the few primitives its
// compiler lowers, what it lacks: a vector gather, unsigned compares and
// reductions, rolls by a negative shift and a reversal. The card has all of
// them, so each helper here is a few lines. The names are the TPU
// library's, in namespace po as it is imported there.
//
// Conventions. A tile is R rows of 128 int32 words, row-major, in shared
// (or device) memory; uint32 values travel as int32 bit patterns. The
// tile helpers are written for one block of 128 threads, thread = lane
// (threadIdx.x): each returns the calling lane's element of the result, or,
// for an extraction or a reduction, the scalar to every thread. The caller
// fills the tile and synchronizes before the first read. The helpers that
// reduce or scan across lanes (block_max, block_sum, umax_reduce, lane_scan,
// prefix_sum_colmajor) hold __syncthreads(), so every thread of the block
// calls them, and take 4 words of shared scratch. Sums wrap as int32: they
// are added as unsigned.
#pragma once
#include <cuda_runtime.h>

namespace po {

constexpr int LANES = 128;
constexpr int I32_MIN = -2147483647 - 1;

// ---- scalars ----------------------------------------------------------------

// unsigned a < b, a <= b and min(a, b) on int32 bit patterns
__device__ __forceinline__ bool ult(int a, int b) {
  return (unsigned)a < (unsigned)b;
}
__device__ __forceinline__ bool ule(int a, int b) {
  return (unsigned)a <= (unsigned)b;
}
__device__ __forceinline__ int umin(int a, int b) { return ult(a, b) ? a : b; }
__device__ __forceinline__ int popc32(int v) { return __popc((unsigned)v); }

// ---- indexed reads of a tile ------------------------------------------------

__device__ __forceinline__ int lane_iota() { return (int)threadIdx.x; }

// v[r, idx]: the gather along lanes (0 <= idx < 128)
__device__ __forceinline__ int shuffle_lanes(const int* v, int r, int idx) {
  return v[r * LANES + idx];
}
// v[r, lane] to every lane of row r (0 <= lane < 128)
__device__ __forceinline__ int bcast_lane(const int* v, int r, int lane) {
  return v[r * LANES + lane];
}
// v[0, lane] as a scalar; INT32_MIN when the lane is out of range (the TPU
// helper is a masked max, and a mask that selects nothing leaves its fill)
__device__ __forceinline__ int extract(const int* v, int lane) {
  return (unsigned)lane < (unsigned)LANES ? v[lane] : I32_MIN;
}
// v[row, lane] as a scalar; INT32_MIN when either is out of range
__device__ __forceinline__ int extract_rc(const int* v, int R, int row,
                                          int lane) {
  return ((unsigned)row < (unsigned)R && (unsigned)lane < (unsigned)LANES)
             ? v[row * LANES + lane] : I32_MIN;
}
// the calling lane's x, replaced by nw where it is lane `lane` (and mask)
__device__ __forceinline__ int set_lane(int x, int lane, int nw,
                                        bool mask = true) {
  return (mask && lane_iota() == lane) ? nw : x;
}
// pair is (2, 128) read as 256 flat words: the word at flat offset
// off + 128 * s + lane, wrapping at 256 (0 <= off < 128; s is the output row)
__device__ __forceinline__ int roll_flat(const int* pair, int off, int s) {
  return pair[(s * LANES + lane_iota() + off) & (2 * LANES - 1)];
}
// tab[idx] for a table of n_rows x 128 read flat; 0 where idx is outside it
// (the TPU helper selects row by row, and no row matches)
__device__ __forceinline__ int gather_rows_table(const int* tab, int n_rows,
                                                 int idx) {
  return (unsigned)idx < (unsigned)(n_rows * LANES) ? tab[idx] : 0;
}
__device__ __forceinline__ int reverse_lanes(const int* v, int r) {
  return v[r * LANES + (LANES - 1 - lane_iota())];
}
// the tile reversed in column-major order: (r, l) <- (R - 1 - r, 127 - l)
__device__ __forceinline__ int reverse_colmajor(const int* v, int R, int r) {
  return v[(R - 1 - r) * LANES + (LANES - 1 - lane_iota())];
}

// ---- across lanes -----------------------------------------------------------

// signed max of x over the block's 128 lanes, to every thread
__device__ __forceinline__ int block_max(int x, int* scratch) {
  x = __reduce_max_sync(0xffffffffu, x);
  __syncthreads();                      // scratch may still be in use
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  return max(max(scratch[0], scratch[1]), max(scratch[2], scratch[3]));
}
// wrapping sum of x over the block's 128 lanes, to every thread
__device__ __forceinline__ int block_sum(int x, int* scratch) {
  const unsigned u = __reduce_add_sync(0xffffffffu, (unsigned)x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = (int)u;
  __syncthreads();
  return (int)((unsigned)scratch[0] + (unsigned)scratch[1] +
               (unsigned)scratch[2] + (unsigned)scratch[3]);
}
// unsigned max of the whole tile, as an int32 bit pattern, to every thread
__device__ __forceinline__ int umax_reduce(const int* v, int R, int* scratch) {
  int m = I32_MIN;                      // 0 with the sign bit flipped
  for (int r = 0; r < R; ++r)
    m = max(m, v[r * LANES + lane_iota()] ^ I32_MIN);
  return block_max(m, scratch) ^ I32_MIN;
}
// inclusive prefix sum of x over lanes 0..lane: a shuffle scan inside each
// warp, then the totals of the warps below
__device__ __forceinline__ int lane_scan(int x, int* scratch) {
  unsigned u = (unsigned)x;
  const int wl = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, u, s);
    if (wl >= s) u += t;
  }
  __syncthreads();
  if (wl == 31) scratch[w] = (int)u;
  __syncthreads();
  for (int k = 0; k < w; ++k) u += (unsigned)scratch[k];
  return (int)u;
}
// inclusive prefix sum of the tile in column-major order (flat index =
// lane * R + row) into out (same shape; it may not alias v)
__device__ __forceinline__ void prefix_sum_colmajor(const int* v, int R,
                                                    int* out, int* scratch) {
  const int l = lane_iota();
  unsigned run = 0;
  for (int r = 0; r < R; ++r) {
    run += (unsigned)v[r * LANES + l];
    out[r * LANES + l] = (int)run;      // prefix down this lane's column
  }
  const unsigned ex = (unsigned)lane_scan((int)run, scratch) - run;
  for (int r = 0; r < R; ++r)
    out[r * LANES + l] = (int)((unsigned)out[r * LANES + l] + ex);
}

}  // namespace po
