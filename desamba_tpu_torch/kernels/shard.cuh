// The table accessor of the kernels that read the index's gather tables
// (ladder.cu's B2 and B3, rescore.cu's K1), in its two layouts:
//
//   Flat     a table is one pointer (const T*): the loads are the plain
//            p[i] they always were, so the default layout's code does not
//            change;
//   Sharded  ShardTab<T>: the table cut by row range over the mesh's idx
//            axis (desamba_tpu_torch/parallel/sharded.py), up to MAX_IDX
//            shards of `len` elements each, shard k holding elements
//            [k * len, (k + 1) * len) of the table's flat layout, on its own
//            card. Element i is shard i / len, place i % len. A kernel on
//            another card reads a shard there by peer access over NVLink.
//
// Two loads, for the two kinds of gather in the code they port:
//   ld(tab, i)          an index the caller has brought into range (an
//                       explicit clamp in the JAX code);
//   ld_take(tab, i, n)  JAX's own gather on an index that may leave the
//                       table: a whole table clamps it (take_i), a sharded
//                       one reads 0 outside [0, n), as the JAX package's
//                       owner mask and psum do (no shard owns it, or it
//                       lands in the zero padding).
// row_take(tab, r, rows, w) is ld_take for a row of w elements (w divides
// `len`, so a row never straddles two shards): a pointer to the row, or to
// a zero row outside [0, rows) for a sharded table.
//
// ShardTab goes by value in the launch's argument block: a launch needs
// no allocation or copy of pointers on the card, and a kernel whose
// argument block is __grid_constant__ reads a shard's pointer from the
// constant bank its whole grid shares. sharded.py's ShardTab (ctypes)
// mirrors it.
#pragma once
#include <cstdint>

#ifndef __CUDACC__
#ifndef __grid_constant__
#define __grid_constant__
#endif
#endif

namespace shard {

constexpr int MAX_IDX = 8;

template <class T>
struct ShardTab {
  const T* p[MAX_IDX];
  int len;       // elements a shard
  int shards;    // shards in use
};

// the whole-table layout: a table is its pointer
template <class T>
using Flat = const T*;

// a row of zeros for row_take past a sharded table's end (the widest row
// read through it is a 9-word FM block)
__device__ const uint32_t ZERO_ROW[16] = {};

// JAX's clamping gather index: a negative index wraps once, then clamps
// (ladder.cuh's take_i, written the same way: the whole-table kernels'
// code is then the one they had before the accessor)
__device__ inline int clamp_index(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ inline int take_index(int i, int n) {
  return clamp_index(i < 0 ? i + n : i, 0, n - 1);
}

template <class T, class I>
__device__ inline T ld(const T* p, I i) {
  return p[i];
}
template <class T, class I>
__device__ inline T ld(const ShardTab<T>& s, I i) {
  const int j = (int)i;               // a table holds under 2^31 elements
  const int k = j / s.len;
  return s.p[k][j - k * s.len];
}

template <class T>
__device__ inline T ld_take(const T* p, int i, int n) {
  return p[take_index(i, n)];
}
template <class T>
__device__ inline T ld_take(const ShardTab<T>& s, int i, int n) {
  return (unsigned)i < (unsigned)n ? ld(s, i) : T(0);
}

template <class T>
__device__ inline const T* row_take(const T* p, int r, int rows, int w) {
  return p + w * take_index(r, rows);
}
template <class T>
__device__ inline const T* row_take(const ShardTab<T>& s, int r, int rows,
                                    int w) {
  if ((unsigned)r >= (unsigned)rows)
    return reinterpret_cast<const T*>(ZERO_ROW);
  const int e = r * w;
  const int k = e / s.len;
  return s.p[k] + (e - k * s.len);
}

}  // namespace shard
