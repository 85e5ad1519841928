// kernels/shard.cuh compiled as host C++: the kernels' table accessor,
// element by element, for both layouts. shard_ld_take and shard_row_take
// read a ShardTab (a table cut as parallel/sharded.py cuts it); flat_ld_take
// and flat_row_take read one pointer. Each writes m answers to out.
#include "warp_emu.h"

#include "shard.cuh"

extern "C" void shard_ld_take(const shard::ShardTab<int>* s, const int* idx,
                              int m, int n, int* out) {
  for (int k = 0; k < m; ++k) out[k] = shard::ld_take(*s, idx[k], n);
}

extern "C" void flat_ld_take(const int* p, const int* idx, int m, int n,
                             int* out) {
  for (int k = 0; k < m; ++k) out[k] = shard::ld_take(p, idx[k], n);
}

extern "C" void shard_row_take(const shard::ShardTab<uint32_t>* s,
                               const int* rows, int m, int n_rows, int w,
                               uint32_t* out) {
  for (int k = 0; k < m; ++k) {
    const uint32_t* r = shard::row_take(*s, rows[k], n_rows, w);
    for (int j = 0; j < w; ++j) out[k * w + j] = r[j];
  }
}

extern "C" void flat_row_take(const uint32_t* p, const int* rows, int m,
                              int n_rows, int w, uint32_t* out) {
  for (int k = 0; k < m; ++k) {
    const uint32_t* r = shard::row_take(p, rows[k], n_rows, w);
    for (int j = 0; j < w; ++j) out[k * w + j] = r[j];
  }
}
