// The classify ladders (src/cly.c:1478-1611) for Hopper, one lane a thread:
// the fast ladder (fast_ladder_kernel) and the slow ladder
// (slow_ladder_kernel).
//
// They replace the JAX package's fast_ladder and slow_ladder
// (desamba_tpu/engine/device/ladder.py:98-208, 211-329), each one jitted
// device program of nested lax.while_loops (the ladder, the map loop, and
// the loops inside fm.mem_probe, mapseed.map_seed_lanes and textwalk), which
// the port ran as eager torch loops that synchronise with the host on every
// trip. Each computes what its function computes, lane for lane and bit for
// bit; their plain versions are desamba_tpu_torch/engine/device/ladder.py
// fast_ladder and slow_ladder.
//
// A lane = (read, direction, island). Fast: from j = seed_len - 1 down, one
// MEM probe (lad::mem_probe<2>), map_seed on each of its valid rows in
// order, then the stride: j -= 3 + 7 * (max score > 35) if a row had a MEM,
// else 2; the lane stops below MIN_MEM_LEN_FAST - l_ek or once a score
// passes 256, and flags the next island to skip past 512. Slow: from
// j = seed_len - 1 down to 1 in strides of 2, one probe of up to 8 rows
// (lad::mem_probe<8>) a trip, every valid row a MEM record; then map_seed
// on the 8 longest of the first m_cap records (a stable sort by length,
// longest first), and column 2 flags more than m_cap MEMs. A lane's
// trajectory does not depend on its neighbours (the JAX ladders compact
// lanes each trip, the eager port takes them all, with the same results),
// so one thread runs its lane's ladder to the end: no trip-by-trip
// lockstep, no host round trip. The anchors go to the lane's (a_cap, A_NF)
// rows, the SP_SET to its (iv_cap, 2) rows of device memory; packing them
// (a prefix sum and a scatter) stays with the caller.
//
// What bounds them: the longest lane's serial chain of dependent loads
// (index lookups, rank checkpoints, text words), not bytes or operations:
// the inputs they must read are a few hundred kilobytes. Lanes of a warp
// diverge at every data-dependent loop, and a slow lane runs about
// seed_len / 2 trips against the fast ladder's few. This first version
// takes no step against either (no warp cooperation, no ordering of lanes by
// expected length, no staging in shared memory).
//
// Only the launchers need nvcc (__CUDACC__); the rest also compiles as host
// C++ over tests/cuda_host/block_emu.h, which is how the CPU tests run it.
#include <cstdint>
#include <cuda_runtime.h>

#include "ladder.cuh"

constexpr int LADDER_THREADS = 128;

// One lane's column of lane_args (8, nb): [ridx, base, read_len, dir, sid,
// seed_off, seed_len, lane_on]
struct Lane {
  int ridx, base, read_len, dir, sid, seed_off, seed_len;
  bool on;
};

__device__ inline Lane load_lane(const lad::LadderArgs& A, int lane) {
  const int* la = A.lane_args + lane;
  const int nb = A.nb;
  return Lane{la[0],      la[nb],     la[2 * nb], la[3 * nb],
              la[4 * nb], la[5 * nb], la[6 * nb], la[7 * nb] != 0};
}

// The 13-mer value of the lane's probe at read position ki
__device__ inline int probe_pre13(const lad::LadderArgs& A, const Lane& L,
                                  int ki) {
  return A.pre13[(size_t)L.ridx * A.pre13_w +
                 lad::clampi(L.base + ki, 0, A.pre13_w - 1)] &
         lad::PRE_IDX_MASK;
}

__global__ void __launch_bounds__(LADDER_THREADS)
    fast_ladder_kernel(lad::LadderArgs A) {
  using namespace lad;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= A.nb) return;
  const Lane L = load_lane(A, lane);
  const int min_index = MIN_MEM_LEN_FAST - A.l_ek;
  int* anc = A.anchors + (size_t)lane * A.a_cap * A_NF;
  IvSet S{A.iv + (size_t)lane * A.iv_cap * 2, A.iv_cap, 0, 0, 0};
  int a_cnt = 0, trips = 0;
  bool skip = false;
  int j = L.seed_len - 1;
  bool active = L.on && j >= min_index;
  while (active) {
    ++trips;
    const int ki = L.seed_off + j;
    const int str_idx = ki + A.l_ek - 1;
    MemRows<MEM_SEARCH_FAST> r;
    mem_probe<MEM_SEARCH_FAST>(A, L.ridx, L.base, str_idx,
                               probe_pre13(A, L, ki), S,
                               MIN_MEM_LEN_FAST - 1, r);
    bool has_mem = false;
    int max_score = 0;
    for (int k = 0; k < MEM_SEARCH_FAST; ++k) {
      if (!r.valid[k]) continue;
      has_mem = true;
      const int ms = map_seed(A, L.ridx, L.base, L.read_len, L.dir, L.sid,
                              r.sp[k], r.len[k], r.sa_ok[k], r.sa[k],
                              r.sa_l[k], str_idx - r.len[k], anc, a_cnt);
      max_score = imax(max_score, ms);
    }
    const int j2 = has_mem ? j - 3 - (max_score > 35 ? 7 : 0) : j - 2;
    active = !(max_score > 256) && j2 >= min_index;
    skip = skip || max_score > 512;
    j = j2;
  }
  A.a_cnt[lane] = a_cnt;
  A.flag[lane] = skip;
  A.iv_ovf[lane] = S.ovf;
  A.trips[lane] = trips;
}

// A MEM record of the slow ladder (the JAX mems row: match_len, sp, sa_row,
// sa_ok, sa_l, str_idx)
struct MemRec {
  int len, sp, sa, sa_l, str_idx;
  bool sa_ok;
};

__global__ void __launch_bounds__(LADDER_THREADS)
    slow_ladder_kernel(lad::LadderArgs A) {
  using namespace lad;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= A.nb) return;
  const Lane L = load_lane(A, lane);
  const int l_min = imin(MIN_MEM_LEN_SLOW - 1, A.l_ek + 1);
  IvSet S{A.iv + (size_t)lane * A.iv_cap * 2, A.iv_cap, 0, 0, 0};
  // The JAX ladder stores the first m_cap records, sorts them stably by
  // length (longest first) and maps the first MEM_SEARCH_SLOW. Only those
  // are kept here, in that order: a record goes after every held one at
  // least as long, and one pushed past the last slot drops out.
  MemRec top[MEM_SEARCH_SLOW];
  int n_top = 0, m_cnt = 0, trips = 0;
  int j = L.seed_len - 1;
  bool active = L.on && j >= 1;
  while (active) {
    ++trips;
    const int ki = L.seed_off + j;
    const int str_idx = ki + A.l_ek - 1;
    MemRows<MEM_SEARCH_SLOW> r;
    mem_probe<MEM_SEARCH_SLOW>(A, L.ridx, L.base, str_idx,
                               probe_pre13(A, L, ki), S, l_min, r);
    for (int k = 0; k < MEM_SEARCH_SLOW; ++k) {
      if (!r.valid[k]) continue;
      if (m_cnt < A.m_cap) {
        int at = n_top;
        while (at > 0 && top[at - 1].len < r.len[k]) --at;
        if (at < MEM_SEARCH_SLOW) {
          for (int m = imin(n_top, MEM_SEARCH_SLOW - 1); m > at; --m)
            top[m] = top[m - 1];
          top[at] = MemRec{r.len[k], r.sp[k], r.sa[k], r.sa_l[k], str_idx,
                           r.sa_ok[k]};
          n_top = imin(n_top + 1, MEM_SEARCH_SLOW);
        }
      }
      ++m_cnt;
    }
    j -= 2;
    active = j >= 1;
  }
  int* anc = A.anchors + (size_t)lane * A.a_cap * A_NF;
  int a_cnt = 0;
  for (int k = 0; k < n_top; ++k) {
    const MemRec& m = top[k];
    map_seed(A, L.ridx, L.base, L.read_len, L.dir, L.sid, m.sp, m.len,
             m.sa_ok, m.sa, m.sa_l, m.str_idx - m.len, anc, a_cnt);
  }
  A.a_cnt[lane] = a_cnt;
  A.flag[lane] = m_cnt > A.m_cap;
  A.iv_ovf[lane] = S.ovf;
  A.trips[lane] = trips;
}

// The struct's size, so the caller can check its mirror of LadderArgs.
extern "C" int ladder_args_size() { return (int)sizeof(lad::LadderArgs); }

#ifdef __CUDACC__
// One thread a lane, LADDER_THREADS a block, on `stream`. Return the CUDA
// error code of the launch (0 = launched).
extern "C" int ladder_fast_launch(const lad::LadderArgs* a,
                                  cudaStream_t stream) {
  if (a->nb <= 0) return 0;
  fast_ladder_kernel<<<(a->nb + LADDER_THREADS - 1) / LADDER_THREADS,
                       LADDER_THREADS, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ladder_slow_launch(const lad::LadderArgs* a,
                                  cudaStream_t stream) {
  if (a->nb <= 0) return 0;
  slow_ladder_kernel<<<(a->nb + LADDER_THREADS - 1) / LADDER_THREADS,
                       LADDER_THREADS, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif
