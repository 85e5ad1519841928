// The fast classify ladder (src/cly.c:1478-1534) for Hopper, one lane a
// thread.
//
// Replaces the JAX package's fast_ladder
// (desamba_tpu/engine/device/ladder.py:98-208), one jitted device program of
// nested lax.while_loops (the ladder, the map loop, and the loops inside
// fm.mem_probe, mapseed.map_seed_lanes and textwalk), which the port ran as
// eager torch loops that synchronise with the host on every trip. It
// computes what that function computes, lane for lane and bit for bit; its
// plain version is desamba_tpu_torch/engine/device/ladder.py fast_ladder.
//
// A lane = (read, direction, island): from j = seed_len - 1 down, one MEM
// probe (lad::mem_probe), map_seed on each of its valid rows in order, then
// the stride: j -= 3 + 7 * (max score > 35) if a row had a MEM, else 2;
// the lane stops below MIN_MEM_LEN_FAST - l_ek or once a score passes 256,
// and flags the next island to skip past 512. A lane's trajectory does not
// depend on its neighbours (the JAX ladder compacts lanes each trip, the
// eager port takes them all, with the same results), so one thread runs its
// lane's ladder to the end: no trip-by-trip lockstep, no host round trip.
// The anchors go to the lane's (a_cap, A_NF) rows, the SP_SET to its
// (iv_cap, 2) rows of device memory; packing them (a prefix sum and a
// scatter) stays with the caller.
//
// What bounds it: the longest lane's serial chain of dependent loads (index
// lookups, rank checkpoints, text words), not bytes or operations: the
// inputs it must read are a few hundred kilobytes. Lanes of a warp diverge
// at every data-dependent loop. This first version takes no step against
// either (no warp cooperation, no ordering of lanes by expected length, no
// staging in shared memory).
//
// Only the launcher needs nvcc (__CUDACC__); the rest also compiles as host
// C++ over tests/cuda_host/block_emu.h, which is how the CPU tests run it.
#include <cstdint>
#include <cuda_runtime.h>

#include "ladder.cuh"

constexpr int LADDER_THREADS = 128;

__global__ void __launch_bounds__(LADDER_THREADS)
    fast_ladder_kernel(lad::LadderArgs A) {
  using namespace lad;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= A.nb) return;
  const int nb = A.nb;
  const int* la = A.lane_args;
  const int ridx = la[lane], base = la[nb + lane], read_len = la[2 * nb + lane],
            dir = la[3 * nb + lane], sid = la[4 * nb + lane],
            seed_off = la[5 * nb + lane], seed_len = la[6 * nb + lane];
  const bool lane_on = la[7 * nb + lane] != 0;
  const int min_index = MIN_MEM_LEN_FAST - A.l_ek;
  int* anc = A.anchors + (size_t)lane * A.a_cap * A_NF;
  IvSet S{A.iv + (size_t)lane * A.iv_cap * 2, A.iv_cap, 0, 0, 0};
  int a_cnt = 0, trips = 0;
  bool skip = false;
  int j = seed_len - 1;
  bool active = lane_on && j >= min_index;
  while (active) {
    ++trips;
    const int ki = seed_off + j;
    const int str_idx = ki + A.l_ek - 1;
    const int pre_v =
        A.pre13[(size_t)ridx * A.pre13_w + clampi(base + ki, 0, A.pre13_w - 1)] &
        PRE_IDX_MASK;
    MemRows<MEM_SEARCH_FAST> r;
    mem_probe<MEM_SEARCH_FAST>(A, ridx, base, str_idx, pre_v, S,
                               MIN_MEM_LEN_FAST - 1, r);
    bool has_mem = false;
    int max_score = 0;
    for (int k = 0; k < MEM_SEARCH_FAST; ++k) {
      if (!r.valid[k]) continue;
      has_mem = true;
      const int ms = map_seed(A, ridx, base, read_len, dir, sid, r.sp[k],
                              r.len[k], r.sa_ok[k], r.sa[k], r.sa_l[k],
                              str_idx - r.len[k], anc, a_cnt);
      max_score = imax(max_score, ms);
    }
    const int j2 = has_mem ? j - 3 - (max_score > 35 ? 7 : 0) : j - 2;
    active = !(max_score > 256) && j2 >= min_index;
    skip = skip || max_score > 512;
    j = j2;
  }
  A.a_cnt[lane] = a_cnt;
  A.skip[lane] = skip;
  A.iv_ovf[lane] = S.ovf;
  A.trips[lane] = trips;
}

// The struct's size, so the caller can check its mirror of LadderArgs.
extern "C" int ladder_args_size() { return (int)sizeof(lad::LadderArgs); }

#ifdef __CUDACC__
// One thread a lane, LADDER_THREADS a block, on `stream`. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int ladder_fast_launch(const lad::LadderArgs* a,
                                  cudaStream_t stream) {
  if (a->nb <= 0) return 0;
  fast_ladder_kernel<<<(a->nb + LADDER_THREADS - 1) / LADDER_THREADS,
                       LADDER_THREADS, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif
