// The classify ladders (src/cly.c:1478-1611) for Hopper, one lane a warp:
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
// so one warp runs its lane's ladder to the end: no trip-by-trip lockstep,
// no host round trip. The anchors go to the lane's (a_cap, A_NF) rows;
// packing them (a prefix sum and a scatter) stays with the caller.
//
// What bounds them: the longest lane's serial chain of dependent loads
// (index lookups, rank checkpoints, text words), not bytes or operations:
// the inputs they must read are a few hundred kilobytes. A thread per lane
// ran that chain and also, one item after another, the work inside a trip
// that does not depend on itself: a unitig's reference occurrences (up to
// 999, two greedy extensions and an LV each), a 13-mer bucket's 16 LCEs,
// a probe's result rows and the SP_SET scans. Here a warp runs a lane: its
// 32 threads step through the serial chain together and split that work
// (ladder.cuh's notes (a)-(d)); the lane's SP_SET and scratch sit in the
// warp's part of the block's dynamic shared memory (ladder_smem_bytes), the
// slow ladder's top-8 list too. Warps take the lanes from the last to the
// first: the caller's lanes come in ascending seed length, so the longest
// ladders start first.
//
// Each has a second instantiation, fast_ladder_sharded_kernel and
// slow_ladder_sharded_kernel, for the index cut by row range over a mesh's
// idx axis (desamba_tpu_torch/parallel/sharded.py, the JAX package's
// shard_full layout): the same body, every gather table read through
// shard.cuh's ShardTab accessor, shards on other cards by peer access.
//
// Only the launchers need nvcc (__CUDACC__); the rest also compiles as host
// C++ over tests/cuda_host/warp_emu.h, which is how the CPU tests run it.
#include <cstdint>
#include <cuda_runtime.h>

#include "ladder.cuh"

constexpr int LADDER_WARPS = 4;                  // lanes a block
constexpr int LADDER_THREADS = 32 * LADDER_WARPS;
// blocks an SM must hold: 32 warps, so at most 64 registers a thread
constexpr int LADDER_MIN_BLOCKS = 8;

// One lane's column of lane_args (8, nb): [ridx, base, read_len, dir, sid,
// seed_off, seed_len, lane_on]
struct Lane {
  int ridx, base, read_len, dir, sid, seed_off, seed_len;
  bool on;
};

template <class Args>
__device__ inline Lane load_lane(const Args& A, int lane) {
  const int* la = A.lane_args + lane;
  const int nb = A.nb;
  return Lane{la[0],      la[nb],     la[2 * nb], la[3 * nb],
              la[4 * nb], la[5 * nb], la[6 * nb], la[7 * nb] != 0};
}

// The 13-mer value of the lane's probe at read position ki
template <class Args>
__device__ inline int probe_pre13(const Args& A, const Lane& L, int ki) {
  return A.pre13[(size_t)L.ridx * A.pre13_w +
                 lad::clampi(L.base + ki, 0, A.pre13_w - 1)] &
         lad::PRE_IDX_MASK;
}

// The calling warp's lane (-1 past the last) and its shared memory
template <class Args>
__device__ inline int warp_lane(const Args& A) {
  const int w = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  return w < A.nb ? A.nb - 1 - w : -1;
}

template <class Args>
__device__ inline int* warp_smem(int* smem, const Args& A) {
  return smem + (threadIdx.x >> 5) * lad::warp_words(A.iv_cap);
}

// The fast ladder of the calling warp's lane, over either table layout
template <class Args>
__device__ inline void fast_ladder_body(const Args& A) {
  using namespace lad;
  extern __shared__ __align__(16) int ladder_smem[];
  const int lane = warp_lane(A);
  if (lane < 0) return;
  const int t = threadIdx.x & 31;
  int* scr = warp_smem(ladder_smem, A);
  const Lane L = load_lane(A, lane);
  const int min_index = MIN_MEM_LEN_FAST - A.l_ek;
  int* anc = A.anchors + (size_t)lane * A.a_cap * A_NF;
  IvSet S{scr + SCR_WORDS, A.iv_cap, 0, 0, 0};
  int a_cnt = 0, trips = 0;
  bool skip = false;
  int j = L.seed_len - 1;
  bool active = L.on && j >= min_index;
  while (active) {
    ++trips;
    const int ki = L.seed_off + j;
    const int str_idx = ki + A.l_ek - 1;
    const Row r = mem_probe<MEM_SEARCH_FAST>(A, L.ridx, L.base, str_idx,
                                             probe_pre13(A, L, ki), S,
                                             MIN_MEM_LEN_FAST - 1, scr, t);
    const unsigned valid = __ballot_sync(FULL, r.valid);
    int max_score = 0;
    for (int k = 0; k < MEM_SEARCH_FAST; ++k) {
      if (!((valid >> k) & 1u)) continue;
      const int len = __shfl_sync(FULL, r.len, k);
      const int sp = __shfl_sync(FULL, r.sp, k);
      const int sa = __shfl_sync(FULL, r.sa, k);
      const int sa_l = __shfl_sync(FULL, r.sa_l, k);
      const bool sa_ok = __shfl_sync(FULL, (int)r.sa_ok, k) != 0;
      const int ms = map_seed(A, L.ridx, L.base, L.read_len, L.dir, L.sid, sp,
                              len, sa_ok, sa, sa_l, str_idx - len, anc, a_cnt,
                              t);
      max_score = imax(max_score, ms);
    }
    const int j2 = valid ? j - 3 - (max_score > 35 ? 7 : 0) : j - 2;
    active = !(max_score > 256) && j2 >= min_index;
    skip = skip || max_score > 512;
    j = j2;
  }
  if (t == 0) {
    A.a_cnt[lane] = a_cnt;
    A.flag[lane] = skip;
    A.iv_ovf[lane] = S.ovf;
    A.trips[lane] = trips;
  }
}

// The slow ladder's top list: the MEM records (the JAX mems row: match_len,
// sp, sa_row, sa_l, str_idx, sa_ok) in the warp's scratch, longest first.
// Merge in a probe's rows (thread k: row k), the first n_new valid ones
// (`stored` in their threads):
// each old record moves down past the new ones that are longer, each new
// one goes after every old one at least as long and after the earlier new
// ones at least as long (a stable sort by length of all records so far, of
// which the first MEM_SEARCH_SLOW stay). Returns the list's new length.
__device__ inline int top_merge(int* scr, int n_top, int n_new,
                                const lad::Row& r, bool stored, int str_idx,
                                int t) {
  using namespace lad;
  int* top = scr + SCR_TOP;
  int* nl = scr + SCR_NEW;
  if (t < MEM_SEARCH_SLOW) nl[t] = stored ? r.len : INT_BOT;
  __syncwarp();
  int old[TOP_NF];
  int at_old = MEM_SEARCH_SLOW, at_new = MEM_SEARCH_SLOW;
  if (t < n_top) {
    for (int f = 0; f < TOP_NF; ++f) old[f] = top[t * TOP_NF + f];
    at_old = t;
    for (int k = 0; k < MEM_SEARCH_SLOW; ++k) at_old += nl[k] > old[0];
  }
  if (stored) {
    at_new = 0;
    for (int i = 0; i < n_top; ++i) at_new += top[i * TOP_NF] >= r.len;
    for (int k = 0; k < MEM_SEARCH_SLOW; ++k)
      at_new += k < t ? nl[k] >= r.len : nl[k] > r.len;
  }
  __syncwarp();                       // every read of the old list is done
  if (at_old < MEM_SEARCH_SLOW)
    for (int f = 0; f < TOP_NF; ++f) top[at_old * TOP_NF + f] = old[f];
  if (at_new < MEM_SEARCH_SLOW) {
    int* m = top + at_new * TOP_NF;
    m[0] = r.len;
    m[1] = r.sp;
    m[2] = r.sa;
    m[3] = r.sa_l;
    m[4] = str_idx;
    m[5] = r.sa_ok;
  }
  __syncwarp();
  return imin(n_top + n_new, MEM_SEARCH_SLOW);
}

// The slow ladder of the calling warp's lane, over either table layout
template <class Args>
__device__ inline void slow_ladder_body(const Args& A) {
  using namespace lad;
  extern __shared__ __align__(16) int ladder_smem[];
  const int lane = warp_lane(A);
  if (lane < 0) return;
  const int t = threadIdx.x & 31;
  int* scr = warp_smem(ladder_smem, A);
  const Lane L = load_lane(A, lane);
  const int l_min = imin(MIN_MEM_LEN_SLOW - 1, A.l_ek + 1);
  IvSet S{scr + SCR_WORDS, A.iv_cap, 0, 0, 0};
  // The JAX ladder stores the first m_cap records, sorts them stably by
  // length (longest first) and maps the first MEM_SEARCH_SLOW. Only those
  // are kept here, in that order.
  int n_top = 0, m_cnt = 0, trips = 0;
  int j = L.seed_len - 1;
  bool active = L.on && j >= 1;
  while (active) {
    ++trips;
    const int ki = L.seed_off + j;
    const int str_idx = ki + A.l_ek - 1;
    const Row r = mem_probe<MEM_SEARCH_SLOW>(A, L.ridx, L.base, str_idx,
                                             probe_pre13(A, L, ki), S, l_min,
                                             scr, t);
    const unsigned valid = __ballot_sync(FULL, r.valid);
    // the valid rows in order while the lane has stored fewer than m_cap
    const bool stored =
        r.valid && m_cnt + popc32(valid & lanes_below(t)) < A.m_cap;
    const int n_new = imin(popc32(valid), A.m_cap - m_cnt);
    if (n_new > 0) n_top = top_merge(scr, n_top, n_new, r, stored, str_idx, t);
    m_cnt += popc32(valid);
    j -= 2;
    active = j >= 1;
  }
  int* anc = A.anchors + (size_t)lane * A.a_cap * A_NF;
  int a_cnt = 0;
  for (int k = 0; k < n_top; ++k) {
    const int* m = scr + SCR_TOP + k * TOP_NF;
    map_seed(A, L.ridx, L.base, L.read_len, L.dir, L.sid, m[1], m[0],
             m[5] != 0, m[2], m[3], m[4] - m[0], anc, a_cnt, t);
  }
  if (t == 0) {
    A.a_cnt[lane] = a_cnt;
    A.flag[lane] = m_cnt > A.m_cap;
    A.iv_ovf[lane] = S.ovf;
    A.trips[lane] = trips;
  }
}

// The kernels: B2 and B3 over whole tables (LadderArgs) and over tables
// cut by row range over the mesh's idx axis (ShardedLadderArgs, the JAX
// package's shard_full layout), one body each. The sharded argument block
// stays in the parameter space (__grid_constant__): the accessor reads a
// shard's pointer there, where a copy of the ~1.3 KB block would go to
// each thread's stack.
__global__ void __launch_bounds__(LADDER_THREADS, LADDER_MIN_BLOCKS)
    fast_ladder_kernel(lad::LadderArgs A) {
  fast_ladder_body(A);
}

__global__ void __launch_bounds__(LADDER_THREADS, LADDER_MIN_BLOCKS)
    slow_ladder_kernel(lad::LadderArgs A) {
  slow_ladder_body(A);
}

__global__ void __launch_bounds__(LADDER_THREADS, LADDER_MIN_BLOCKS)
    fast_ladder_sharded_kernel(
        const __grid_constant__ lad::ShardedLadderArgs A) {
  fast_ladder_body(A);
}

__global__ void __launch_bounds__(LADDER_THREADS, LADDER_MIN_BLOCKS)
    slow_ladder_sharded_kernel(
        const __grid_constant__ lad::ShardedLadderArgs A) {
  slow_ladder_body(A);
}

// The structs' sizes, so the caller can check its mirrors of them.
extern "C" int ladder_args_size() { return (int)sizeof(lad::LadderArgs); }
extern "C" int ladder_sharded_args_size() {
  return (int)sizeof(lad::ShardedLadderArgs);
}

// A block's dynamic shared memory at SP_SET capacity iv_cap: each warp's
// scratch and SP_SET. 0 for an iv_cap the launchers refuse.
extern "C" int ladder_smem_bytes(int iv_cap) {
  constexpr int most = 232448;        // a block's shared memory on Hopper
  if (iv_cap < 1 || iv_cap > most / 8) return 0;
  const int bytes = LADDER_WARPS * lad::warp_words(iv_cap) * 4;
  return bytes <= most ? bytes : 0;
}

#ifdef __CUDACC__
// The dynamic shared memory of a launch of `kernel` at iv_cap (0 for one
// that is refused), opted in to where it passes the default 48 KB.
static int ladder_smem_opt_in(const void* kernel, int iv_cap, int* smem) {
  *smem = ladder_smem_bytes(iv_cap);
  if (*smem == 0) return (int)cudaErrorInvalidValue;
  if (*smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// One warp a lane, LADDER_WARPS a block, on `stream` of card `device` (the
// card of every pointer in `a` but the shards of a sharded table, which
// it reaches by peer access): this library's current device is made
// `device` first, since the attribute and the launch go to the current one.
// Return the CUDA error code of the launch (0 = launched).
template <class Args>
static int ladder_launch(void (*kernel)(Args), const Args* a, int device,
                         cudaStream_t stream) {
  if (a->nb <= 0) return 0;
  int smem = 0;
  int e = (int)cudaSetDevice(device);
  if (e != 0) return e;
  e = ladder_smem_opt_in((const void*)kernel, a->iv_cap, &smem);
  if (e != 0) return e;
  kernel<<<(a->nb + LADDER_WARPS - 1) / LADDER_WARPS, LADDER_THREADS, smem,
           stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ladder_fast_launch(const lad::LadderArgs* a, int device,
                                  cudaStream_t stream) {
  return ladder_launch(fast_ladder_kernel, a, device, stream);
}

extern "C" int ladder_slow_launch(const lad::LadderArgs* a, int device,
                                  cudaStream_t stream) {
  return ladder_launch(slow_ladder_kernel, a, device, stream);
}

extern "C" int ladder_fast_sharded_launch(const lad::ShardedLadderArgs* a,
                                          int device, cudaStream_t stream) {
  return ladder_launch(fast_ladder_sharded_kernel, a, device, stream);
}

extern "C" int ladder_slow_sharded_launch(const lad::ShardedLadderArgs* a,
                                          int device, cudaStream_t stream) {
  return ladder_launch(slow_ladder_sharded_kernel, a, device, stream);
}

// Let card `device` load from card `peer` (a shard's) in this library's
// kernels: this library links its own CUDA runtime, so it enables the
// access itself. 0 once enabled (also where it already was).
extern "C" int ladder_enable_peer(int device, int peer) {
  int e = (int)cudaSetDevice(device);
  if (e != 0) return e;
  const cudaError_t r = cudaDeviceEnablePeerAccess(peer, 0);
  if (r == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();               // clear the sticky-free error state
    return 0;
  }
  return (int)r;
}
#endif
