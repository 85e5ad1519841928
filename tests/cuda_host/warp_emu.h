// Host C++ stand-in for the part of the CUDA device API that the port's
// warp-cooperative kernels use, so that a kernel source compiles with g++
// and runs on the CPU against its plain version.
//
// A warp's 32 lanes are coroutines (ucontext) on one host thread. Between
// two warp collectives (__syncwarp, __shfl*_sync, __ballot_sync,
// __reduce_*_sync) each lane runs alone, in lane order 0..31 or 31..0.
// So a shared-memory write that a lane makes without a __syncwarp before
// the others read it shows as a different value in one of the two orders,
// and a collective that not every lane reaches (divergent control flow) or
// a mixture of collectives stops the run with an error. Warps run one after
// another; __syncthreads is not supported (the kernels emulated here keep
// their warps independent). Every collective takes the full mask.
#pragma once
#include <ucontext.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))

struct emu_dim3 {
  unsigned x, y, z;
};

namespace emu {

constexpr int LANES = 32;
constexpr size_t STACK = 256 * 1024;

enum Kind { NONE, SYNC, SHFL, SHFL_UP, BALLOT, RADD, RMAX };

struct State {
  int cur = 0;                      // the running lane
  emu_dim3 tid[LANES], bid{0, 0, 0}, bdim{0, 1, 1};
  ucontext_t sched, ctx[LANES];
  std::vector<char> stacks;
  bool done[LANES];
  Kind at[LANES];                   // the collective each lane waits in
  int gen[LANES];                   // collectives each lane has passed
  long long slot[2][LANES];         // inputs, double-buffered by generation
  std::function<void()> body;
  const char* error = nullptr;
};
inline State S;

inline void lane_main() {
  S.body();
  S.done[S.cur] = true;             // uc_link returns to the scheduler
}

// The calling lane enters a collective with input v; returns the buffer of
// every lane's input, valid until this lane's next collective.
inline long long* arrive(Kind k, long long v) {
  const int L = S.cur;
  long long* buf = S.slot[S.gen[L] & 1];
  buf[L] = v;
  S.at[L] = k;
  swapcontext(&S.ctx[L], &S.sched);
  ++S.gen[L];
  return buf;
}

// Run one warp of the block: lanes tid0 .. tid0 + 31.
inline void run_warp(int tid0, bool reverse) {
  S.stacks.resize(STACK * LANES);
  for (int l = 0; l < LANES; ++l) {
    S.tid[l] = emu_dim3{(unsigned)(tid0 + l), 0, 0};
    S.done[l] = false;
    S.gen[l] = 0;
    S.at[l] = NONE;
    getcontext(&S.ctx[l]);
    S.ctx[l].uc_stack.ss_sp = S.stacks.data() + STACK * l;
    S.ctx[l].uc_stack.ss_size = STACK;
    S.ctx[l].uc_link = &S.sched;
    makecontext(&S.ctx[l], lane_main, 0);
  }
  for (;;) {
    for (int i = 0; i < LANES; ++i) {
      S.cur = reverse ? LANES - 1 - i : i;
      swapcontext(&S.sched, &S.ctx[S.cur]);
    }
    int n_done = 0;
    for (int l = 0; l < LANES; ++l) n_done += S.done[l];
    if (n_done == LANES) return;
    if (n_done != 0) {
      S.error = "some lanes left the kernel while others wait in a collective";
      return;
    }
    for (int l = 1; l < LANES; ++l)
      if (S.at[l] != S.at[0]) {
        S.error = "the lanes of a warp wait in different collectives";
        return;
      }
  }
}

// Run fn on a grid of `blocks` blocks of `threads` threads (a multiple of
// 32), warp by warp. Returns nullptr, or what went wrong.
inline const char* run(int blocks, int threads, bool reverse,
                       std::function<void()> fn) {
  S.body = std::move(fn);
  S.error = nullptr;
  S.bdim = emu_dim3{(unsigned)threads, 1, 1};
  for (int b = 0; b < blocks && !S.error; ++b) {
    S.bid = emu_dim3{(unsigned)b, 0, 0};
    for (int w = 0; w < threads / LANES && !S.error; ++w)
      run_warp(w * LANES, reverse);
  }
  return S.error;
}

}  // namespace emu

#define threadIdx (emu::S.tid[emu::S.cur])
#define blockIdx (emu::S.bid)
#define blockDim (emu::S.bdim)

// ---- the device API ---------------------------------------------------------
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz((unsigned)v); }
inline int __ffs(int v) { return __builtin_ffs(v); }

inline void __syncwarp(unsigned = 0xffffffffu) { emu::arrive(emu::SYNC, 0); }
inline void __syncthreads() {
  std::fprintf(stderr, "warp_emu: __syncthreads is not emulated\n");
  std::abort();
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  long long* buf = emu::arrive(emu::SHFL, bits);
  T out;
  std::memcpy(&out, &buf[src & 31], sizeof(T));
  return out;
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int L = threadIdx.x & 31;
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  long long* buf = emu::arrive(emu::SHFL_UP, bits);
  T out;
  std::memcpy(&out, &buf[(int)d <= L ? L - (int)d : L], sizeof(T));
  return out;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  long long* buf = emu::arrive(emu::BALLOT, pred != 0);
  unsigned r = 0;
  for (int l = 0; l < emu::LANES; ++l) r |= (unsigned)(buf[l] != 0) << l;
  return r;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  long long* buf = emu::arrive(emu::RADD, v);
  unsigned r = 0;
  for (int l = 0; l < emu::LANES; ++l) r += (unsigned)buf[l];
  return r;
}
inline int __reduce_max_sync(unsigned, int v) {
  long long* buf = emu::arrive(emu::RMAX, v);
  int r = (int)buf[0];
  for (int l = 1; l < emu::LANES; ++l) r = r > (int)buf[l] ? r : (int)buf[l];
  return r;
}
