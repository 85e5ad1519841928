// Host C++ stand-in for the part of the CUDA device API that the port's
// block-cooperative kernels use (one block's threads meeting at
// __syncthreads, and each warp's lanes at its collectives), so that a
// kernel source compiles with g++ and runs on the CPU against its plain
// version.
//
// A block's threads are coroutines (ucontext) on one host thread. Between
// two barriers or collectives each thread runs alone, in thread order
// 0..n-1 or n-1..0. So a shared-memory write that one thread makes and
// another reads without a barrier between them shows as a different value
// in one of the two orders. A barrier (__syncthreads, __syncthreads_and,
// __syncthreads_or) releases once every thread of the block waits there.
// A warp collective (__syncwarp, __shfl_sync, __shfl_up_sync,
// __ballot_sync, __reduce_add_sync, __reduce_max_sync, __reduce_min_sync)
// takes a mask of the warp's lanes (threads 32 w .. 32 w + 31; a block
// size that is not a multiple of 32 makes its last warp short) and
// releases once every lane of the mask waits in a collective of the same
// kind with the same mask, while the other lanes and warps run on; the
// shuffles also take a width (a power of two up to 32) that cuts the warp
// into segments, as on the card. Threads that wait where no release can
// come (a lane of a mask that left the kernel or waits elsewhere, a
// barrier not every thread reaches, two different barriers at once) stop
// the run with an error, and so does a shuffle from a lane outside its
// mask. Blocks run one after another, so atomics and fences are plain host
// operations. The block size is the caller's: each thread has a STACK-byte
// stack. warp_emu.h is the stand-in for warp-only kernels; the two are not
// used together.
#pragma once
#define CUDA_HOST_BLOCK_EMU 1
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
#define __shared__
#define __launch_bounds__(...)
#ifndef __align__
#define __align__(n) __attribute__((aligned(n)))
#endif

struct emu_dim3 {
  unsigned x, y, z;
};

namespace bemu {

constexpr size_t STACK = 64 * 1024;

// NONE: running; SYNC*: block barriers; the rest: warp collectives
enum Kind {
  NONE, SYNC, SYNC_AND, SYNC_OR,
  W_SYNC, W_SHFL, W_SHFL_UP, W_BALLOT, W_ADD, W_MAX, W_MIN, W_MAXU, W_MINU
};

struct State {
  int cur = 0;                      // the running thread
  emu_dim3 bid{0, 0, 0}, bdim{0, 1, 1}, gdim{1, 1, 1};
  std::vector<emu_dim3> tid;
  ucontext_t sched;
  std::vector<ucontext_t> ctx;
  std::vector<char> stacks, done;
  std::vector<Kind> at;             // where each thread waits
  std::vector<long long> in;        // each thread's input there
  std::vector<long long> out;       // each thread's answer from its warp
  std::vector<unsigned> mask;       // a collective's lanes
  std::vector<int> arg, width;      // a shuffle's lane or delta, its width
  int result = 0;                   // the last barrier's answer
  const char* error = nullptr;
  std::function<void()> body;
};
inline State S;

inline void thread_main() {
  S.body();
  S.done[S.cur] = 1;                // uc_link returns to the scheduler
}

// The calling thread waits at a barrier or a warp collective with input v;
// returns the answer once every thread of the block (of the mask) has
// arrived.
inline long long arrive(Kind k, long long v, unsigned mask = 0xFFFFFFFFu,
                        int arg = 0, int width = 32) {
  const int t = S.cur;
  S.in[t] = v;
  S.at[t] = k;
  S.mask[t] = mask;
  S.arg[t] = arg;
  S.width[t] = width;
  swapcontext(&S.ctx[t], &S.sched);
  return k >= W_SYNC ? S.out[t] : S.result;
}

// Release every group of lanes that all wait in one collective; whether
// one was (or an error was found).
inline bool release_warps(int threads) {
  bool any = false;
  for (int lo = 0; lo < threads; lo += 32) {
    const int hi = lo + 32 < threads ? lo + 32 : threads;
    const unsigned present =
        hi - lo == 32 ? 0xFFFFFFFFu : (1u << (hi - lo)) - 1u;
    for (int t = lo; t < hi; ++t) {
      if (S.done[t] || S.at[t] < W_SYNC) continue;
      const Kind k = S.at[t];
      const unsigned m = S.mask[t] & present;
      if (!((m >> (t - lo)) & 1u)) {
        S.error = "a lane waits in a collective whose mask leaves it out";
        return true;
      }
      bool all = true;
      for (int u = lo; u < hi && all; ++u)
        if ((m >> (u - lo)) & 1u)
          all = !S.done[u] && S.at[u] == k && S.mask[u] == S.mask[t];
      if (!all) continue;
      long long acc = 0;
      unsigned bits = 0;
      bool first = true;
      for (int u = lo; u < hi; ++u) {
        if (!((m >> (u - lo)) & 1u)) continue;
        const long long x = S.in[u];
        bits |= (unsigned)(x != 0) << (u - lo);
        switch (k) {
          case W_ADD: acc = (long long)(unsigned)((unsigned)acc + (unsigned)x);
            break;
          case W_MAX: acc = first || (int)x > (int)acc ? (int)x : acc; break;
          case W_MIN: acc = first || (int)x < (int)acc ? (int)x : acc; break;
          case W_MAXU:
            acc = first || (unsigned)x > (unsigned)acc ? (unsigned)x : acc;
            break;
          case W_MINU:
            acc = first || (unsigned)x < (unsigned)acc ? (unsigned)x : acc;
            break;
          default: break;
        }
        first = false;
      }
      for (int u = lo; u < hi; ++u) {
        if (!((m >> (u - lo)) & 1u)) continue;
        const int l = u - lo, w = S.width[u], seg = l & ~(w - 1);
        int src = l;
        if (k == W_SHFL) src = seg + (S.arg[u] & (w - 1));
        if (k == W_SHFL_UP && (l & (w - 1)) >= S.arg[u]) src = l - S.arg[u];
        if ((k == W_SHFL || k == W_SHFL_UP) && !((m >> src) & 1u)) {
          S.error = "a shuffle reads a lane outside its mask";
          return true;
        }
        S.out[u] = k == W_SHFL || k == W_SHFL_UP ? S.in[lo + src]
                   : k == W_BALLOT               ? (long long)bits
                                                 : acc;
      }
      for (int u = lo; u < hi; ++u)
        if ((m >> (u - lo)) & 1u) S.at[u] = NONE;
      any = true;
    }
  }
  return any;
}

// Run block (b, by) of a grid of blocks x blocks_y, of `threads` threads
// each. Returns nullptr, or what went wrong.
inline const char* run_block(int b, int threads, bool reverse,
                             std::function<void()> fn, int blocks = 1,
                             int by = 0, int blocks_y = 1) {
  S.body = std::move(fn);
  S.error = nullptr;
  S.bid = emu_dim3{(unsigned)b, (unsigned)by, 0};
  S.gdim = emu_dim3{(unsigned)blocks, (unsigned)blocks_y, 1};
  S.bdim = emu_dim3{(unsigned)threads, 1, 1};
  S.tid.resize(threads);
  S.ctx.resize(threads);
  S.stacks.resize(STACK * threads);
  S.done.assign(threads, 0);
  S.at.assign(threads, NONE);
  S.in.assign(threads, 0);
  S.out.assign(threads, 0);
  S.mask.assign(threads, 0);
  S.arg.assign(threads, 0);
  S.width.assign(threads, 32);
  for (int t = 0; t < threads; ++t) {
    S.tid[t] = emu_dim3{(unsigned)t, 0, 0};
    getcontext(&S.ctx[t]);
    S.ctx[t].uc_stack.ss_sp = S.stacks.data() + STACK * t;
    S.ctx[t].uc_stack.ss_size = STACK;
    S.ctx[t].uc_link = &S.sched;
    makecontext(&S.ctx[t], thread_main, 0);
  }
  for (;;) {
    // every running thread runs until it waits or leaves, in thread order
    for (int i = 0; i < threads; ++i) {
      S.cur = reverse ? threads - 1 - i : i;
      if (!S.done[S.cur] && S.at[S.cur] == NONE)
        swapcontext(&S.sched, &S.ctx[S.cur]);
    }
    const bool released = release_warps(threads);
    if (S.error) return S.error;
    if (released) continue;
    int n_done = 0;
    for (int t = 0; t < threads; ++t) n_done += S.done[t];
    if (n_done == threads) return nullptr;
    for (int t = 0; t < threads; ++t)
      if (!S.done[t] && S.at[t] >= W_SYNC)
        return "the lanes of a warp wait in different collectives, or some "
               "left the kernel";
    if (n_done != 0)
      return "some threads left the kernel while others wait at a barrier";
    for (int t = 1; t < threads; ++t)
      if (S.at[t] != S.at[0])
        return "the threads of a block wait at different barriers";
    int all = 1, some = 0;
    for (int t = 0; t < threads; ++t) {
      all &= S.in[t] != 0;
      some |= S.in[t] != 0;
    }
    S.result = S.at[0] == SYNC_AND ? all : S.at[0] == SYNC_OR ? some : 0;
    for (int t = 0; t < threads; ++t) S.at[t] = NONE;
  }
}

}  // namespace bemu

#define threadIdx (bemu::S.tid[bemu::S.cur])
#define blockIdx (bemu::S.bid)
#define blockDim (bemu::S.bdim)
#define gridDim (bemu::S.gdim)

// ---- the device API ---------------------------------------------------------
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz((unsigned)v); }
inline int __ffs(int v) { return __builtin_ffs(v); }

// the 16-byte vector word, and a load through the read-only data cache
struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// cp.async (cuda_pipeline.h): the copy lands at once, and the commit and
// the wait have nothing to order. A thread that reads another's copy
// without a barrier between them still reads stale words in one of the two
// thread orders.
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

// Blocks run one after another on one host thread, and a block's threads
// run one at a time between collectives, so an atomic is a plain
// read-modify-write and a fence has nothing to order.
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline int atomicMax(int* p, int v) {
  const int old = *p;
  if (v > old) *p = v;
  return old;
}
inline void __threadfence() {}
inline unsigned __ldcg(const unsigned* p) { return *p; }

// Shared-space addresses: byte offsets from bemu::shared_base, which the
// emulation unit points at its shared memory, plus bemu::SHARED_AT (so
// that, as on the card, a block's shared memory does not start at 0).
namespace bemu {
constexpr unsigned SHARED_AT = 1024;
inline const char* shared_base = nullptr;
}  // namespace bemu
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const char*)p - bemu::shared_base) + bemu::SHARED_AT;
}
inline void* __cvta_shared_to_generic(size_t a) {
  return (void*)(bemu::shared_base + (a - bemu::SHARED_AT));
}

inline void __syncthreads() { bemu::arrive(bemu::SYNC, 1); }
inline int __syncthreads_and(int pred) {
  return (int)bemu::arrive(bemu::SYNC_AND, pred != 0);
}
inline int __syncthreads_or(int pred) {
  return (int)bemu::arrive(bemu::SYNC_OR, pred != 0);
}

inline void __syncwarp(unsigned mask = 0xFFFFFFFFu) {
  bemu::arrive(bemu::W_SYNC, 0, mask);
}
template <class T>
inline T __shfl_sync(unsigned mask, T v, int src, int width = 32) {
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  bits = bemu::arrive(bemu::W_SHFL, bits, mask, src, width);
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}
template <class T>
inline T __shfl_up_sync(unsigned mask, T v, unsigned d, int width = 32) {
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  bits = bemu::arrive(bemu::W_SHFL_UP, bits, mask, (int)d, width);
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  return (unsigned)bemu::arrive(bemu::W_BALLOT, pred != 0, mask);
}
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  return (unsigned)bemu::arrive(bemu::W_ADD, v, mask);
}
inline int __reduce_max_sync(unsigned mask, int v) {
  return (int)bemu::arrive(bemu::W_MAX, v, mask);
}
inline int __reduce_min_sync(unsigned mask, int v) {
  return (int)bemu::arrive(bemu::W_MIN, v, mask);
}
inline unsigned __reduce_max_sync(unsigned mask, unsigned v) {
  return (unsigned)bemu::arrive(bemu::W_MAXU, v, mask);
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
  return (unsigned)bemu::arrive(bemu::W_MINU, v, mask);
}
