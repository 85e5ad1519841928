// Host C++ stand-in for the part of the CUDA device API that the port's
// block-cooperative kernels use (one block's threads meeting at
// __syncthreads), so that a kernel source compiles with g++ and runs on the
// CPU against its plain version.
//
// A block's threads are coroutines (ucontext) on one host thread. Between
// two barriers (__syncthreads, __syncthreads_and) each thread runs alone, in
// thread order 0..n-1 or n-1..0. So a shared-memory write that one thread
// makes and another reads without a barrier between them shows as a
// different value in one of the two orders, and a barrier that not every
// thread reaches, or two different barriers reached at once, stops the run
// with an error. One warp collective is here too, __reduce_add_sync over
// the full mask: a warp's lanes (threads 32 w .. 32 w + 31) meet there while
// the other warps run on, and lanes of one warp that reach different
// collectives, or a barrier and a collective, stop the run. Blocks run one
// after another, so atomics and fences are plain host operations. The
// block size is the caller's: each thread has a STACK-byte stack, so a test
// runs the kernel at a small block. warp_emu.h is the stand-in for the
// other warp collectives; the two are not used together.
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

struct emu_dim3 {
  unsigned x, y, z;
};

namespace bemu {

constexpr size_t STACK = 64 * 1024;

// NONE: running; SYNC, SYNC_AND: block barriers; WARP_ADD: the warp sum
enum Kind { NONE, SYNC, SYNC_AND, WARP_ADD };

struct State {
  int cur = 0;                      // the running thread
  emu_dim3 bid{0, 0, 0}, bdim{0, 1, 1}, gdim{1, 1, 1};
  std::vector<emu_dim3> tid;
  ucontext_t sched;
  std::vector<ucontext_t> ctx;
  std::vector<char> stacks, done;
  std::vector<Kind> at;             // where each thread waits
  std::vector<unsigned> in;         // each thread's predicate or value there
  std::vector<unsigned> out;        // each thread's answer from its warp
  int result = 0;                   // the last barrier's answer
  std::function<void()> body;
};
inline State S;

inline void thread_main() {
  S.body();
  S.done[S.cur] = 1;                // uc_link returns to the scheduler
}

// The calling thread waits at a barrier or a warp collective with input v;
// returns the answer once every thread of the block (of the warp) has
// arrived.
inline unsigned arrive(Kind k, unsigned v) {
  const int t = S.cur;
  S.in[t] = v;
  S.at[t] = k;
  swapcontext(&S.ctx[t], &S.sched);
  return k == WARP_ADD ? S.out[t] : (unsigned)S.result;
}

// Release every warp whose lanes all wait in a warp collective; whether
// one was.
inline bool release_warps(int threads) {
  bool any = false;
  for (int lo = 0; lo < threads; lo += 32) {
    const int hi = lo + 32 < threads ? lo + 32 : threads;
    bool all = true;
    for (int t = lo; t < hi; ++t) all &= !S.done[t] && S.at[t] == WARP_ADD;
    if (!all) continue;
    unsigned sum = 0;
    for (int t = lo; t < hi; ++t) sum += S.in[t];
    for (int t = lo; t < hi; ++t) {
      S.out[t] = sum;
      S.at[t] = NONE;
    }
    any = true;
  }
  return any;
}

// Run block b of a grid of `blocks`, of `threads` threads each. Returns
// nullptr, or what went wrong.
inline const char* run_block(int b, int threads, bool reverse,
                             std::function<void()> fn, int blocks = 1) {
  S.body = std::move(fn);
  S.bid = emu_dim3{(unsigned)b, 0, 0};
  S.gdim = emu_dim3{(unsigned)blocks, 1, 1};
  S.bdim = emu_dim3{(unsigned)threads, 1, 1};
  S.tid.resize(threads);
  S.ctx.resize(threads);
  S.stacks.resize(STACK * threads);
  S.done.assign(threads, 0);
  S.at.assign(threads, NONE);
  S.in.assign(threads, 0);
  S.out.assign(threads, 0);
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
    if (release_warps(threads)) continue;
    int n_done = 0;
    for (int t = 0; t < threads; ++t) n_done += S.done[t];
    if (n_done == threads) return nullptr;
    for (int t = 0; t < threads; ++t)
      if (S.at[t] == WARP_ADD)
        return "the lanes of a warp wait in different collectives, or some "
               "left the kernel";
    if (n_done != 0)
      return "some threads left the kernel while others wait at a barrier";
    for (int t = 1; t < threads; ++t)
      if (S.at[t] != S.at[0])
        return "the threads of a block wait at different barriers";
    int all = 1;
    for (int t = 0; t < threads; ++t) all &= S.in[t] != 0;
    S.result = S.at[0] == SYNC_AND ? all : 0;
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

// Blocks run one after another on one host thread, so an atomic is a plain
// read-modify-write and a fence has nothing to order.
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
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
// the full warp's sum (a block size that is not a multiple of 32 makes its
// last warp short: its lanes' sum)
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return bemu::arrive(bemu::WARP_ADD, v);
}
