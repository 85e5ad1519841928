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
// with an error. Blocks run one after another, so atomics and fences are
// plain host operations. The block size is the caller's: each thread has a
// STACK-byte stack, so a test runs the kernel at a small block. warp_emu.h
// is the stand-in for warp collectives; the two are not used together.
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

enum Kind { NONE, SYNC, SYNC_AND };

struct State {
  int cur = 0;                      // the running thread
  emu_dim3 bid{0, 0, 0}, bdim{0, 1, 1}, gdim{1, 1, 1};
  std::vector<emu_dim3> tid;
  ucontext_t sched;
  std::vector<ucontext_t> ctx;
  std::vector<char> stacks, done;
  std::vector<Kind> at;             // the barrier each thread waits at
  std::vector<int> in;              // each thread's predicate there
  int result = 0;                   // the last barrier's answer
  std::function<void()> body;
};
inline State S;

inline void thread_main() {
  S.body();
  S.done[S.cur] = 1;                // uc_link returns to the scheduler
}

// The calling thread waits at a barrier with predicate v; returns the
// barrier's answer once every thread of the block has arrived.
inline int arrive(Kind k, int v) {
  const int t = S.cur;
  S.in[t] = v;
  S.at[t] = k;
  swapcontext(&S.ctx[t], &S.sched);
  return S.result;
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
  for (int t = 0; t < threads; ++t) {
    S.tid[t] = emu_dim3{(unsigned)t, 0, 0};
    getcontext(&S.ctx[t]);
    S.ctx[t].uc_stack.ss_sp = S.stacks.data() + STACK * t;
    S.ctx[t].uc_stack.ss_size = STACK;
    S.ctx[t].uc_link = &S.sched;
    makecontext(&S.ctx[t], thread_main, 0);
  }
  for (;;) {
    for (int i = 0; i < threads; ++i) {
      S.cur = reverse ? threads - 1 - i : i;
      swapcontext(&S.sched, &S.ctx[S.cur]);
    }
    int n_done = 0;
    for (int t = 0; t < threads; ++t) n_done += S.done[t];
    if (n_done == threads) return nullptr;
    if (n_done != 0)
      return "some threads left the kernel while others wait at a barrier";
    for (int t = 1; t < threads; ++t)
      if (S.at[t] != S.at[0])
        return "the threads of a block wait at different barriers";
    int all = 1;
    for (int t = 0; t < threads; ++t) all &= S.in[t] != 0;
    S.result = S.at[0] == SYNC_AND ? all : 0;
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
  return bemu::arrive(bemu::SYNC_AND, pred);
}
