// kernels/cmpcount.cu compiled as host C++ over block_emu.h:
// cmpcount_emulate runs the kernel's grid on the CPU, block by block, with
// the arguments of cmpcount_launch (no stream), the block size and the order
// in which each block's threads run between barriers. Returns 0, or 1 with
// the reason in cmpcount_emu_error.
#include "block_emu.h"

alignas(16) int s_row[33792];   // one block's dynamic shared memory

#include "cmpcount.cu"

static_assert(sizeof(s_row) == sizeof(int) *
                  cmpcount_smem_words(CMPCOUNT_MAX_N - 1),
              "the largest row's shared memory");

static const char* last_error = "";

extern "C" const char* cmpcount_emu_error() { return last_error; }

extern "C" int cmpcount_emu_threads() { return CMPCOUNT_THREADS; }

extern "C" int cmpcount_emulate(const int* q, const int* t, int* out, int B,
                                int P, int K, int R, int threads,
                                int reverse) {
  if (K < 0 || R < 0 || K >= CMPCOUNT_MAX_N || threads <= 0) {
    last_error = "argument out of range";
    return 1;
  }
  for (int b = 0; b < B; ++b) {
    std::memset(s_row, 0xA5, sizeof(s_row));   // shared memory starts undefined
    const char* err = bemu::run_block(b, threads, reverse != 0, [&] {
      cmpcount_kernel(q, t, out, P, K, R);
    });
    if (err) {
      last_error = err;
      return 1;
    }
  }
  last_error = "";
  return 0;
}
