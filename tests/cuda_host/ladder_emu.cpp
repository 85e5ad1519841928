// kernels/ladder.cu compiled as host C++ over warp_emu.h: ladder_emulate and
// ladder_slow_emulate run fast_ladder_kernel's and slow_ladder_kernel's
// grids on the CPU, warp by warp (a warp runs one lane), with the
// launcher's LadderArgs (no stream) and shared memory;
// ladder_sharded_emulate and ladder_slow_sharded_emulate run the sharded
// kernels the same way on a ShardedLadderArgs. `reverse` runs each
// warp's 32 threads from 31 to 0 between collectives, so a shared-memory
// write that another thread reads without a __syncwarp between them shows
// in one of the two orders. Returns 0, or 1 with the reason in
// ladder_emu_error.
#include "warp_emu.h"

alignas(16) int ladder_smem[232448 / 4];   // one block's dynamic shared memory

#include "ladder.cu"

static const char* last_error = "";

extern "C" const char* ladder_emu_error() { return last_error; }

template <typename Args, typename Kernel>
static int emulate(const Args* a, int reverse, Kernel kernel) {
  const int smem = ladder_smem_bytes(a->iv_cap);
  if (smem == 0 || (size_t)smem > sizeof(ladder_smem)) {
    last_error = "the SP_SET does not fit a block's shared memory";
    return 1;
  }
  std::memset(ladder_smem, 0xA5, sizeof(ladder_smem));   // starts undefined
  const char* err =
      emu::run((a->nb + LADDER_WARPS - 1) / LADDER_WARPS, LADDER_THREADS,
               reverse != 0, [&] { kernel(*a); });
  last_error = err ? err : "";
  return err ? 1 : 0;
}

extern "C" int ladder_emulate(const lad::LadderArgs* a, int reverse) {
  return emulate(a, reverse, fast_ladder_kernel);
}

extern "C" int ladder_slow_emulate(const lad::LadderArgs* a, int reverse) {
  return emulate(a, reverse, slow_ladder_kernel);
}

extern "C" int ladder_sharded_emulate(const lad::ShardedLadderArgs* a,
                                      int reverse) {
  return emulate(a, reverse, fast_ladder_sharded_kernel);
}

extern "C" int ladder_slow_sharded_emulate(const lad::ShardedLadderArgs* a,
                                           int reverse) {
  return emulate(a, reverse, slow_ladder_sharded_kernel);
}
