// kernels/ladder.cu compiled as host C++ over block_emu.h: ladder_emulate
// runs fast_ladder_kernel's grid on the CPU, block by block, with the
// launcher's LadderArgs (no stream). `reverse` runs the blocks from the last
// to the first and each block's threads from n-1 to 0 (the kernel has no
// barrier, so a lane that read another's state would show in one order).
// Returns 0, or 1 with the reason in ladder_emu_error.
#include "block_emu.h"

#include "ladder.cu"

static const char* last_error = "";

extern "C" const char* ladder_emu_error() { return last_error; }

extern "C" int ladder_emulate(const lad::LadderArgs* a, int reverse) {
  const int blocks = (a->nb + LADDER_THREADS - 1) / LADDER_THREADS;
  for (int k = 0; k < blocks; ++k) {
    const int b = reverse ? blocks - 1 - k : k;
    const char* err = bemu::run_block(
        b, LADDER_THREADS, reverse != 0, [&] { fast_ladder_kernel(*a); },
        blocks);
    if (err) {
      last_error = err;
      return 1;
    }
  }
  last_error = "";
  return 0;
}
