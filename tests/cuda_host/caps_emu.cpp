// The probes of kernels/caps.cu compiled as host C++ over block_emu.h:
// caps_emu runs probe `probe` (the launcher's order, p_s2 last) as its one
// block, with the launcher's arguments and block size, the block's threads
// in order 0..n-1 or, with `reverse`, n-1..0 between barriers and warp
// collectives. It returns 0, or 1 with the reason in caps_emu_error.
#include "block_emu.h"

// A probe's static shared words: one copy, which the block's emulated
// threads share, as a block's shared memory on the card.
#undef __shared__
#define __shared__ static

#include "caps.cu"

static const char* last_error = "";

extern "C" const char* caps_emu_error() { return last_error; }

// the probes caps_launch takes, p_s2 included
extern "C" int caps_emu_count() { return N_PROBES + 1; }

static const char* run(int probe, const int* a, const int* b, int* out,
                       int n, int reverse) {
  return bemu::run_block(0, caps_threads(probe), reverse != 0, [&] {
    if (probe == N_PROBES)
      p_s2((const int4*)a, b, (int4*)out);
    else
      PROBES[probe](a, b, out, n);
  });
}

// Shared memory starts undefined on the card, and the static words above
// keep the last run's values: so the probe runs first on these words (as
// large as its largest input, no two alike), which leave other values in
// its shared words than the real run writes.
alignas(16) static int poison[64 * 512];
alignas(16) static int sink[8 * 128];

extern "C" int caps_emu(int probe, const int* a, const int* b, int* out,
                        int n, int reverse) {
  if (!caps_args_ok(probe, a, out, n)) {
    last_error = "argument out of range";
    return 1;
  }
  for (int i = 0; i < 64 * 512; ++i)
    poison[i] = (int)(0x9E3779B1u * (unsigned)(i + 1));
  const char* err = run(probe, poison, poison, sink, 64, reverse);
  if (!err) err = run(probe, a, b, out, n, reverse);
  last_error = err ? err : "";
  return err ? 1 : 0;
}
