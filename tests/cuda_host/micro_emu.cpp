// The five kernels of kernels/micro.cu that compile as host C++
// (lgather_kernel, K6.2, rgather_kernel, K6.3, oneprog_kernel, K5.c,
// egather_kernel, K4.2, and rowgather_kernel, K4.1) over block_emu.h:
// micro_emu_lgather, micro_emu_rgather, micro_emu_oneprog,
// micro_emu_egather and micro_emu_rowgather run each kernel's grid on the
// CPU, block by block, with
// the arguments of its launcher (no stream), the block size and an order:
// `reverse` runs the blocks from the last to the first (so another block
// finishes last) and each block's threads n-1..0 between barriers and warp
// collectives. Each returns 0, or 1 with the reason in micro_emu_error.
#include "block_emu.h"

// lgather's shared memory: twice the largest table micro_lgather takes, 64
// rows (a power of two within 48 KB)
alignas(16) int s_lg[2 * 64 * 128];
// rgather's: the most a block may take (227 KB)
alignas(16) unsigned s_rg[232448 / 4];
// oneprog's: A and B of each thread's map, and the last-block flag
unsigned s_op[2 * 256 + 1];
// egather's: the largest row micro_egather stages
alignas(16) int s_eg[12288];

#include "micro.cu"

static_assert(sizeof(s_rg) == RG_MAX_SMEM, "rgather's largest launch");

static_assert(sizeof(s_op) == (2 * OP_THREADS + 1) * sizeof(unsigned),
              "oneprog's launch");
static_assert(sizeof(s_eg) == EG_MAX_EK * sizeof(int), "egather's launch");

static const char* last_error = "";


extern "C" const char* micro_emu_error() { return last_error; }

// the k-th block to run of `blocks`
static int run(int k, int blocks, int threads, int reverse,
               std::function<void()> fn) {
  const int b = reverse ? blocks - 1 - k : k;
  const char* err =
      bemu::run_block(b, threads, reverse != 0, std::move(fn), blocks);
  last_error = err ? err : "";
  return err ? 1 : 0;
}

// tab (rows, 128), idx (r, 128), out (r, 128) zeroed; `blocks` blocks of
// `chunk` trips cover n (micro_lgather's checks)
extern "C" int micro_emu_lgather(const int* tab, const int* idx, int* out,
                                 int r, int rows, int n, int blocks,
                                 int chunk, int threads, int reverse) {
  if (!pow2(rows) || rows > 64 || threads <= 0 || threads > LG_THREADS ||
      !split_ok(n, blocks, chunk)) {
    last_error = "argument out of range";
    return 1;
  }
  bemu::shared_base = (const char*)s_lg;
  for (int b = 0; b < blocks; ++b) {
    std::memset(s_lg, 0xA5, sizeof(s_lg));   // shared memory starts undefined
    if (run(b, blocks, threads, reverse,
            [&] { lgather_kernel(tab, idx, out, rows, r * RW, n, chunk); }))
      return 1;
  }
  return 0;
}

// tab (rows, 128), idx (r, 128), out (r, 128) zeroed; what micro_rgather
// takes (rg_args_ok), at `threads` a block (a multiple of 32)
extern "C" int micro_emu_rgather(const int* tab, const int* idx, int* out,
                                 int r, int rows, int n, int splits,
                                 int chunk, int threads, int reverse) {
  if (!rg_args_ok(r, rows, n, splits, chunk) || threads <= 0 ||
      threads > RG_THREADS || threads % 32) {
    last_error = "argument out of range";
    return 1;
  }
  const int blocks = splits * RW;
  for (int b = 0; b < blocks; ++b) {
    std::memset(s_rg, 0xA5, rg_smem(rows));   // shared memory starts undefined
    if (run(b, blocks, threads, reverse, [&] {
          rgather_kernel(tab, idx, out, rows, r, n, splits, chunk);
        }))
      return 1;
  }
  return 0;
}

// whether micro_rgather stages a column of a `rows`-row table
extern "C" int micro_emu_rgather_fits(int rows) {
  return rg_args_ok(1, rows, 1, 1, 1);
}

// x and out (8, 128); scratch (1 + 2 * blocks,) zeroed; the split as for
// micro_lgather
extern "C" int micro_emu_oneprog(const int* x, unsigned* scratch, int* out,
                                 int n, int blocks, int chunk, int threads,
                                 int reverse) {
  if (threads <= 0 || threads > OP_THREADS || !split_ok(n, blocks, chunk)) {
    last_error = "argument out of range";
    return 1;
  }
  for (int b = 0; b < blocks; ++b) {
    std::memset(s_op, 0xA5, sizeof(s_op));
    if (run(b, blocks, threads, reverse, [&] {
          oneprog_kernel(x, scratch, scratch + 1, out, n, chunk);
        }))
      return 1;
  }
  return 0;
}

// tab (eb, ek), idx (eb, en), out (eb, en): what micro_egather takes
// (egather_args_ok), its grid of (eb, en / threads) blocks at `threads` a
// block (up to the launcher's), in 16-byte copies where `wide` (the
// launcher's choice for whole 16-byte words) and in 4-byte ones otherwise
extern "C" int micro_emu_egather(const int* tab, const int* idx, int* out,
                                 int eb, int ek, int en, int reps, int wide,
                                 int threads, int reverse) {
  if (!egather_args_ok(eb, ek, en, reps) || threads <= 0 ||
      threads > EG_THREADS || (wide && (ek % 4 || ((size_t)tab & 15)))) {
    last_error = "argument out of range";
    return 1;
  }
  const int by = (en + threads - 1) / threads, blocks = eb * by;
  for (int k = 0; k < blocks; ++k) {
    const int j = reverse ? blocks - 1 - k : k;
    std::memset(s_eg, 0xA5, sizeof(s_eg));   // shared memory starts undefined
    const char* err = bemu::run_block(
        j / by, threads, reverse != 0,
        [&] { egather_kernel(tab, idx, out, ek, en, reps, wide); }, eb,
        j % by, by);
    last_error = err ? err : "";
    if (err) return 1;
  }
  return 0;
}

// tab (rows, 128), idx (g, 128), out (g, 128): what micro_rowgather takes,
// at `warps` gathered rows a block (the launcher's RG4_WARPS, or another
// count up to 32), in 16-byte loads where `wide` (the launcher's choice where tab and
// out are 16-byte aligned) and in 4-byte ones otherwise
extern "C" int micro_emu_rowgather(const int* tab, const int* idx, int* out,
                                   int g, int rows, int reps, int warps,
                                   int wide, int reverse) {
  if (g <= 0 || !pow2(rows) || reps < 0 || warps <= 0 || warps > 32 ||
      (wide && (((size_t)tab & 15) || ((size_t)out & 15)))) {
    last_error = "argument out of range";
    return 1;
  }
  const int blocks = (g + warps - 1) / warps;
  for (int k = 0; k < blocks; ++k)
    if (run(k, blocks, 32 * warps, reverse, [&] {
          if (wide)
            rowgather_kernel<true>(tab, idx, out, g, rows - 1, reps);
          else
            rowgather_kernel<false>(tab, idx, out, g, rows - 1, reps);
        }))
      return 1;
  return 0;
}

// the launcher's rows a block
extern "C" int micro_emu_rowgather_warps() { return RG4_WARPS; }
