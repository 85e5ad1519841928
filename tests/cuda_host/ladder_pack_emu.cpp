// kernels/ladder_pack.cu compiled as host C++ over block_emu.h:
// pack2_emu and anchor_pack_emu run pack2_kernel's and anchor_pack_kernel's
// grids on the CPU, block by block, with their launchers' arguments (no
// stream), a block size and a grid of the caller's choosing and an order:
// `reverse` runs the blocks from the last to the first and each block's
// threads n-1..0 between barriers and warp collectives, so a shared word
// read before the barrier that orders its write shows in one of the two
// orders. Each returns 0, or 1 with the reason in ladder_pack_emu_error.
#include "block_emu.h"

// a block's shared words, poisoned before each block (shared memory starts
// undefined on the card)
alignas(16) int pack_smem[2 * 512 + 1 + 3 * 16 + 1 + 512 * 13];

#include "ladder_pack.cu"

static_assert(sizeof(pack_smem) == PACK_SMEM_WORDS * sizeof(int),
              "the anchor pack's launch");

static const char* last_error = "";

extern "C" const char* ladder_pack_emu_error() { return last_error; }

static int run(int k, int blocks, int threads, int reverse,
               std::function<void()> fn) {
  const int b = reverse ? blocks - 1 - k : k;
  const char* err =
      bemu::run_block(b, threads, reverse != 0, std::move(fn), blocks);
  last_error = err ? err : "";
  return err ? 1 : 0;
}

// codes (n, l) uint8, out (n, w): what ladder_pack2_launch takes, at
// `threads` a block; `wide` as the launcher chooses it (refused where the
// rows are not whole, aligned 16-byte words)
extern "C" int pack2_emu(const unsigned char* codes, int* out, int n, int l,
                         int w, int threads, int wide, int reverse) {
  if (n < 0 || l < 0 || w != (l + 15) / 16 || threads <= 0 ||
      threads > PACK2_THREADS || (wide && (l % 16 || ((size_t)codes & 15)))) {
    last_error = "argument out of range";
    return 1;
  }
  const long long words = (long long)n * w;
  const int blocks = (int)((words + threads - 1) / threads);
  for (int k = 0; k < blocks; ++k)
    if (run(k, blocks, threads, reverse, [&] {
          pack2_kernel(codes, out, words, l, w, wide);
        }))
      return 1;
  return 0;
}

// the launcher's grid at nb lanes, and its block
extern "C" int anchor_pack_emu_blocks(int nb) { return anchor_pack_blocks(nb); }
extern "C" int anchor_pack_emu_threads() { return anchor_pack_threads(); }

// anchors (nb, a_cap, 12), a_cnt, flag, iv_ovf (nb,); packed (pack_cap,
// 13), info (nb, 4), ovf one byte: what ladder_anchor_pack_launch takes
// (anchors and a_cnt 16-byte aligned), over `blocks` blocks (the launcher's chunk of
// lanes a block, at most a lane a thread) of `threads` threads (a multiple
// of 32 up to the launcher's)
extern "C" int anchor_pack_emu(const int* anchors, const int* a_cnt,
                               const int* flag, const int* iv_ovf,
                               int* packed, int* info, unsigned char* ovf,
                               int nb, int a_cap, int pack_cap, int blocks,
                               int threads, int reverse) {
  if (nb < 0 || a_cap < 1 || pack_cap < 0 || blocks < 1 || threads <= 0 ||
      threads > PACK_THREADS || threads % 32 || ((size_t)anchors & 15) ||
      ((size_t)a_cnt & 15)) {
    last_error = "argument out of range";
    return 1;
  }
  const int chunk = nb > 0 ? (nb + blocks - 1) / blocks : 1;
  if (chunk > threads) {
    last_error = "argument out of range: more lanes a block than threads";
    return 1;
  }
  for (int k = 0; k < blocks; ++k) {
    std::memset(pack_smem, 0xA5, sizeof(pack_smem));
    if (run(k, blocks, threads, reverse, [&] {
          anchor_pack_kernel(anchors, a_cnt, flag, iv_ovf, packed, info, ovf,
                             nb, a_cap, pack_cap, chunk);
        }))
      return 1;
  }
  return 0;
}
