// kernels/chain.cu compiled as host C++ over block_emu.h: chain_emulate and
// m3_emulate run chain_kernel's and m3_kernel<W>'s grids on the CPU, block
// by block, at their launchers' block shapes (four warps a block for M2, a
// read a warp; W warps for M3), with the arguments of their launchers (no
// stream) and the order in which each block's threads run between barriers
// and warp collectives (reverse also runs the blocks last to first). Shared
// memory starts as 0xA5 bytes in every block. emu_probe runs the small
// probe kernels below, which hold block_emu.h's warp collectives to their
// CUDA meaning. Each returns 0, or 1 with the reason in chain_emu_error.
#include "block_emu.h"

alignas(16) int m3_smem[232448 / 4];   // one M3 block's dynamic shared memory
alignas(16) int m2_smem[4 * 32 * 8];   // one M2 block's

#include "chain.cu"

static_assert(sizeof(m2_smem) == CHAIN_WARPS * M2_STAGE * sizeof(int),
              "M2's launch");

static const char* last_error = "";

extern "C" const char* chain_emu_error() { return last_error; }

static int finish(const char* err) {
  last_error = err ? err : "";
  return err ? 1 : 0;
}

static int run_grid(int blocks, int threads, int reverse, int* smem,
                    size_t smem_size, const std::function<void()>& fn) {
  for (int k = 0; k < blocks; ++k) {
    std::memset(smem, 0xA5, smem_size);   // starts undefined
    const int b = reverse ? blocks - 1 - k : k;
    if (finish(bemu::run_block(b, threads, reverse != 0, fn, blocks)))
      return 1;
  }
  return 0;
}

extern "C" int chain_emulate(const int* anc, const int* n_anc, int* chains,
                             int* n_out, int* pre, unsigned char* ovf, int B,
                             int A2, int reverse) {
  return run_grid((B + CHAIN_WARPS - 1) / CHAIN_WARPS, CHAIN_WARPS * 32,
                  reverse, m2_smem, sizeof(m2_smem), [&] {
                    chain_kernel(anc, n_anc, chains, n_out, pre, ovf, B, A2);
                  });
}

extern "C" int m3_emulate(const int* anc, const int* n_anc, int* chains,
                          int* n_out, int* pre, unsigned char* ovf, int B,
                          int A2, int warps, int reverse) {
  if ((size_t)m3_smem_bytes(A2) > sizeof(m3_smem) || A2 < chn::C2 ||
      A2 > M3_MAX_A2)
    return finish("A2 out of range");
  if (warps != 4 && warps != 8) return finish("warps must be 4 or 8");
  return run_grid(B, warps * 32, reverse, m3_smem, sizeof(m3_smem), [&] {
    if (warps == 8)
      m3_kernel<8>(anc, n_anc, chains, n_out, pre, ovf, A2);
    else
      m3_kernel<4>(anc, n_anc, chains, n_out, pre, ovf, A2);
  });
}

// ---- probes of the collectives ----------------------------------------------
// Each writes one word a thread into out; `skip` is a lane that leaves a
// collective out (or -1).
enum {
  P_SHFL,        // full-mask shuffle from lane 7 l + 3, and at width 16
  P_SHFL_UP,     // shuffles up by 3, at width 32 and 8
  P_BALLOT,      // a full-mask ballot, then each half-warp's own
  P_REDUCE,      // max, min (int and unsigned) and sum over the full warp
  P_HALF,        // max and sum over each half-warp, the halves at
                 // different collectives in between
  P_SYNC_OR,     // __syncthreads_or of one thread's predicate
  P_SKIP,        // lane `skip` leaves a ballot out
  P_OUTSIDE,     // lane 0 shuffles from a lane outside its half's mask
};

extern "C" int emu_probe(int which, int threads, int skip, int reverse,
                         int* out) {
  return run_grid(1, threads, reverse, m2_smem, sizeof(m2_smem), [&] {
    const int t = threadIdx.x, l = t & 31;
    const unsigned half = l < 16 ? 0x0000FFFFu : 0xFFFF0000u;
    const int v = t * 37 - 500;
    unsigned r = 0;                         // wraps, as the numpy side does
    switch (which) {
      case P_SHFL:
        r = (unsigned)__shfl_sync(0xFFFFFFFFu, v, 7 * l + 3) * 1000u +
            (unsigned)__shfl_sync(half, v, 5, 16);
        break;
      case P_SHFL_UP:
        r = (unsigned)__shfl_up_sync(0xFFFFFFFFu, v, 3) * 1000u +
            (unsigned)__shfl_up_sync(0xFFFFFFFFu, v, 3, 8);
        break;
      case P_BALLOT:
        r = __ballot_sync(0xFFFFFFFFu, v % 3 == 0) ^
            __ballot_sync(half, l % 5 == 1);
        break;
      case P_REDUCE:
        r = (unsigned)__reduce_max_sync(0xFFFFFFFFu, v ^ (l * 977)) +
            (unsigned)__reduce_min_sync(0xFFFFFFFFu, v ^ (l * 977)) * 3u +
            __reduce_max_sync(0xFFFFFFFFu, (unsigned)v * 13u) * 5u +
            __reduce_min_sync(0xFFFFFFFFu, (unsigned)v * 13u) * 7u +
            __reduce_add_sync(0xFFFFFFFFu, (unsigned)v) * 11u;
        break;
      case P_HALF:
        r = (unsigned)__reduce_max_sync(half, v * (l % 7 - 3));
        if (l < 16)
          r += __ballot_sync(half, l & 1);
        else
          __syncwarp(half);
        r += __reduce_add_sync(half, (unsigned)l) * 100u;
        break;
      case P_SYNC_OR:
        r = (unsigned)(__syncthreads_or(t == skip) * 2 + __syncthreads_or(0));
        break;
      case P_SKIP:
        if (l != skip) r = __ballot_sync(0xFFFFFFFFu, 1);
        r += __reduce_add_sync(0xFFFFFFFFu, 1u);
        break;
      case P_OUTSIDE:
        r = (unsigned)__shfl_sync(half, v, l == 0 ? 20 : l);
        break;
      default:
        break;
    }
    out[t] = (int)r;
  });
}
