// kernels/chain.cu compiled as host C++ over warp_emu.h: chain_emulate and
// m3_emulate run chain_kernel's and m3_kernel's grids on the CPU, warp by
// warp, with the arguments of their launchers (no stream) and the order in
// which each warp's lanes run between collectives. Returns 0, or 1 with
// the reason in chain_emu_error.
#include "warp_emu.h"

alignas(16) int m3_smem[232448 / 4];   // one M3 block's dynamic shared memory

#include "chain.cu"

static const char* last_error = "";

extern "C" const char* chain_emu_error() { return last_error; }

static int finish(const char* err) {
  last_error = err ? err : "";
  return err ? 1 : 0;
}

extern "C" int chain_emulate(const int* anc, const int* n_anc, int* chains,
                             int* n_out, int* pre, unsigned char* ovf, int B,
                             int A2, int reverse) {
  return finish(emu::run((B + CHAIN_WARPS - 1) / CHAIN_WARPS,
                         CHAIN_WARPS * 32, reverse != 0, [&] {
                           chain_kernel(anc, n_anc, chains, n_out, pre, ovf,
                                        B, A2);
                         }));
}

extern "C" int m3_emulate(const int* anc, const int* n_anc, int* chains,
                          int* n_out, int* pre, unsigned char* ovf, int B,
                          int A2, int reverse) {
  if ((size_t)m3_smem_bytes(A2) > sizeof(m3_smem))
    return finish("shared memory too large");
  std::memset(m3_smem, 0xA5, sizeof(m3_smem));   // starts undefined
  return finish(emu::run(B, 32, reverse != 0, [&] {
    m3_kernel(anc, n_anc, chains, n_out, pre, ovf, A2);
  }));
}
