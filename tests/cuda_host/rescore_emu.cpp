// kernels/rescore.cu compiled as host C++ over warp_emu.h: rescore_emulate
// runs the kernel's grid on the CPU, warp by warp, with the arguments of
// rescore_launch (no stream) and the order in which each warp's lanes run
// between collectives; rescore_sharded_emulate runs the sharded kernel
// with those of rescore_sharded_launch. Returns 0, or 1 with the reason in
// rescore_emu_error.
#include "warp_emu.h"

alignas(16) int smem[232448 / 4];   // one block's dynamic shared memory

#include "rescore.cu"

static const char* last_error = "";

extern "C" const char* rescore_emu_error() { return last_error; }

template <class PT, class Kernel>
static int emulate(const PT& P, int reverse, Kernel kernel) {
  if ((size_t)rescore_smem_bytes(P.A2, P.K) > sizeof(smem)) {
    last_error = "shared memory too large";
    return 1;
  }
  std::memset(smem, 0xA5, sizeof(smem));   // shared memory starts undefined
  const char* err = emu::run((P.B + WARPS - 1) / WARPS, WARPS * 32,
                             reverse != 0, [&] { kernel(P); });
  last_error = err ? err : "";
  return err ? 1 : 0;
}

extern "C" int rescore_emulate(
    const int* scal, const int* chains, const int* anchors, const int* schash,
    const unsigned* codes_pk, const int* rk_vals, const int* rk_pos,
    const unsigned* ref_words, const int* ref_off, const int* ref_len,
    int* chains_out, int* flags, int B, int A2, int nw, int K, int NR,
    int nref, int n_bases, int last_char, int reverse) {
  Params P{scal, chains, anchors, schash, codes_pk, rk_vals, rk_pos,
           ref_words, ref_off, ref_len, chains_out, flags,
           B, A2, nw, K, NR, nref, n_bases, last_char};
  return emulate(P, reverse, rescore_kernel);
}

extern "C" int rescore_sharded_emulate(
    const int* scal, const int* chains, const int* anchors, const int* schash,
    const unsigned* codes_pk, const int* rk_vals, const int* rk_pos,
    const shard::ShardTab<unsigned>* ref_words, const int* ref_off,
    const int* ref_len, int* chains_out, int* flags, int B, int A2, int nw,
    int K, int NR, int nref, int n_bases, int last_char, int reverse) {
  ShardedParams P{scal, chains, anchors, schash, codes_pk, rk_vals, rk_pos,
                  *ref_words, ref_off, ref_len, chains_out, flags,
                  B, A2, nw, K, NR, nref, n_bases, last_char};
  return emulate(P, reverse, rescore_sharded_kernel);
}
