// Hetero-receiver TP-conv with lmax=2 harmonics: message sums [B, L, Dout].
//
// Replaces ops/pallas/tpconv_g.py:fused_tpconv_cross_g: the ligand <-
// receptor and ligand <- receptor-atom groups of the all-atom confidence
// model's trunk. It is the forward half of tpconv_cross_rev.cu (cross_tile in
// tpconv_engine.cuh, with no reverse weights) compiled for 9 harmonic
// components: one block per tile of RT ligand receivers, candidates their
// RT*K sender slots, sender rows and float32 positions read directly from the
// sender table, messages summed onto the tile in slot order (no atomics, a
// deterministic result). The edge embedding already holds the sigma
// embedding. Bound: the H x W edge-MLP product on the CUDA cores (see
// tpconv_engine.cuh).
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_cross_g_kernel(
    const float* __restrict__ recv, const float* __restrict__ rpos, const float* __restrict__ src,
    const float* __restrict__ spos, const int64_t* __restrict__ idx, const float* __restrict__ emb,
    const uint8_t* __restrict__ mask, TPWeights W, TPTables T, Dims d, int L, int N, int K, int RT,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  cross_tile<9>(sm, s, recv, rpos, src, spos, idx, emb, mask, W, W, 0, T, d, L, N, K, RT, out, nullptr);
}

// cm: edges a chunk; this kernel has the TM build only.
extern "C" int cbt_tpconv_cross_g(const float* recv, const float* rpos, const float* src, const float* spos,
                                  const int64_t* idx, const float* emb, const uint8_t* mask, const float* w1,
                                  const float* b1, const float* w2, const float* b2, const int* xtab,
                                  const float* cg, const int* epi, const int* epi_start, int S, int n_tiles,
                                  int Wpad, int B, int L, int N, int K, int Fe, int ns, int H, int Din, int Dout,
                                  int RT, int cm, float* out, void* stream) {
  if (cm != TM) return (int)cudaErrorInvalidValue;
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  return launch(tpconv_cross_g_kernel, dim3((L + RT - 1) / RT, B), smem_bytes(make_layout<9>(d, S, RT)), stream, recv,
                rpos, src, spos, idx, emb, mask, W, T, d, L, N, K, RT, out);
}

// Static shared memory of this library's kernels of one build: the
// tensor-core stage (tc) or the float32 stage at cm edges a chunk
// (cbt::static_bytes).
extern "C" long long cbt_static_smem_bytes(int tc, int cm) {
  if (!tc && cm == TM) return static_bytes(tpconv_cross_g_kernel);
  return -1;
}
