// Hetero-receiver TP-conv with lmax=1 harmonics: message sums [B, L, Dout].
//
// Replaces ops/pallas/tpconv_rec.py:fused_tpconv_cross: the ligand <-
// receptor group of the score model's trunk when the fused two-direction
// kernel (tpconv_cross_rev.cu) does not take the cross list, which the JAX
// package's routing decides by K % 16 (a cross cap pinned off the 16-grid,
// e.g. the evaluator's --cross_cap 100). It is the forward half of
// tpconv_cross_rev.cu (cross_tile in tpconv_engine.cuh, with no reverse
// weights) as a kernel of its own: one block per tile of RT ligand receivers,
// RT = 64 // K (at least 1) so a block's 64-edge chunks are full, candidates
// their RT*K receptor slots, sender rows and float32 positions read directly
// from the receptor table, messages summed onto the tile in slot order (no
// atomics, a deterministic result). A K above 64 runs as several chunks of
// one receiver, the last one partial (K=100: a full chunk and one of 36
// edges). The edge embedding already holds the sigma embedding. Bound: the
// H x W edge-MLP product on the CUDA cores (see tpconv_engine.cuh).
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_cross_kernel(
    const float* __restrict__ recv, const float* __restrict__ rpos, const float* __restrict__ src,
    const float* __restrict__ spos, const int64_t* __restrict__ idx, const float* __restrict__ emb,
    const uint8_t* __restrict__ mask, TPWeights W, TPTables T, Dims d, int L, int N, int K, int RT,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots s;
  cross_tile<4>(sm, s, recv, rpos, src, spos, idx, emb, mask, W, W, 0, T, d, L, N, K, RT, out, nullptr);
}

extern "C" int cbt_tpconv_cross(const float* recv, const float* rpos, const float* src, const float* spos,
                                const int64_t* idx, const float* emb, const uint8_t* mask, const float* w1,
                                const float* b1, const float* w2, const float* b2, const int* xtab, const float* cg,
                                const int* epi, const int* epi_start, int S, int n_tiles, int Wpad, int B, int L,
                                int N, int K, int Fe, int ns, int H, int Din, int Dout, int RT, float* out,
                                void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const size_t smem = smem_bytes(make_layout<4>(d, S, RT));
  cudaError_t err = cudaFuncSetAttribute(tpconv_cross_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + RT - 1) / RT, B);
  tpconv_cross_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(recv, rpos, src, spos, idx, emb, mask, W, T, d, L, N,
                                                                K, RT, out);
  return (int)cudaGetLastError();
}
