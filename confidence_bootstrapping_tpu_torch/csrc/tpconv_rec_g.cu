// kNN TP-conv with lmax=2 harmonics: message sums [B, N, Dout].
//
// Replaces ops/pallas/tpconv_g.py:fused_tpconv_rec_g at inference: the
// receptor <- receptor and atom <- atom kNN groups of the all-atom confidence
// model's trunk. The same block design as tpconv_rec.cu (rec_tile in
// tpconv_engine.cuh) compiled for 9 harmonic components: the sender rows and
// float32 positions are read directly from the node table (the TPU kernel's
// one-hot gather matmul and bf16 hi/lo position split have no counterpart),
// sig [B, Fe] is added to the cached edge embedding in the fill, and a
// masked edge (a self-edge, or a sender cropped away) costs nothing and adds
// exactly zero. Bound: the H x W edge-MLP product on the CUDA cores (see
// tpconv_engine.cuh); at the trunk's 84 -> 84 layer the X table of CG
// contributions (S=312 per edge) is the largest shared-memory region.
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_rec_g_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                          const int64_t* __restrict__ nbr,
                                                          const float* __restrict__ emb, const float* __restrict__ sig,
                                                          const uint8_t* __restrict__ mask, TPWeights W, TPTables T,
                                                          Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots s;
  rec_tile<9>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
}

extern "C" int cbt_tpconv_rec_g(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                                const float* sig, const uint8_t* mask, const float* w1, const float* b1,
                                const float* w2, const float* b2, const int* xtab, const float* cg, const int* epi,
                                const int* epi_start, int S, int n_tiles, int Wpad, int B, int N, int K, int Fe,
                                int ns, int H, int Din, int Dout, int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const size_t smem = smem_bytes(make_layout<9>(d, S, RT));
  cudaError_t err = cudaFuncSetAttribute(tpconv_rec_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + RT - 1) / RT, B);
  tpconv_rec_g_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
  return (int)cudaGetLastError();
}
