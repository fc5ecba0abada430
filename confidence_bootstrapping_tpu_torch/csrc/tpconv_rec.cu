// Receptor <- receptor kNN TP-conv: message sums [B, N, Dout].
//
// Replaces ops/pallas/tpconv_rec.py:fused_tpconv_rec (lmax=1 harmonics). One
// block per tile of RT receivers of one batch element (rec_tile in
// tpconv_engine.cuh); candidates are the RT*K neighbour slots in (receiver,
// k) order. The sender rows and positions are read directly from the node
// table (no one-hot gather, positions stay float32), the per-step sigma
// embedding is added to the cached edge embedding in the fill, and the
// messages of each chunk are summed onto the tile's receivers in slot order.
// The inference kernel runs the H -> W product on the tensor cores (3xTF32
// wgmma, w2 tiles streamed by bulk copies), so its bound is now that
// product's tensor-core operations; the training variant keeps the float32
// stage. Bound and design: see tpconv_engine.cuh.
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_rec_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                        const int64_t* __restrict__ nbr,
                                                        const float* __restrict__ emb, const float* __restrict__ sig,
                                                        const uint8_t* __restrict__ mask, TPWeightsTC W, TPTables T,
                                                        Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots s;
  __shared__ uint64_t bar[2];
  rec_tile<4, false, true>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, nullptr, 0, bar);
}

// w2hi/w2lo: the TNC-column tiles of pack_weights' split; the tables,
// n_tiles, Wpad and n_epi (epilogue items) are those of TNC-column tiles;
// n_cg: floats in cg.
extern "C" int cbt_tpconv_rec(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                              const float* sig, const uint8_t* mask, const float* w1, const float* b1,
                              const float* w2hi, const float* w2lo, const float* b2, const int* xtab, const float* cg,
                              const int* epi, const int* epi_start, int S, int n_tiles, int Wpad, int n_epi, int n_cg,
                              int B, int N, int K, int Fe, int ns, int H, int Din, int Dout, int RT, float* out,
                              void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad, n_epi, n_cg};
  const TPWeightsTC W{w1, b1, w2hi, w2lo, b2};
  const size_t smem = smem_bytes(make_layout_tc<4>(d, T, RT));
  cudaError_t err = cudaFuncSetAttribute(tpconv_rec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + RT - 1) / RT, B);
  tpconv_rec_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
  return (int)cudaGetLastError();
}

// The training variant: the same block with the hidden-layer dropout mask dm
// [B, N, K, hd] ({0, 1/keep}, hd = H or 1) applied after the ReLU, as
// ops/pallas/tpconv_g.py:fused_tpconv_rec_g applies it for
// ops/pallas/tpconv_train.py:fused_tpconv_rec_train. A kernel of its own, so
// the inference kernel above compiles to the code it had before.
__global__ void __launch_bounds__(NT) tpconv_rec_dm_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                     const int64_t* __restrict__ nbr, const float* __restrict__ emb,
                                                     const float* __restrict__ sig, const uint8_t* __restrict__ mask,
                                                     const float* __restrict__ dm, int hd, TPWeights W, TPTables T,
                                                     Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots s;
  rec_tile<4, true>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, dm, hd);
}

extern "C" int cbt_tpconv_rec_dm(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                             const float* sig, const uint8_t* mask, const float* dm, int hd, const float* w1,
                             const float* b1, const float* w2, const float* b2, const int* xtab, const float* cg,
                             const int* epi, const int* epi_start, int S, int n_tiles, int Wpad, int B, int N, int K,
                             int Fe, int ns, int H, int Din, int Dout, int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const size_t smem = smem_bytes(make_layout<4>(d, S, RT));
  cudaError_t err = cudaFuncSetAttribute(tpconv_rec_dm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + RT - 1) / RT, B);
  tpconv_rec_dm_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(node, pos, nbr, emb, sig, mask, dm, hd, W, T, d, N, K, RT,
                                                            out);
  return (int)cudaGetLastError();
}
