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
// product's tensor-core operations. A layer that stage does not take (H >
// KMAX, or a layout over the shared memory a block may have: the ns=48
// ladder) runs the float32 stage at TM_WIDE edges a chunk
// (tpconv_rec_wide_kernel). The training variant (the dropout mask) runs the
// same tensor-core stage where the layer fits it (tpconv_rec_dm_tc_kernel),
// otherwise the float32 stage at TM edges a chunk or at TM_WIDE where TM does
// not fit. The host picks the build (ops/cuda/tpconv_common.pick_build).
// Bound and design: see tpconv_engine.cuh.
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_rec_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                        const int64_t* __restrict__ nbr,
                                                        const float* __restrict__ emb, const float* __restrict__ sig,
                                                        const uint8_t* __restrict__ mask, TPWeightsTC W, TPTables T,
                                                        Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
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
  return launch(tpconv_rec_kernel, dim3((N + RT - 1) / RT, B), smem, stream, node, pos, nbr, emb, sig, mask, W, T,
                d, N, K, RT, out);
}

// The inference kernel's float32 build at TM_WIDE edges a chunk, for layers
// the tensor-core stage does not take.
__global__ void __launch_bounds__(NT) tpconv_rec_wide_kernel(const float* __restrict__ node,
                                                             const float* __restrict__ pos,
                                                             const int64_t* __restrict__ nbr,
                                                             const float* __restrict__ emb,
                                                             const float* __restrict__ sig,
                                                             const uint8_t* __restrict__ mask, TPWeights W, TPTables T,
                                                             Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<TM_WIDE> s;
  rec_tile<4, false, false, TM_WIDE>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
}

// w2, b2 and the tables of TN-column tiles (pack_weights' float32 fields).
extern "C" int cbt_tpconv_rec_wide(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                                   const float* sig, const uint8_t* mask, const float* w1, const float* b1,
                                   const float* w2, const float* b2, const int* xtab, const float* cg, const int* epi,
                                   const int* epi_start, int S, int n_tiles, int Wpad, int B, int N, int K, int Fe,
                                   int ns, int H, int Din, int Dout, int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const size_t smem = smem_bytes(make_layout<4, TM_WIDE>(d, S, RT));
  return launch(tpconv_rec_wide_kernel, dim3((N + RT - 1) / RT, B), smem, stream, node, pos, nbr, emb, sig, mask, W,
                T, d, N, K, RT, out);
}

// The training variant: the same block with the hidden-layer dropout mask dm
// [B, N, K, hd] ({0, 1/keep}, hd = H or 1) applied after the ReLU, as
// ops/pallas/tpconv_g.py:fused_tpconv_rec_g applies it for
// ops/pallas/tpconv_train.py:fused_tpconv_rec_train. Kernels of their own, so
// the inference kernel above compiles to the code it had before: the
// tensor-core build (tpconv_rec_dm_tc_kernel) and the float32 builds at TM
// and TM_WIDE edges a chunk.
__global__ void __launch_bounds__(NT) tpconv_rec_dm_tc_kernel(
    const float* __restrict__ node, const float* __restrict__ pos, const int64_t* __restrict__ nbr,
    const float* __restrict__ emb, const float* __restrict__ sig, const uint8_t* __restrict__ mask,
    const float* __restrict__ dm, int hd, TPWeightsTC W, TPTables T, Dims d, int N, int K, int RT,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  __shared__ uint64_t bar[2];
  rec_tile<4, true, true>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, dm, hd, bar);
}

// The tensor-core build of the training variant: weights and tables as
// cbt_tpconv_rec's.
extern "C" int cbt_tpconv_rec_dm_tc(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                                    const float* sig, const uint8_t* mask, const float* dm, int hd, const float* w1,
                                    const float* b1, const float* w2hi, const float* w2lo, const float* b2,
                                    const int* xtab, const float* cg, const int* epi, const int* epi_start, int S,
                                    int n_tiles, int Wpad, int n_epi, int n_cg, int B, int N, int K, int Fe, int ns,
                                    int H, int Din, int Dout, int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad, n_epi, n_cg};
  const TPWeightsTC W{w1, b1, w2hi, w2lo, b2};
  const size_t smem = smem_bytes(make_layout_tc<4>(d, T, RT));
  return launch(tpconv_rec_dm_tc_kernel, dim3((N + RT - 1) / RT, B), smem, stream, node, pos, nbr, emb, sig, mask, dm,
                hd, W, T, d, N, K, RT, out);
}

__global__ void __launch_bounds__(NT) tpconv_rec_dm_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                     const int64_t* __restrict__ nbr, const float* __restrict__ emb,
                                                     const float* __restrict__ sig, const uint8_t* __restrict__ mask,
                                                     const float* __restrict__ dm, int hd, TPWeights W, TPTables T,
                                                     Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  rec_tile<4, true>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, dm, hd);
}

__global__ void __launch_bounds__(NT) tpconv_rec_dm_wide_kernel(
    const float* __restrict__ node, const float* __restrict__ pos, const int64_t* __restrict__ nbr,
    const float* __restrict__ emb, const float* __restrict__ sig, const uint8_t* __restrict__ mask,
    const float* __restrict__ dm, int hd, TPWeights W, TPTables T, Dims d, int N, int K, int RT,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<TM_WIDE> s;
  rec_tile<4, true, false, TM_WIDE>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, dm, hd);
}

// The float32 builds; cm: edges a chunk, TM or TM_WIDE.
extern "C" int cbt_tpconv_rec_dm(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                             const float* sig, const uint8_t* mask, const float* dm, int hd, const float* w1,
                             const float* b1, const float* w2, const float* b2, const int* xtab, const float* cg,
                             const int* epi, const int* epi_start, int S, int n_tiles, int Wpad, int B, int N, int K,
                             int Fe, int ns, int H, int Din, int Dout, int RT, int cm, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const dim3 grid((N + RT - 1) / RT, B);
  if (cm == TM_WIDE)
    return launch(tpconv_rec_dm_wide_kernel, grid, smem_bytes(make_layout<4, TM_WIDE>(d, S, RT)), stream, node, pos,
                  nbr, emb, sig, mask, dm, hd, W, T, d, N, K, RT, out);
  return launch(tpconv_rec_dm_kernel, grid, smem_bytes(make_layout<4>(d, S, RT)), stream, node, pos, nbr, emb, sig,
                mask, dm, hd, W, T, d, N, K, RT, out);
}

// Static shared memory of this library's kernels of one build: the
// tensor-core stage (tc) or the float32 stage at cm edges a chunk
// (cbt::static_bytes).
extern "C" long long cbt_static_smem_bytes(int tc, int cm) {
  if (tc) return cm == TM ? static_bytes(tpconv_rec_kernel, tpconv_rec_dm_tc_kernel) : -1;
  if (cm == TM) return static_bytes(tpconv_rec_dm_kernel);
  if (cm == TM_WIDE) return static_bytes(tpconv_rec_wide_kernel, tpconv_rec_dm_wide_kernel);
  return -1;
}
