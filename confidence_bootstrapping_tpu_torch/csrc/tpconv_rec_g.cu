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
// exactly zero. The inference kernel runs the H -> W product on the tensor
// cores (3xTF32 wgmma, w2 tiles streamed by bulk copies), the CG
// contributions unrolled to the l = 2 harmonic block (contributions_tc<9>),
// so its bound is that product's tensor-core operations; at the trunk's
// 84 -> 84 layer a block takes 175,296 bytes of dynamic shared memory. A
// layer that stage does not take (H > KMAX, or a layout over the shared
// memory a block may have) runs the float32 stage at TM_WIDE edges a chunk
// (tpconv_rec_g_wide_kernel); the training variant keeps the float32 stage.
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_rec_g_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                          const int64_t* __restrict__ nbr,
                                                          const float* __restrict__ emb, const float* __restrict__ sig,
                                                          const uint8_t* __restrict__ mask, TPWeightsTC W,
                                                          TPTables T, Dims d, int N, int K, int RT,
                                                          float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  __shared__ uint64_t bar[2];
  rec_tile<9, false, true>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, nullptr, 0, bar);
}

// w2hi/w2lo: the TNC-column tiles of pack_weights' split; the tables,
// n_tiles, Wpad and n_epi (epilogue items) are those of TNC-column tiles;
// n_cg: floats in cg.
extern "C" int cbt_tpconv_rec_g(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                                const float* sig, const uint8_t* mask, const float* w1, const float* b1,
                                const float* w2hi, const float* w2lo, const float* b2, const int* xtab,
                                const float* cg, const int* epi, const int* epi_start, int S, int n_tiles, int Wpad,
                                int n_epi, int n_cg, int B, int N, int K, int Fe, int ns, int H, int Din, int Dout,
                                int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad, n_epi, n_cg};
  const TPWeightsTC W{w1, b1, w2hi, w2lo, b2};
  return launch(tpconv_rec_g_kernel, dim3((N + RT - 1) / RT, B), smem_bytes(make_layout_tc<9>(d, T, RT)), stream,
                node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
}

// The float32 build at TM_WIDE edges a chunk, for layers the tensor-core
// stage does not take.
__global__ void __launch_bounds__(NT) tpconv_rec_g_wide_kernel(
    const float* __restrict__ node, const float* __restrict__ pos, const int64_t* __restrict__ nbr,
    const float* __restrict__ emb, const float* __restrict__ sig, const uint8_t* __restrict__ mask, TPWeights W,
    TPTables T, Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<TM_WIDE> s;
  rec_tile<9, false, false, TM_WIDE>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
}

// w2, b2 and the tables of TN-column tiles (pack_weights' float32 fields).
extern "C" int cbt_tpconv_rec_g_wide(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                                     const float* sig, const uint8_t* mask, const float* w1, const float* b1,
                                     const float* w2, const float* b2, const int* xtab, const float* cg,
                                     const int* epi, const int* epi_start, int S, int n_tiles, int Wpad, int B, int N,
                                     int K, int Fe, int ns, int H, int Din, int Dout, int RT, float* out,
                                     void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  return launch(tpconv_rec_g_wide_kernel, dim3((N + RT - 1) / RT, B), smem_bytes(make_layout<9, TM_WIDE>(d, S, RT)),
                stream, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
}

// The training variant: the same block with the hidden-layer dropout mask dm
// [B, N, K, hd] ({0, 1/keep}, hd = H or 1) applied after the ReLU, as
// ops/pallas/tpconv_g.py:fused_tpconv_rec_g applies it for
// ops/pallas/tpconv_train.py:fused_tpconv_rec_train, on the float32 stage.
// A kernel of its own, so the inference kernel above is not built with the
// mask.
__global__ void __launch_bounds__(NT) tpconv_rec_g_dm_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                     const int64_t* __restrict__ nbr, const float* __restrict__ emb,
                                                     const float* __restrict__ sig, const uint8_t* __restrict__ mask,
                                                     const float* __restrict__ dm, int hd, TPWeights W, TPTables T,
                                                     Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  rec_tile<9, true>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, dm, hd);
}

extern "C" int cbt_tpconv_rec_g_dm(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                             const float* sig, const uint8_t* mask, const float* dm, int hd, const float* w1,
                             const float* b1, const float* w2, const float* b2, const int* xtab, const float* cg,
                             const int* epi, const int* epi_start, int S, int n_tiles, int Wpad, int B, int N, int K,
                             int Fe, int ns, int H, int Din, int Dout, int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  return launch(tpconv_rec_g_dm_kernel, dim3((N + RT - 1) / RT, B), smem_bytes(make_layout<9>(d, S, RT)), stream, node,
                pos, nbr, emb, sig, mask, dm, hd, W, T, d, N, K, RT, out);
}

// Static shared memory of this library's kernels of one build: the
// tensor-core stage (tc) or the float32 stage at cm edges a chunk
// (cbt::static_bytes).
extern "C" long long cbt_static_smem_bytes(int tc, int cm) {
  if (tc) return cm == TM ? static_bytes(tpconv_rec_g_kernel) : -1;
  if (cm == TM) return static_bytes(tpconv_rec_g_dm_kernel);
  if (cm == TM_WIDE) return static_bytes(tpconv_rec_g_wide_kernel);
  return -1;
}
