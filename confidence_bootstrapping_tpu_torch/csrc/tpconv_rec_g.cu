// kNN TP-conv on the general route: message sums [B, N, Dout].
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
// (tpconv_rec_g_wide_kernel). The training variant (the dropout mask) runs
// the same tensor-core stage where the layer fits it
// (tpconv_rec_g_dm_tc_kernel: the mask is read from device memory, so its
// shared-memory layout is the inference kernel's), otherwise the float32
// stage at TM edges a chunk, or TM_WIDE where TM does not fit
// (tpconv_rec_g_dm_kernel). The host picks the
// build (ops/cuda/tpconv_common.pick_build).
//
// Every kernel is a template over the harmonic width SHD, built at SHD=9
// (lmax=2) and SHD=4 (lmax=1: the general route's layers at lmax=1, such as
// the second-order irreps ladder's, whose l = 2 node blocks the ladder
// kernels do not take); each host function takes shd and launches that
// instance. The tensor-core kernels are also built for input blocks of up to
// 3 and of up to 5 components (DI; 5: the second-order ladder's l = 2 blocks),
// so that the l <= 1 layers keep their code; their host functions take di.
#include "tpconv_engine.cuh"

using namespace cbt;

template <int SHD, int DI = 3>
__global__ void __launch_bounds__(NT) tpconv_rec_g_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                          const int64_t* __restrict__ nbr,
                                                          const float* __restrict__ emb, const float* __restrict__ sig,
                                                          const uint8_t* __restrict__ mask, TPWeightsTC W,
                                                          TPTables T, Dims d, int N, int K, int RT,
                                                          float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  __shared__ uint64_t bar[2];
  rec_tile<SHD, false, true, TM, DI>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, nullptr, 0, bar);
}

// w2hi/w2lo: the TNC-column tiles of pack_weights' split; the tables,
// n_tiles, Wpad and n_epi (epilogue items) are those of TNC-column tiles;
// n_cg: floats in cg; di: the widest input block, 3 or 5 (the tensor-core
// stage's CG loop is built for each).
extern "C" int cbt_tpconv_rec_g(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                                const float* sig, const uint8_t* mask, const float* w1, const float* b1,
                                const float* w2hi, const float* w2lo, const float* b2, const int* xtab,
                                const float* cg, const int* epi, const int* epi_start, int S, int n_tiles, int Wpad,
                                int n_epi, int n_cg, int B, int N, int K, int Fe, int ns, int H, int Din, int Dout,
                                int RT, int shd, int di, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad, n_epi, n_cg};
  const TPWeightsTC W{w1, b1, w2hi, w2lo, b2};
  const dim3 grid((N + RT - 1) / RT, B);
  auto go = [&](auto kernel, size_t smem) {
    return launch(kernel, grid, smem, stream, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
  };
  if ((shd != 4 && shd != 9) || (di != 3 && di != 5)) return (int)cudaErrorInvalidValue;
  if (shd == 4)
    return di == 3 ? go(tpconv_rec_g_kernel<4, 3>, smem_bytes(make_layout_tc<4>(d, T, RT)))
                   : go(tpconv_rec_g_kernel<4, 5>, smem_bytes(make_layout_tc<4>(d, T, RT)));
  return di == 3 ? go(tpconv_rec_g_kernel<9, 3>, smem_bytes(make_layout_tc<9>(d, T, RT)))
                 : go(tpconv_rec_g_kernel<9, 5>, smem_bytes(make_layout_tc<9>(d, T, RT)));
}

// The float32 build at TM_WIDE edges a chunk, for layers the tensor-core
// stage does not take.
template <int SHD>
__global__ void __launch_bounds__(NT) tpconv_rec_g_wide_kernel(
    const float* __restrict__ node, const float* __restrict__ pos, const int64_t* __restrict__ nbr,
    const float* __restrict__ emb, const float* __restrict__ sig, const uint8_t* __restrict__ mask, TPWeights W,
    TPTables T, Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<TM_WIDE> s;
  rec_tile<SHD, false, false, TM_WIDE>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
}

// w2, b2 and the tables of TN-column tiles (pack_weights' float32 fields).
extern "C" int cbt_tpconv_rec_g_wide(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                                     const float* sig, const uint8_t* mask, const float* w1, const float* b1,
                                     const float* w2, const float* b2, const int* xtab, const float* cg,
                                     const int* epi, const int* epi_start, int S, int n_tiles, int Wpad, int B, int N,
                                     int K, int Fe, int ns, int H, int Din, int Dout, int RT, int shd, float* out,
                                     void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const dim3 grid((N + RT - 1) / RT, B);
  if (shd == 4)
    return launch(tpconv_rec_g_wide_kernel<4>, grid, smem_bytes(make_layout<4, TM_WIDE>(d, S, RT)), stream, node, pos,
                  nbr, emb, sig, mask, W, T, d, N, K, RT, out);
  if (shd != 9) return (int)cudaErrorInvalidValue;
  return launch(tpconv_rec_g_wide_kernel<9>, grid, smem_bytes(make_layout<9, TM_WIDE>(d, S, RT)), stream, node, pos,
                nbr, emb, sig, mask, W, T, d, N, K, RT, out);
}

// The training variant: the same block with the hidden-layer dropout mask dm
// [B, N, K, hd] ({0, 1/keep}, hd = H or 1) applied after the ReLU, as
// ops/pallas/tpconv_g.py:fused_tpconv_rec_g applies it for
// ops/pallas/tpconv_train.py:fused_tpconv_rec_train. Kernels of their own, so
// the inference kernel above compiles to the code it had before: the
// tensor-core build (tpconv_rec_g_dm_tc_kernel) and the float32 builds at TM
// and TM_WIDE edges a chunk.
template <int SHD, int DI = 3>
__global__ void __launch_bounds__(NT) tpconv_rec_g_dm_tc_kernel(
    const float* __restrict__ node, const float* __restrict__ pos, const int64_t* __restrict__ nbr,
    const float* __restrict__ emb, const float* __restrict__ sig, const uint8_t* __restrict__ mask,
    const float* __restrict__ dm, int hd, TPWeightsTC W, TPTables T, Dims d, int N, int K, int RT,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  __shared__ uint64_t bar[2];
  rec_tile<SHD, true, true, TM, DI>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, dm, hd, bar);
}

// The tensor-core build of the training variant: weights and tables as
// cbt_tpconv_rec_g's.
extern "C" int cbt_tpconv_rec_g_dm_tc(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                                      const float* sig, const uint8_t* mask, const float* dm, int hd, const float* w1,
                                      const float* b1, const float* w2hi, const float* w2lo, const float* b2,
                                      const int* xtab, const float* cg, const int* epi, const int* epi_start, int S,
                                      int n_tiles, int Wpad, int n_epi, int n_cg, int B, int N, int K, int Fe, int ns,
                                      int H, int Din, int Dout, int RT, int shd, int di, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad, n_epi, n_cg};
  const TPWeightsTC W{w1, b1, w2hi, w2lo, b2};
  const dim3 grid((N + RT - 1) / RT, B);
  auto go = [&](auto kernel, size_t smem) {
    return launch(kernel, grid, smem, stream, node, pos, nbr, emb, sig, mask, dm, hd, W, T, d, N, K, RT, out);
  };
  if ((shd != 4 && shd != 9) || (di != 3 && di != 5)) return (int)cudaErrorInvalidValue;
  if (shd == 4)
    return di == 3 ? go(tpconv_rec_g_dm_tc_kernel<4, 3>, smem_bytes(make_layout_tc<4>(d, T, RT)))
                   : go(tpconv_rec_g_dm_tc_kernel<4, 5>, smem_bytes(make_layout_tc<4>(d, T, RT)));
  return di == 3 ? go(tpconv_rec_g_dm_tc_kernel<9, 3>, smem_bytes(make_layout_tc<9>(d, T, RT)))
                 : go(tpconv_rec_g_dm_tc_kernel<9, 5>, smem_bytes(make_layout_tc<9>(d, T, RT)));
}

template <int SHD, int CM = TM>
__global__ void __launch_bounds__(NT) tpconv_rec_g_dm_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                     const int64_t* __restrict__ nbr, const float* __restrict__ emb,
                                                     const float* __restrict__ sig, const uint8_t* __restrict__ mask,
                                                     const float* __restrict__ dm, int hd, TPWeights W, TPTables T,
                                                     Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<CM> s;
  rec_tile<SHD, true, false, CM>(sm, s, node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out, dm, hd);
}

// The float32 builds of the training variant; cm: edges a chunk, TM or
// TM_WIDE (the second-order ladder's widest layers).
extern "C" int cbt_tpconv_rec_g_dm(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                             const float* sig, const uint8_t* mask, const float* dm, int hd, const float* w1,
                             const float* b1, const float* w2, const float* b2, const int* xtab, const float* cg,
                             const int* epi, const int* epi_start, int S, int n_tiles, int Wpad, int B, int N, int K,
                             int Fe, int ns, int H, int Din, int Dout, int RT, int cm, int shd, float* out,
                             void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const dim3 grid((N + RT - 1) / RT, B);
  if ((shd != 4 && shd != 9) || (cm != TM && cm != TM_WIDE)) return (int)cudaErrorInvalidValue;
  if (cm == TM_WIDE && shd == 4)
    return launch(tpconv_rec_g_dm_kernel<4, TM_WIDE>, grid, smem_bytes(make_layout<4, TM_WIDE>(d, S, RT)), stream,
                  node, pos, nbr, emb, sig, mask, dm, hd, W, T, d, N, K, RT, out);
  if (cm == TM_WIDE)
    return launch(tpconv_rec_g_dm_kernel<9, TM_WIDE>, grid, smem_bytes(make_layout<9, TM_WIDE>(d, S, RT)), stream,
                  node, pos, nbr, emb, sig, mask, dm, hd, W, T, d, N, K, RT, out);
  if (shd == 4)
    return launch(tpconv_rec_g_dm_kernel<4>, grid, smem_bytes(make_layout<4>(d, S, RT)), stream, node, pos, nbr, emb,
                  sig, mask, dm, hd, W, T, d, N, K, RT, out);
  return launch(tpconv_rec_g_dm_kernel<9>, grid, smem_bytes(make_layout<9>(d, S, RT)), stream, node, pos, nbr, emb,
                sig, mask, dm, hd, W, T, d, N, K, RT, out);
}

// Static shared memory of this library's kernels of one build: the
// tensor-core stage (tc) or the float32 stage at cm edges a chunk
// (cbt::static_bytes).
extern "C" long long cbt_static_smem_bytes(int tc, int cm) {
  if (tc)
    return cm == TM ? static_bytes(tpconv_rec_g_kernel<9, 3>, tpconv_rec_g_dm_tc_kernel<9, 3>, tpconv_rec_g_kernel<4, 3>,
                                   tpconv_rec_g_dm_tc_kernel<4, 3>, tpconv_rec_g_kernel<9, 5>,
                                   tpconv_rec_g_dm_tc_kernel<9, 5>, tpconv_rec_g_kernel<4, 5>,
                                   tpconv_rec_g_dm_tc_kernel<4, 5>)
                    : -1;
  if (cm == TM) return static_bytes(tpconv_rec_g_dm_kernel<9>, tpconv_rec_g_dm_kernel<4>);
  if (cm == TM_WIDE)
    return static_bytes(tpconv_rec_g_wide_kernel<9>, tpconv_rec_g_wide_kernel<4>, tpconv_rec_g_dm_kernel<9, TM_WIDE>,
                        tpconv_rec_g_dm_kernel<4, TM_WIDE>);
  return -1;
}
