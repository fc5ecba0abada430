// Hetero-receiver TP-conv on the general route: message sums [B, L, Dout].
//
// Replaces ops/pallas/tpconv_g.py:fused_tpconv_cross_g: the ligand <-
// receptor and ligand <- receptor-atom groups of the all-atom confidence
// model's trunk. It is the forward half of tpconv_cross_rev.cu (cross_tile in
// tpconv_engine.cuh, with no reverse weights) compiled for 9 harmonic
// components: one block per tile of RT ligand receivers, RT = 64 // K (at
// least 1) so a block's 64-edge chunks are full, candidates their RT*K sender
// slots, sender rows and float32 positions read directly from the sender
// table, messages summed onto the tile in slot order (no atomics, a
// deterministic result). The edge embedding already holds the sigma
// embedding. A layer with H <= KMAX = 96 whose layout fits (the confidence
// model's ns=24 trunk, H = 72) runs the H -> W product on the engine's
// tensor-core stage (tpconv_cross_g_tc_kernel: 3xTF32 wgmma, w2 tiles
// streamed by bulk copies, the CG contributions unrolled to the l = 2
// harmonic block, as rec_g's inference kernel); the float32 builds at TM and
// TM_WIDE edges a chunk take the others. Bound: the H x W edge-MLP product,
// on the tensor cores where the stage runs (see tpconv_engine.cuh). As in
// tpconv_rec_g.cu, every kernel is built at SHD=9 and SHD=4 (the general
// route at lmax=1) and the host functions take shd; the tensor-core kernel
// also for input blocks of up to 3 and of up to 5 components (DI, as there).
#include "tpconv_engine.cuh"

using namespace cbt;

template <int SHD>
__global__ void __launch_bounds__(NT) tpconv_cross_g_kernel(
    const float* __restrict__ recv, const float* __restrict__ rpos, const float* __restrict__ src,
    const float* __restrict__ spos, const int64_t* __restrict__ idx, const float* __restrict__ emb,
    const uint8_t* __restrict__ mask, TPWeights W, TPTables T, Dims d, int L, int N, int K, int RT,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  cross_tile<SHD>(sm, s, recv, rpos, src, spos, idx, emb, mask, W, W, 0, T, d, L, N, K, RT, out, nullptr);
}

template <int SHD>
__global__ void __launch_bounds__(NT) tpconv_cross_g_wide_kernel(
    const float* __restrict__ recv, const float* __restrict__ rpos, const float* __restrict__ src,
    const float* __restrict__ spos, const int64_t* __restrict__ idx, const float* __restrict__ emb,
    const uint8_t* __restrict__ mask, TPWeights W, TPTables T, Dims d, int L, int N, int K, int RT,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<TM_WIDE> s;
  cross_tile<SHD, false, TM_WIDE>(sm, s, recv, rpos, src, spos, idx, emb, mask, W, W, 0, T, d, L, N, K, RT, out,
                                nullptr);
}

template <int SHD, int DI = 3>
__global__ void __launch_bounds__(NT) tpconv_cross_g_tc_kernel(
    const float* __restrict__ recv, const float* __restrict__ rpos, const float* __restrict__ src,
    const float* __restrict__ spos, const int64_t* __restrict__ idx, const float* __restrict__ emb,
    const uint8_t* __restrict__ mask, TPWeightsTC W, TPTables T, Dims d, int L, int N, int K, int RT,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  __shared__ uint64_t bar[2];
  cross_tile<SHD, true, TM, DI>(sm, s, recv, rpos, src, spos, idx, emb, mask, W, W, 0, T, d, L, N, K, RT, out, nullptr,
                                bar);
}

// The tensor-core build: w1, b1, w2hi, w2lo, b2 (pack_weights' TNC-column
// tiles); the tables, n_tiles, Wpad and n_epi are those of TNC-column tiles;
// n_cg: floats in cg.
extern "C" int cbt_tpconv_cross_g_tc(const float* recv, const float* rpos, const float* src, const float* spos,
                                     const int64_t* idx, const float* emb, const uint8_t* mask, const float* w1,
                                     const float* b1, const float* w2hi, const float* w2lo, const float* b2,
                                     const int* xtab, const float* cg, const int* epi, const int* epi_start, int S,
                                     int n_tiles, int Wpad, int n_epi, int n_cg, int B, int L, int N, int K, int Fe,
                                     int ns, int H, int Din, int Dout, int RT, int shd, int di, float* out,
                                     void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad, n_epi, n_cg};
  const TPWeightsTC W{w1, b1, w2hi, w2lo, b2};
  const dim3 grid((L + RT - 1) / RT, B);
  auto go = [&](auto kernel, size_t smem) {
    return launch(kernel, grid, smem, stream, recv, rpos, src, spos, idx, emb, mask, W, T, d, L, N, K, RT, out);
  };
  if ((shd != 4 && shd != 9) || (di != 3 && di != 5)) return (int)cudaErrorInvalidValue;
  if (shd == 4)
    return di == 3 ? go(tpconv_cross_g_tc_kernel<4, 3>, smem_bytes(make_layout_tc<4>(d, T, RT)))
                   : go(tpconv_cross_g_tc_kernel<4, 5>, smem_bytes(make_layout_tc<4>(d, T, RT)));
  return di == 3 ? go(tpconv_cross_g_tc_kernel<9, 3>, smem_bytes(make_layout_tc<9>(d, T, RT)))
                 : go(tpconv_cross_g_tc_kernel<9, 5>, smem_bytes(make_layout_tc<9>(d, T, RT)));
}

// The float32 builds; cm: edges a chunk, TM or TM_WIDE.
extern "C" int cbt_tpconv_cross_g(const float* recv, const float* rpos, const float* src, const float* spos,
                                  const int64_t* idx, const float* emb, const uint8_t* mask, const float* w1,
                                  const float* b1, const float* w2, const float* b2, const int* xtab,
                                  const float* cg, const int* epi, const int* epi_start, int S, int n_tiles,
                                  int Wpad, int B, int L, int N, int K, int Fe, int ns, int H, int Din, int Dout,
                                  int RT, int cm, int shd, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const dim3 grid((L + RT - 1) / RT, B);
  if ((shd != 4 && shd != 9) || (cm != TM && cm != TM_WIDE)) return (int)cudaErrorInvalidValue;
  if (cm == TM_WIDE && shd == 4)
    return launch(tpconv_cross_g_wide_kernel<4>, grid, smem_bytes(make_layout<4, TM_WIDE>(d, S, RT)), stream, recv,
                  rpos, src, spos, idx, emb, mask, W, T, d, L, N, K, RT, out);
  if (cm == TM_WIDE)
    return launch(tpconv_cross_g_wide_kernel<9>, grid, smem_bytes(make_layout<9, TM_WIDE>(d, S, RT)), stream, recv,
                  rpos, src, spos, idx, emb, mask, W, T, d, L, N, K, RT, out);
  if (shd == 4)
    return launch(tpconv_cross_g_kernel<4>, grid, smem_bytes(make_layout<4>(d, S, RT)), stream, recv, rpos, src, spos,
                  idx, emb, mask, W, T, d, L, N, K, RT, out);
  return launch(tpconv_cross_g_kernel<9>, grid, smem_bytes(make_layout<9>(d, S, RT)), stream, recv, rpos, src, spos,
                idx, emb, mask, W, T, d, L, N, K, RT, out);
}

// Static shared memory of this library's kernels of one build: the
// tensor-core stage (tc) or the float32 stage at cm edges a chunk
// (cbt::static_bytes).
extern "C" long long cbt_static_smem_bytes(int tc, int cm) {
  if (tc)
    return cm == TM ? static_bytes(tpconv_cross_g_tc_kernel<9, 3>, tpconv_cross_g_tc_kernel<4, 3>,
                                   tpconv_cross_g_tc_kernel<9, 5>, tpconv_cross_g_tc_kernel<4, 5>)
                    : -1;
  if (cm == TM) return static_bytes(tpconv_cross_g_kernel<9>, tpconv_cross_g_kernel<4>);
  if (cm == TM_WIDE) return static_bytes(tpconv_cross_g_wide_kernel<9>, tpconv_cross_g_wide_kernel<4>);
  return -1;
}
