// Edge-list TP-conv: message sums [M, Dout] or per-edge messages [M, K, Dout]
// of pre-gathered edge lists, with an optional hidden-layer dropout mask.
//
// Replaces ops/pallas/tpconv_g.py:fused_tpconv_nbr_g / fused_tpconv_msgs_g
// (_call_g with dmask), the forward of ops/pallas/tpconv_train.py:
// fused_tpconv_train: every TP-conv of a score-model training step except
// the receptor kNN groups (ligand pairs and bonds, ligand <-> receptor, the
// center and torsion convolutions); and ops/pallas/tpconv_v3.py:
// fused_tpconv_nbr / fused_tpconv_msgs at inference (the composed route).
// Inputs are per edge: the MLP input [M, K, F], the sender features
// [M, K, Din] and the harmonics [M, K, SHD] (4 at lmax=1, 9 at lmax=2, 16 at
// sh_lmax=3, 20 for the torsion head's 1x2e + 1x1o + 1x2o + 1x3o), a [M, K]
// mask and, in
// training, dm [M, K, hd] ({0, 1/keep}, hd = H or 1) applied after the ReLU.
// One block per RT rows: edge_tile in tpconv_engine.cuh compacts the valid
// edges, runs the engine on them and sums each row's messages in slot order,
// or writes each edge's message. A layer with H <= KMAX = 96 whose layout
// fits (the score model's ns=32 ladder, its center and torsion convolutions)
// runs the H -> W product on the engine's tensor-core stage
// (tpconv_edge_tc_kernel: 3xTF32 wgmma, w2 tiles streamed by bulk copies);
// the others run the float32 stage at TM edges a chunk, or at TM_WIDE
// (tpconv_edge_wide_kernel) where TM does not fit (the ns=48 ladder's wider
// layers). Bound: the H x W edge-MLP product, on the tensor cores where the
// stage runs; the per-edge inputs (~0.5 KB an edge) are read once.
#include "tpconv_engine.cuh"

using namespace cbt;

template <int SHD, bool DM>
__global__ void __launch_bounds__(NT) tpconv_edge_kernel(const float* __restrict__ attr, const float* __restrict__ send,
                                                         const float* __restrict__ sh, const uint8_t* __restrict__ mask,
                                                         const float* __restrict__ dm, int hd, TPWeights W, TPTables T,
                                                         Dims d, int M, int K, int RT, int sum_k,
                                                         float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  edge_tile<SHD, DM>(sm, s, attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out);
}

template <int SHD, bool DM>
__global__ void __launch_bounds__(NT) tpconv_edge_wide_kernel(
    const float* __restrict__ attr, const float* __restrict__ send, const float* __restrict__ sh,
    const uint8_t* __restrict__ mask, const float* __restrict__ dm, int hd, TPWeights W, TPTables T, Dims d, int M,
    int K, int RT, int sum_k, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<TM_WIDE> s;
  edge_tile<SHD, DM, false, TM_WIDE>(sm, s, attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out);
}

template <int SHD, bool DM>
__global__ void __launch_bounds__(NT) tpconv_edge_tc_kernel(
    const float* __restrict__ attr, const float* __restrict__ send, const float* __restrict__ sh,
    const uint8_t* __restrict__ mask, const float* __restrict__ dm, int hd, TPWeightsTC W, TPTables T, Dims d, int M,
    int K, int RT, int sum_k, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  __shared__ uint64_t bar[2];
  edge_tile<SHD, DM, true>(sm, s, attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, bar);
}

// The same for input blocks of up to 5 components (the second-order ladder's
// l = 2 blocks): a kernel of its own, so that the one above keeps its code.
template <int SHD, bool DM>
__global__ void __launch_bounds__(NT) tpconv_edge_tc5_kernel(
    const float* __restrict__ attr, const float* __restrict__ send, const float* __restrict__ sh,
    const uint8_t* __restrict__ mask, const float* __restrict__ dm, int hd, TPWeightsTC W, TPTables T, Dims d, int M,
    int K, int RT, int sum_k, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  __shared__ uint64_t bar[2];
  edge_tile<SHD, DM, true, TM, 5>(sm, s, attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, bar);
}

template <int SHD, bool DM, int DI>
static int launch_edges_tc(const float* attr, const float* send, const float* sh, const uint8_t* mask,
                           const float* dm, int hd, const TPWeightsTC& W, const TPTables& T, const Dims& d, int M,
                           int K, int RT, int sum_k, float* out, void* stream) {
  const dim3 grid((M + RT - 1) / RT);
  const size_t smem = smem_bytes(make_layout_tc<SHD>(d, T, RT));
  if constexpr (DI == 3)
    return launch(tpconv_edge_tc_kernel<SHD, DM>, grid, smem, stream, attr, send, sh, mask, dm, hd, W, T, d, M, K, RT,
                  sum_k, out);
  else
    return launch(tpconv_edge_tc5_kernel<SHD, DM>, grid, smem, stream, attr, send, sh, mask, dm, hd, W, T, d, M, K,
                  RT, sum_k, out);
}

// The tensor-core instance of a harmonic width, with a dropout mask or none,
// for input blocks of up to DI components.
template <int DI>
static int launch_edges_tc_di(int Dsh, const float* attr, const float* send, const float* sh, const uint8_t* mask,
                              const float* dm, int hd, const TPWeightsTC& W, const TPTables& T, const Dims& d, int M,
                              int K, int RT, int sum_k, float* out, void* stream) {
  const bool has_dm = dm != nullptr;
  switch (Dsh) {
    case 4:
      return has_dm ? launch_edges_tc<4, true, DI>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream)
                    : launch_edges_tc<4, false, DI>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream);
    case 9:
      return has_dm ? launch_edges_tc<9, true, DI>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream)
                    : launch_edges_tc<9, false, DI>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream);
    case 16:
      return has_dm
                 ? launch_edges_tc<16, true, DI>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream)
                 : launch_edges_tc<16, false, DI>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream);
    case 20:
      return has_dm
                 ? launch_edges_tc<20, true, DI>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream)
                 : launch_edges_tc<20, false, DI>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core build: w1, b1, w2hi, w2lo, b2 (pack_weights' TNC-column
// tiles); the tables, n_tiles, Wpad and n_epi are those of TNC-column tiles;
// n_cg: floats in cg; dm == nullptr: no dropout; di: the widest input block,
// 3 or 5 (the second-order ladder's l = 2 blocks; the tensor-core stage's CG
// loop is built for each, so that the l <= 1 layers keep their code).
extern "C" int cbt_tpconv_edge_tc(const float* attr, const float* send, const float* sh, const uint8_t* mask,
                                  const float* dm, int hd, const float* w1, const float* b1, const float* w2hi,
                                  const float* w2lo, const float* b2, const int* xtab, const float* cg,
                                  const int* epi, const int* epi_start, int S, int n_tiles, int Wpad, int n_epi,
                                  int n_cg, int M, int K, int F, int H, int Din, int Dout, int Dsh, int RT, int sum_k,
                                  int di, float* out, void* stream) {
  const Dims d{F, 0, F, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad, n_epi, n_cg};
  const TPWeightsTC W{w1, b1, w2hi, w2lo, b2};
  if (di == 3)
    return launch_edges_tc_di<3>(Dsh, attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream);
  if (di == 5)
    return launch_edges_tc_di<5>(Dsh, attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, stream);
  return (int)cudaErrorInvalidValue;
}

template <int SHD, bool DM>
static int launch_edges(const float* attr, const float* send, const float* sh, const uint8_t* mask, const float* dm,
                        int hd, const TPWeights& W, const TPTables& T, const Dims& d, int M, int K, int RT, int sum_k,
                        int cm, float* out, void* stream) {
  const dim3 grid((M + RT - 1) / RT);
  if (cm == TM_WIDE)
    return launch(tpconv_edge_wide_kernel<SHD, DM>, grid, smem_bytes(make_layout<SHD, TM_WIDE>(d, T.S, RT)), stream,
                  attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out);
  return launch(tpconv_edge_kernel<SHD, DM>, grid, smem_bytes(make_layout<SHD>(d, T.S, RT)), stream, attr, send, sh,
                mask, dm, hd, W, T, d, M, K, RT, sum_k, out);
}

// The float32 builds. dm == nullptr: no dropout; cm: edges a chunk, TM or
// TM_WIDE. Returns a CUDA error code (0 on success).
extern "C" int cbt_tpconv_edge(const float* attr, const float* send, const float* sh, const uint8_t* mask,
                               const float* dm, int hd, const float* w1, const float* b1, const float* w2,
                               const float* b2, const int* xtab, const float* cg, const int* epi, const int* epi_start,
                               int S, int n_tiles, int Wpad, int M, int K, int F, int H, int Din, int Dout, int Dsh,
                               int RT, int sum_k, int cm, float* out, void* stream) {
  const Dims d{F, 0, F, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const bool has_dm = dm != nullptr;
  switch (Dsh) {
    case 4:
      return has_dm ? launch_edges<4, true>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, cm, out, stream)
                    : launch_edges<4, false>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, cm, out, stream);
    case 9:
      return has_dm ? launch_edges<9, true>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, cm, out, stream)
                    : launch_edges<9, false>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, cm, out, stream);
    case 16:
      return has_dm ? launch_edges<16, true>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, cm, out, stream)
                    : launch_edges<16, false>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, cm, out, stream);
    case 20:
      return has_dm ? launch_edges<20, true>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, cm, out, stream)
                    : launch_edges<20, false>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, cm, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Static shared memory of this library's kernels of one build: the
// tensor-core stage (tc) or the float32 stage at cm edges a chunk
// (cbt::static_bytes).
extern "C" long long cbt_static_smem_bytes(int tc, int cm) {
  if (tc)
    return cm == TM ? static_bytes(tpconv_edge_tc_kernel<4, false>, tpconv_edge_tc_kernel<4, true>,
                                   tpconv_edge_tc_kernel<9, false>, tpconv_edge_tc_kernel<9, true>,
                                   tpconv_edge_tc_kernel<20, false>, tpconv_edge_tc_kernel<20, true>,
                                   tpconv_edge_tc_kernel<16, false>, tpconv_edge_tc_kernel<16, true>,
                                   tpconv_edge_tc5_kernel<4, false>, tpconv_edge_tc5_kernel<4, true>,
                                   tpconv_edge_tc5_kernel<9, false>, tpconv_edge_tc5_kernel<9, true>,
                                   tpconv_edge_tc5_kernel<20, false>, tpconv_edge_tc5_kernel<20, true>,
                                   tpconv_edge_tc5_kernel<16, false>, tpconv_edge_tc5_kernel<16, true>)
                    : -1;
  if (cm == TM)
    return static_bytes(tpconv_edge_kernel<4, false>, tpconv_edge_kernel<4, true>, tpconv_edge_kernel<9, false>,
                        tpconv_edge_kernel<9, true>, tpconv_edge_kernel<20, false>, tpconv_edge_kernel<20, true>,
                        tpconv_edge_kernel<16, false>, tpconv_edge_kernel<16, true>);
  if (cm == TM_WIDE)
    return static_bytes(tpconv_edge_wide_kernel<4, false>, tpconv_edge_wide_kernel<4, true>,
                        tpconv_edge_wide_kernel<9, false>, tpconv_edge_wide_kernel<9, true>,
                        tpconv_edge_wide_kernel<20, false>, tpconv_edge_wide_kernel<20, true>,
                        tpconv_edge_wide_kernel<16, false>, tpconv_edge_wide_kernel<16, true>);
  return -1;
}
