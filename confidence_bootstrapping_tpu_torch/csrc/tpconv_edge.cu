// Edge-list TP-conv: message sums [M, Dout] or per-edge messages [M, K, Dout]
// of pre-gathered edge lists, with an optional hidden-layer dropout mask.
//
// Replaces ops/pallas/tpconv_g.py:fused_tpconv_nbr_g / fused_tpconv_msgs_g
// (_call_g with dmask), the forward of ops/pallas/tpconv_train.py:
// fused_tpconv_train: every TP-conv of a score-model training step except
// the receptor kNN groups (ligand pairs and bonds, ligand <-> receptor, the
// center and torsion convolutions). Inputs are per edge: the MLP input
// [M, K, F], the sender features [M, K, Din] and the harmonics [M, K, SHD]
// (4 at lmax=1, 9 at lmax=2, 20 for the torsion head's 1x2e + 1x1o + 1x2o +
// 1x3o), a [M, K] mask and, in training, dm [M, K, hd] ({0, 1/keep}, hd = H
// or 1) applied after the ReLU. One block per RT rows (RT*K >= 64 edges when
// K allows): edge_tile in tpconv_engine.cuh compacts the valid edges, runs
// the engine on them and sums each row's messages in slot order, or writes
// each edge's message. Bound: the H x W edge-MLP product on the CUDA cores,
// as for the other engine kernels; the per-edge inputs (~0.5 KB an edge) are
// read once.
#include "tpconv_engine.cuh"

using namespace cbt;

template <int SHD, bool DM>
__global__ void __launch_bounds__(NT) tpconv_edge_kernel(const float* __restrict__ attr, const float* __restrict__ send,
                                                         const float* __restrict__ sh, const uint8_t* __restrict__ mask,
                                                         const float* __restrict__ dm, int hd, TPWeights W, TPTables T,
                                                         Dims d, int M, int K, int RT, int sum_k,
                                                         float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots s;
  edge_tile<SHD, DM>(sm, s, attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out);
}

template <int SHD, bool DM>
static int launch(const float* attr, const float* send, const float* sh, const uint8_t* mask, const float* dm, int hd,
                  const TPWeights& W, const TPTables& T, const Dims& d, int M, int K, int RT, int sum_k, float* out,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(make_layout<SHD>(d, T.S, RT));
  cudaError_t err =
      cudaFuncSetAttribute(tpconv_edge_kernel<SHD, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + RT - 1) / RT);
  tpconv_edge_kernel<SHD, DM><<<grid, NT, smem, stream>>>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out);
  return (int)cudaGetLastError();
}

// dm == nullptr: no dropout. Returns a CUDA error code (0 on success).
extern "C" int cbt_tpconv_edge(const float* attr, const float* send, const float* sh, const uint8_t* mask,
                               const float* dm, int hd, const float* w1, const float* b1, const float* w2,
                               const float* b2, const int* xtab, const float* cg, const int* epi, const int* epi_start,
                               int S, int n_tiles, int Wpad, int M, int K, int F, int H, int Din, int Dout, int Dsh,
                               int RT, int sum_k, float* out, void* stream) {
  const Dims d{F, 0, F, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  cudaStream_t st = (cudaStream_t)stream;
  const bool has_dm = dm != nullptr;
  switch (Dsh) {
    case 4:
      return has_dm ? launch<4, true>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, st)
                    : launch<4, false>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, st);
    case 9:
      return has_dm ? launch<9, true>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, st)
                    : launch<9, false>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, st);
    case 20:
      return has_dm ? launch<20, true>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, st)
                    : launch<20, false>(attr, send, sh, mask, dm, hd, W, T, d, M, K, RT, sum_k, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
