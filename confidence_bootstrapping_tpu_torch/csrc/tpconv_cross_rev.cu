// Both directions of the capped cross edge list: ([B, L, Dout], [B, N, Dout]).
//
// Replaces ops/pallas/tpconv_lig.py:fused_tpconv_cross_rev (lmax=1). One
// block per tile of RT ligand atoms (cross_tile in tpconv_engine.cuh);
// candidates are their RT*K receptor slots. Each
// chunk runs the engine twice on the same edges: ligand <- receptor with the
// forward weights (summed onto the tile's ligand rows in slot order), then,
// when reverse weights are given, receptor <- ligand with the receiver and
// sender swapped and the harmonics negated. The reverse messages land on
// receptor rows that any block may share, so they are added with atomicAdd
// into the zeroed [B, N, Dout] output: the order of those sums varies from
// run to run (at most L terms per receptor row, a few float32 ulps). The TPU
// kernel's transposed one-hot scatter matmul has no counterpart here. Both
// directions run the H -> W product on the tensor cores (3xTF32 wgmma, w2
// tiles streamed by bulk copies, once per direction and 64-edge chunk)
// through one call site of the stage, so the kernel's bound is now that
// product's tensor-core operations. Bound and design: see tpconv_engine.cuh.
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_cross_rev_kernel(
    const float* __restrict__ lig, const float* __restrict__ lpos, const float* __restrict__ rec,
    const float* __restrict__ rpos, const int64_t* __restrict__ idx, const float* __restrict__ emb,
    const uint8_t* __restrict__ mask, TPWeightsTC Wf, TPWeightsTC Wr, int with_rev, TPTables T, Dims d, int L,
    int N, int K, int RT, float* __restrict__ out_lig, float* __restrict__ out_rec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots s;
  __shared__ uint64_t bar[2];
  cross_tile<4, true>(sm, s, lig, lpos, rec, rpos, idx, emb, mask, Wf, Wr, with_rev, T, d, L, N, K, RT, out_lig,
                      out_rec, bar);
}

// Each weight set: w1, b1, w2hi, w2lo, b2 (pack_weights' TNC-column tiles);
// the tables, n_tiles, Wpad and n_epi (epilogue items) are those of
// TNC-column tiles; n_cg: floats in cg.
extern "C" int cbt_tpconv_cross_rev(const float* lig, const float* lpos, const float* rec, const float* rpos,
                                    const int64_t* idx, const float* emb, const uint8_t* mask, const float* w1f,
                                    const float* b1f, const float* w2hif, const float* w2lof, const float* b2f,
                                    const float* w1r, const float* b1r, const float* w2hir, const float* w2lor,
                                    const float* b2r, int with_rev,
                                    const int* xtab, const float* cg, const int* epi, const int* epi_start, int S,
                                    int n_tiles, int Wpad, int n_epi, int n_cg, int B, int L, int N, int K, int Fe,
                                    int ns, int H, int Din, int Dout, int RT, float* out_lig, float* out_rec,
                                    void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad, n_epi, n_cg};
  const TPWeightsTC Wf{w1f, b1f, w2hif, w2lof, b2f};
  const TPWeightsTC Wr{w1r, b1r, w2hir, w2lor, b2r};
  const size_t smem = smem_bytes(make_layout_tc<4>(d, T, RT));
  cudaError_t err =
      cudaFuncSetAttribute(tpconv_cross_rev_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (with_rev) {
    err = cudaMemsetAsync(out_rec, 0, (size_t)B * N * Dout * sizeof(float), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((L + RT - 1) / RT, B);
  tpconv_cross_rev_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(lig, lpos, rec, rpos, idx, emb, mask, Wf, Wr,
                                                                    with_rev, T, d, L, N, K, RT, out_lig, out_rec);
  return (int)cudaGetLastError();
}
