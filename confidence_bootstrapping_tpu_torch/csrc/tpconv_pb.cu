// Ligand <- ligand TP-conv over dense radius pairs plus bond edges: [B, L, Dout].
//
// Replaces ops/pallas/tpconv_lig.py:fused_tpconv_pb. One block per tile of RT
// ligand receivers. Candidates are the tile's RT*L dense pairs (receiver i,
// sender j) followed by all E bond edges, of which a bond is valid here when
// its mask is set and its receiver (src) falls in the tile; so each bond is
// summed by exactly one block, in edge order, with no atomics. Pairs and bonds
// share the edge MLP and run through the same chunks.
//
// The kernel runs the H -> W product on the tensor cores (3xTF32 wgmma, w2
// tiles streamed by bulk copies once per 64-edge chunk), so its bound is that
// product's tensor-core operations. A launch has few edges (about half of a
// pose's L*L pairs are within the radius), and each chunk streams all of w2
// (hi and lo, 2.3 MB at the 100 -> 100 layer) from L2 whether it holds 64
// edges or 5, so the host sizes RT to the card (ops/cuda/tpconv_lig.py:
// pb_rows_per_block): the fewest receivers a block that still put every block
// in one wave, each block then running one or two chunks. A layer the stage
// does not take (H > KMAX, or a layout over the shared memory a block may
// have: the ns=48 ladder) runs the float32 stage at TM_WIDE edges a chunk
// (tpconv_pb_wide_kernel). Bound and design: see tpconv_engine.cuh.
#include "tpconv_engine.cuh"

using namespace cbt;

template <bool TC, int CM>
__device__ void pb_tile(float* sm, EdgeSlots<CM>& s, const float* __restrict__ lig, const float* __restrict__ pos,
                        const float* __restrict__ pair_emb, const uint8_t* __restrict__ pair_mask,
                        const int64_t* __restrict__ bsrc, const int64_t* __restrict__ bdst,
                        const float* __restrict__ bond_emb, const uint8_t* __restrict__ bond_mask,
                        const WeightsOf<TC>& W, const TPTables& T, const Dims& d, int L, int E, int RT,
                        float* __restrict__ out, uint64_t* bar) {
  const auto Ly = engine_layout<4, TC, CM>(d, T, RT);
  uint32_t tiles = 0;
  if constexpr (TC) init_tc(sm, Ly, T, bar);
  const int b = blockIdx.y, i0 = blockIdx.x * RT;
  const int nrecv = min(RT, L - i0);
  const int npair = nrecv * L;
  const size_t row0 = (size_t)b * L, bond0 = (size_t)b * E;
  float* outs = sm + Ly.out;
  for (int i = threadIdx.x; i < RT * d.Dout; i += NT) outs[i] = 0.f;
  if (threadIdx.x == 0) s.cursor = 0;
  __syncthreads();
  auto valid = [&](int c) {
    if (c < npair) return pair_mask[(row0 + i0) * L + c] != 0;
    const size_t e = bond0 + (c - npair);
    const int64_t i = bsrc[e];
    return bond_mask[e] != 0 && i >= i0 && i < i0 + nrecv;
  };
  while (true) {
    compact(npair + E, valid, s);
    if (s.count == 0) break;
    for (int m = threadIdx.x; m < s.count; m += NT) {
      const int c = s.cand[m];
      int64_t i, j;
      if (c < npair) {
        i = i0 + c / L;
        j = c % L;
        s.emb[m] = pair_emb + ((row0 + i) * L + j) * d.Fe;
      } else {
        const size_t e = bond0 + (c - npair);
        i = bsrc[e];
        j = bdst[e];
        s.emb[m] = bond_emb + e * d.Fe;
      }
      s.slot[m] = (int)(i - i0);
      s.recv[m] = lig + (row0 + i) * d.Din;
      s.send[m] = lig + (row0 + j) * d.Din;
      for (int q = 0; q < 3; ++q) s.vec[m][q] = pos[(row0 + j) * 3 + q] - pos[(row0 + i) * 3 + q];
    }
    __syncthreads();
    if constexpr (TC)
      run_engine_tc<4>(sm, Ly, d, W, T, s, s.recv, s.send, nullptr, 1.f, bar, tiles);
    else
      run_engine<4, false, CM>(sm, Ly, d, W, T, s, s.recv, s.send, nullptr, 1.f);
    reduce_to_tile(sm, Ly, d, s);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nrecv * d.Dout; i += NT) out[(row0 + i0) * d.Dout + i] = outs[i];
}

__global__ void __launch_bounds__(NT) tpconv_pb_kernel(const float* __restrict__ lig, const float* __restrict__ pos,
                                                       const float* __restrict__ pair_emb,
                                                       const uint8_t* __restrict__ pair_mask,
                                                       const int64_t* __restrict__ bsrc,
                                                       const int64_t* __restrict__ bdst,
                                                       const float* __restrict__ bond_emb,
                                                       const uint8_t* __restrict__ bond_mask, TPWeightsTC W,
                                                       TPTables T, Dims d, int L, int E, int RT,
                                                       float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<> s;
  __shared__ uint64_t bar[2];
  pb_tile<true, TM>(sm, s, lig, pos, pair_emb, pair_mask, bsrc, bdst, bond_emb, bond_mask, W, T, d, L, E, RT, out,
                    bar);
}

// w2hi/w2lo: the TNC-column tiles of pack_weights' split; the tables,
// n_tiles, Wpad and n_epi (epilogue items) are those of TNC-column tiles;
// n_cg: floats in cg.
extern "C" int cbt_tpconv_pb(const float* lig, const float* pos, const float* pair_emb, const uint8_t* pair_mask,
                             const int64_t* bsrc, const int64_t* bdst, const float* bond_emb,
                             const uint8_t* bond_mask, const float* w1, const float* b1, const float* w2hi,
                             const float* w2lo, const float* b2, const int* xtab, const float* cg, const int* epi,
                             const int* epi_start, int S, int n_tiles, int Wpad, int n_epi, int n_cg, int B, int L,
                             int E, int Fe, int ns, int H, int Din, int Dout, int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad, n_epi, n_cg};
  const TPWeightsTC W{w1, b1, w2hi, w2lo, b2};
  return launch(tpconv_pb_kernel, dim3((L + RT - 1) / RT, B), smem_bytes(make_layout_tc<4>(d, T, RT)), stream, lig,
                pos, pair_emb, pair_mask, bsrc, bdst, bond_emb, bond_mask, W, T, d, L, E, RT, out);
}

// The float32 build at TM_WIDE edges a chunk, for layers the tensor-core
// stage does not take.
__global__ void __launch_bounds__(NT) tpconv_pb_wide_kernel(
    const float* __restrict__ lig, const float* __restrict__ pos, const float* __restrict__ pair_emb,
    const uint8_t* __restrict__ pair_mask, const int64_t* __restrict__ bsrc, const int64_t* __restrict__ bdst,
    const float* __restrict__ bond_emb, const uint8_t* __restrict__ bond_mask, TPWeights W, TPTables T, Dims d, int L,
    int E, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots<TM_WIDE> s;
  pb_tile<false, TM_WIDE>(sm, s, lig, pos, pair_emb, pair_mask, bsrc, bdst, bond_emb, bond_mask, W, T, d, L, E, RT,
                          out, nullptr);
}

// w2, b2 and the tables of TN-column tiles (pack_weights' float32 fields).
extern "C" int cbt_tpconv_pb_wide(const float* lig, const float* pos, const float* pair_emb,
                                  const uint8_t* pair_mask, const int64_t* bsrc, const int64_t* bdst,
                                  const float* bond_emb, const uint8_t* bond_mask, const float* w1, const float* b1,
                                  const float* w2, const float* b2, const int* xtab, const float* cg, const int* epi,
                                  const int* epi_start, int S, int n_tiles, int Wpad, int B, int L, int E, int Fe,
                                  int ns, int H, int Din, int Dout, int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  return launch(tpconv_pb_wide_kernel, dim3((L + RT - 1) / RT, B), smem_bytes(make_layout<4, TM_WIDE>(d, S, RT)),
                stream, lig, pos, pair_emb, pair_mask, bsrc, bdst, bond_emb, bond_mask, W, T, d, L, E, RT, out);
}

// Static shared memory of this library's kernels of one build: the
// tensor-core stage (tc) or the float32 stage at cm edges a chunk
// (cbt::static_bytes).
extern "C" long long cbt_static_smem_bytes(int tc, int cm) {
  if (tc) return cm == TM ? static_bytes(tpconv_pb_kernel) : -1;
  if (cm == TM_WIDE) return static_bytes(tpconv_pb_wide_kernel);
  return -1;
}
