// Ligand <- ligand TP-conv over dense radius pairs plus bond edges: [B, L, Dout].
//
// Replaces ops/pallas/tpconv_lig.py:fused_tpconv_pb. One block per tile of RT
// ligand receivers. Candidates are the tile's RT*L dense pairs (receiver i,
// sender j) followed by all E bond edges, of which a bond is valid here when
// its mask is set and its receiver (src) falls in the tile; so each bond is
// summed by exactly one block, in edge order, with no atomics. Pairs and bonds
// share the edge MLP and run through the same chunks. Bound and design: see
// tpconv_engine.cuh.
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_pb_kernel(const float* __restrict__ lig, const float* __restrict__ pos,
                                                       const float* __restrict__ pair_emb,
                                                       const uint8_t* __restrict__ pair_mask,
                                                       const int64_t* __restrict__ bsrc,
                                                       const int64_t* __restrict__ bdst,
                                                       const float* __restrict__ bond_emb,
                                                       const uint8_t* __restrict__ bond_mask, TPWeights W,
                                                       TPTables T, Dims d, int L, int E, int RT,
                                                       float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots s;
  const Layout Ly = make_layout<4>(d, T.S, RT);
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
    run_engine<4>(sm, Ly, d, W, T, s, s.recv, s.send, nullptr, 1.f);
    reduce_to_tile(sm, Ly, d, s);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nrecv * d.Dout; i += NT) out[(row0 + i0) * d.Dout + i] = outs[i];
}

extern "C" int cbt_tpconv_pb(const float* lig, const float* pos, const float* pair_emb, const uint8_t* pair_mask,
                             const int64_t* bsrc, const int64_t* bdst, const float* bond_emb,
                             const uint8_t* bond_mask, const float* w1, const float* b1, const float* w2,
                             const float* b2, const int* xtab, const float* cg, const int* epi,
                             const int* epi_start, int S, int n_tiles, int Wpad, int B, int L, int E, int Fe,
                             int ns, int H, int Din, int Dout, int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const size_t smem = smem_bytes(make_layout<4>(d, S, RT));
  cudaError_t err = cudaFuncSetAttribute(tpconv_pb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + RT - 1) / RT, B);
  tpconv_pb_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(lig, pos, pair_emb, pair_mask, bsrc, bdst, bond_emb,
                                                             bond_mask, W, T, d, L, E, RT, out);
  return (int)cudaGetLastError();
}
