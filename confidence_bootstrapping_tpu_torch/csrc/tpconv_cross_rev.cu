// Both directions of the capped cross edge list: ([B, L, Dout], [B, N, Dout]).
//
// Replaces ops/pallas/tpconv_lig.py:fused_tpconv_cross_rev. One block per
// tile of RT ligand atoms; candidates are their RT*K receptor slots. Each
// chunk runs the engine twice on the same edges: ligand <- receptor with the
// forward weights (summed onto the tile's ligand rows in slot order), then,
// when reverse weights are given, receptor <- ligand with the receiver and
// sender swapped and the harmonics negated. The reverse messages land on
// receptor rows that any block may share, so they are added with atomicAdd
// into the zeroed [B, N, Dout] output: the order of those sums varies from
// run to run (at most L terms per receptor row, a few float32 ulps). The TPU
// kernel's transposed one-hot scatter matmul has no counterpart here. Bound
// and design: see tpconv_engine.cuh.
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_cross_rev_kernel(
    const float* __restrict__ lig, const float* __restrict__ lpos, const float* __restrict__ rec,
    const float* __restrict__ rpos, const int64_t* __restrict__ idx, const float* __restrict__ emb,
    const uint8_t* __restrict__ mask, TPWeights Wf, TPWeights Wr, int with_rev, TPTables T, Dims d, int L, int N,
    int K, int RT, float* __restrict__ out_lig, float* __restrict__ out_rec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots s;
  const Layout Ly = make_layout(d, T.S, RT);
  const int b = blockIdx.y, l0 = blockIdx.x * RT;
  const int nrecv = min(RT, L - l0);
  const size_t lrow0 = (size_t)b * L, rrow0 = (size_t)b * N;
  float* outs = sm + Ly.out;
  for (int i = threadIdx.x; i < RT * d.Dout; i += NT) outs[i] = 0.f;
  if (threadIdx.x == 0) s.cursor = 0;
  __syncthreads();
  const uint8_t* mrow = mask + (lrow0 + l0) * K;
  while (true) {
    compact(nrecv * K, [&](int c) { return mrow[c] != 0; }, s);
    if (s.count == 0) break;
    for (int m = threadIdx.x; m < s.count; m += NT) {
      const int c = s.cand[m], r = c / K, l = l0 + r;
      const size_t e = (lrow0 + l) * K + c % K;
      const int64_t j = idx[e];
      s.slot[m] = r;
      s.dst[m] = (int)j;
      s.emb[m] = emb + e * d.Fe;
      s.recv[m] = lig + (lrow0 + l) * d.Din;
      s.send[m] = rec + (rrow0 + j) * d.Din;
      for (int q = 0; q < 3; ++q) s.vec[m][q] = rpos[(rrow0 + j) * 3 + q] - lpos[(lrow0 + l) * 3 + q];
    }
    __syncthreads();
    run_engine(sm, Ly, d, Wf, T, s, s.recv, s.send, nullptr, 1.f);
    reduce_to_tile(sm, Ly, d, s);
    __syncthreads();
    if (with_rev) {
      run_engine(sm, Ly, d, Wr, T, s, s.send, s.recv, nullptr, -1.f);
      const float* msg = sm + Ly.msg;
      for (int i = threadIdx.x; i < s.count * d.Dout; i += NT) {
        const int m = i / d.Dout, o = i % d.Dout;
        atomicAdd(out_rec + (rrow0 + s.dst[m]) * d.Dout + o, msg[m * Ly.ldm + o]);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < nrecv * d.Dout; i += NT) out_lig[(lrow0 + l0) * d.Dout + i] = outs[i];
}

extern "C" int cbt_tpconv_cross_rev(const float* lig, const float* lpos, const float* rec, const float* rpos,
                                    const int64_t* idx, const float* emb, const uint8_t* mask, const float* w1f,
                                    const float* b1f, const float* w2f, const float* b2f, const float* w1r,
                                    const float* b1r, const float* w2r, const float* b2r, int with_rev,
                                    const int* xtab, const float* cg, const int* epi, const int* epi_start, int S,
                                    int n_tiles, int Wpad, int B, int L, int N, int K, int Fe, int ns, int H,
                                    int Din, int Dout, int RT, float* out_lig, float* out_rec, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights Wf{w1f, b1f, w2f, b2f};
  const TPWeights Wr{w1r, b1r, w2r, b2r};
  const size_t smem = smem_bytes(make_layout(d, S, RT));
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
