// Receptor <- receptor kNN TP-conv: message sums [B, N, Dout].
//
// Replaces ops/pallas/tpconv_rec.py:fused_tpconv_rec. One block per tile of
// RT receivers of one batch element; candidates are the RT*K neighbour slots
// in (receiver, k) order. The sender rows and positions are read directly
// from the node table (no one-hot gather, positions stay float32), the
// per-step sigma embedding is added to the cached edge embedding in the fill,
// and the messages of each chunk are summed onto the tile's receivers in slot
// order. Bound and design: see tpconv_engine.cuh.
#include "tpconv_engine.cuh"

using namespace cbt;

__global__ void __launch_bounds__(NT) tpconv_rec_kernel(const float* __restrict__ node, const float* __restrict__ pos,
                                                        const int64_t* __restrict__ nbr,
                                                        const float* __restrict__ emb, const float* __restrict__ sig,
                                                        const uint8_t* __restrict__ mask, TPWeights W, TPTables T,
                                                        Dims d, int N, int K, int RT, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ EdgeSlots s;
  const Layout L = make_layout(d, T.S, RT);
  const int b = blockIdx.y, i0 = blockIdx.x * RT;
  const int nrecv = min(RT, N - i0);
  const size_t row0 = (size_t)b * N;
  float* outs = sm + L.out;
  for (int i = threadIdx.x; i < RT * d.Dout; i += NT) outs[i] = 0.f;
  if (threadIdx.x == 0) s.cursor = 0;
  __syncthreads();
  const uint8_t* mrow = mask + (row0 + i0) * K;
  while (true) {
    compact(nrecv * K, [&](int c) { return mrow[c] != 0; }, s);
    if (s.count == 0) break;
    for (int m = threadIdx.x; m < s.count; m += NT) {
      const int c = s.cand[m], r = c / K, i = i0 + r;
      const size_t e = (row0 + i) * K + c % K;
      const int64_t j = nbr[e];
      s.slot[m] = r;
      s.emb[m] = emb + e * d.Fe;
      s.recv[m] = node + (row0 + i) * d.Din;
      s.send[m] = node + (row0 + j) * d.Din;
      for (int q = 0; q < 3; ++q) s.vec[m][q] = pos[(row0 + j) * 3 + q] - pos[(row0 + i) * 3 + q];
    }
    __syncthreads();
    run_engine(sm, L, d, W, T, s, s.recv, s.send, sig + (size_t)b * d.Fe, 1.f);
    reduce_to_tile(sm, L, d, s);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nrecv * d.Dout; i += NT) out[(row0 + i0) * d.Dout + i] = outs[i];
}

extern "C" int cbt_tpconv_rec(const float* node, const float* pos, const int64_t* nbr, const float* emb,
                              const float* sig, const uint8_t* mask, const float* w1, const float* b1,
                              const float* w2, const float* b2, const int* xtab, const float* cg, const int* epi,
                              const int* epi_start, int S, int n_tiles, int Wpad, int B, int N, int K, int Fe,
                              int ns, int H, int Din, int Dout, int RT, float* out, void* stream) {
  const Dims d{Fe, ns, Fe + 2 * ns, H, Din, Dout};
  const TPTables T{xtab, cg, epi, epi_start, S, n_tiles, Wpad};
  const TPWeights W{w1, b1, w2, b2};
  const size_t smem = smem_bytes(make_layout(d, S, RT));
  cudaError_t err = cudaFuncSetAttribute(tpconv_rec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + RT - 1) / RT, B);
  tpconv_rec_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(node, pos, nbr, emb, sig, mask, W, T, d, N, K, RT, out);
  return (int)cudaGetLastError();
}
