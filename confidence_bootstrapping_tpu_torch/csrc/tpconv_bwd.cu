// Edge backward of the TP-conv training ops: per-edge input gradients and
// the edge MLP's weight gradients summed over all edges.
//
// Replaces ops/pallas/tpconv_bwd.py:edge_bwd_pallas, the backward of
// ops/pallas/tpconv_train.py:fused_tpconv_train and fused_tpconv_rec_train.
// Per edge (MLP input z [F], sender x [Din], harmonics sh [Dsh], cotangent
// g [Dout] in the canonical irreps layout, already masked; optional dropout
// mask dm [hd]):
//
//   h     = relu(z @ w1 + b1) * dm                      (forward recompute)
//   X[s]  = sum_ab x[a] sh[b] cg[a, b, c]               (CG contributions)
//   w     = h @ w2c + b2c                               (TP weights)
//   d_w[n = ofs + u*mul + v] = sum_c g[v, c] X[u, c]
//   d_X[u, c] = sum_v g[v, c] w[ofs + u*mul + v]
//   d_x, d_sh from d_X through the CG tensors
//   dh    = (d_w @ w2c^T) * dm * (h > 0);  d_z = dh @ w1^T
//
// w2c is w2 in its canonical (u-major) column order with 1/sqrt(fan) folded
// in, zero-padded to a multiple of BN columns: in that order the v of one
// (group, u) are contiguous, so d_X sums over a column segment, the way the
// forward's epilogue sums over u.
//
// The TPU kernel carries dW1/db1/dW2/db2 across its sequential grid in VMEM.
// Blocks here run in no order and dW2 (H x W, up to 96 x 1664 floats) does not
// fit a block's shared memory, so the weight gradients are a second pass:
// tpconv_bwd_edge_kernel writes h [T, H], dh [T, H] and d_w [T, Wpad] to
// scratch, then tn_reduce_kernel computes [A | 1]^T B in 64 x 64 tiles over
// slices of T (dW2, db2 from h and d_w; dW1, db1 from z and dh) and
// sum_splits_kernel adds the slices in a fixed order: deterministic, no
// atomics. Bound: the three H x W products per edge (recompute w, dh, the
// reduction) on the CUDA cores, about 1 MFLOP an edge at H=96, W=1664, and
// the d_w scratch (8 * Wpad bytes an edge, written and read once).
//
// Two builds of the per-edge kernel: BT = 32 edges a block with dh's register
// tile for H <= 16 * 8 = 128 (tpconv_bwd_edge_kernel), and BT = 16 with room
// for H <= 16 * 12 = 192 (tpconv_bwd_edge_wide_kernel) for wider layers and
// for layouts that do not fit a block's shared memory at 32 edges (the ns=48
// ladder: 248,320 bytes at 156 -> 156, 143,168 at 16 edges). The host picks
// one (ops/cuda/tpconv_bwd.py: bwd_build).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;     // w2c columns per tile (ops/cuda/tpconv_common.py: TN)
constexpr int NTB = 256;   // threads per block
constexpr int XROW = 8;    // ints per X-table row (as the forward's)
constexpr int BROW = 5;    // ints per backward epilogue item / vector-gradient row
constexpr int RT_T = 32;   // rows of T per reduction step

struct BwdArgs {
  const float* attr;  // [T, F]
  const float* x;     // [T, Din]
  const float* sh;    // [T, Dsh]
  const float* g;     // [T, Dout]
  const float* dm;    // [T, hd] or null
  int hd;
  const float* w1;    // [F, H]
  const float* b1;    // [H]
  const float* w2;    // [H, Wpad] canonical columns, 1/sqrt(fan) folded in
  const float* b2;    // [Wpad]
  const int* xtab;    // [S, XROW]: in_base, di, sh_base, ds, dout, c, cg_off, 0
  const float* cg;
  const int* bcol;    // [Wpad, 3]: x_base, g_base, dout (0 on padding)
  const int* bepi;    // [items, BROW]: col_lo, col_hi, g_base, g_step, x_index
  const int* bepi_start;  // [n_tiles + 1]
  const int* vtab;    // [rows, BROW]: s, vec_base, n, cg_index, cg_stride
  const int* vtab_start;  // [Din + Dsh + 1]
  int T, F, H, Din, Dsh, Dout, S, n_tiles, Wpad;
  float* d_attr;      // [T, F]
  float* d_x;         // [T, Din]
  float* d_sh;        // [T, Dsh]
  float* hbuf;        // [T, H]
  float* dhbuf;       // [T, H]
  float* dwbuf;       // [T, Wpad]
};

struct BLayout {
  int ldz, ldx, ldsh, ldg, ldh, ldX, ldw, ldc, ldd;
  int z, w, cs, dws, dhs, xs, sh, g, h, X, dX, total;
};

__host__ __device__ inline int odd(int x) { return x | 1; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Region A holds z while the hidden layer is built, then the w2c tile and the
// two [BT, BN] tiles, then dh for the MLP backward. BT: edges per block.
__host__ __device__ inline BLayout bwd_layout(int BT, int F, int H, int Din, int Dsh, int Dout, int S) {
  BLayout L;
  L.ldz = odd(F);
  L.ldx = odd(Din);
  L.ldsh = odd(Dsh);
  L.ldg = odd(Dout);
  L.ldh = BT + 1;
  L.ldX = odd(S);
  L.ldw = BN + 1;
  L.ldc = BN + 1;
  L.ldd = odd(H);
  const int zsz = BT * L.ldz, tiles = H * L.ldw + 2 * BT * L.ldc, dsz = BT * L.ldd;
  int o = 0;
  L.z = o;
  L.w = o;
  L.cs = o + H * L.ldw;
  L.dws = L.cs + BT * L.ldc;
  L.dhs = o;
  o += imax(imax(zsz, tiles), dsz);
  L.xs = o;
  o += BT * L.ldx;
  L.sh = o;
  o += BT * L.ldsh;
  L.g = o;
  o += BT * L.ldg;
  L.h = o;
  o += H * L.ldh;
  L.X = o;
  o += BT * L.ldX;
  L.dX = o;
  o += BT * L.ldX;
  L.total = o;
  return L;
}

// The per-edge backward of BT edges a block; each thread holds BT/16 rows
// and HJ columns of dh (H <= 16 * HJ).
template <int BT, int HJ>
__device__ __forceinline__ void bwd_edges(float* sm, BwdArgs a) {
  constexpr int RB = BT / 16;
  static_assert(RB == 1 || RB == 2, "16 or 32 edges a block");
  const BLayout L = bwd_layout(BT, a.F, a.H, a.Din, a.Dsh, a.Dout, a.S);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t t0 = (size_t)blockIdx.x * BT;
  const int nrow = (int)min((size_t)BT, (size_t)a.T - t0);
  float *z = sm + L.z, *xs = sm + L.xs, *sh = sm + L.sh, *gs = sm + L.g, *h = sm + L.h;
  float *X = sm + L.X, *dX = sm + L.dX, *ws = sm + L.w, *cs = sm + L.cs, *dws = sm + L.dws, *dhs = sm + L.dhs;
  const int ks = a.hd > 1 ? 1 : 0;

  // 1. the block's edges
  for (int i = tid; i < BT * a.F; i += NTB) {
    const int m = i / a.F, f = i % a.F;
    z[m * L.ldz + f] = m < nrow ? a.attr[(t0 + m) * a.F + f] : 0.f;
  }
  for (int i = tid; i < BT * a.Din; i += NTB) {
    const int m = i / a.Din, q = i % a.Din;
    xs[m * L.ldx + q] = m < nrow ? a.x[(t0 + m) * a.Din + q] : 0.f;
  }
  for (int i = tid; i < BT * a.Dsh; i += NTB) {
    const int m = i / a.Dsh, q = i % a.Dsh;
    sh[m * L.ldsh + q] = m < nrow ? a.sh[(t0 + m) * a.Dsh + q] : 0.f;
  }
  for (int i = tid; i < BT * a.Dout; i += NTB) {
    const int m = i / a.Dout, q = i % a.Dout;
    gs[m * L.ldg + q] = m < nrow ? a.g[(t0 + m) * a.Dout + q] : 0.f;
  }
  __syncthreads();

  // 2. hidden layer (recomputed) and the CG contributions
  for (int i = tid; i < BT * a.H; i += NTB) {
    const int m = i % BT, k = i / BT;
    const float* zr = z + m * L.ldz;
    float acc = a.b1[k];
    for (int f = 0; f < a.F; ++f) acc = fmaf(zr[f], a.w1[f * a.H + k], acc);
    float v = fmaxf(acc, 0.f);
    if (a.dm != nullptr && m < nrow) v *= a.dm[(t0 + m) * a.hd + k * ks];
    h[k * L.ldh + m] = v;
  }
  for (int i = tid; i < BT * a.S; i += NTB) {
    const int m = i % BT, e = i / BT;
    const int* r = a.xtab + e * XROW;
    const int di = r[1], ds = r[3], dout = r[4];
    const float* xv = xs + m * L.ldx + r[0];
    const float* sv = sh + m * L.ldsh + r[2];
    const float* c = a.cg + r[6] + r[5];
    float acc = 0.f;
    for (int p = 0; p < di; ++p)
      for (int q = 0; q < ds; ++q) acc = fmaf(xv[p] * sv[q], c[(p * ds + q) * dout], acc);
    X[m * L.ldX + e] = acc;
    dX[m * L.ldX + e] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < nrow * a.H; i += NTB) {
    const int m = i / a.H, k = i % a.H;
    a.hbuf[(t0 + m) * a.H + k] = h[k * L.ldh + m];
  }

  // 3. per column tile: w, d_w (to scratch), d_X and dh
  float dh[RB][HJ];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < HJ; ++j) dh[i][j] = 0.f;
  for (int t = 0; t < a.n_tiles; ++t) {
    const int c0 = t * BN;
    for (int i = tid; i < a.H * BN; i += NTB) {
      const int k = i / BN, n = i % BN;
      ws[k * L.ldw + n] = a.w2[(size_t)k * a.Wpad + c0 + n];
    }
    __syncthreads();
    {
      float acc[RB][4];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < a.H; ++k) {
        const float h0 = h[k * L.ldh + ty * RB], h1 = h[k * L.ldh + ty * RB + 1];  // h1: the second row at RB=2
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wv = ws[k * L.ldw + tx + 16 * j];
          acc[0][j] = fmaf(h0, wv, acc[0][j]);
          if constexpr (RB == 2) acc[1][j] = fmaf(h1, wv, acc[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[(ty * RB + i) * L.ldc + tx + 16 * j] = acc[i][j] + a.b2[c0 + tx + 16 * j];
    }
    for (int i = tid; i < BT * BN; i += NTB) {
      const int m = i / BN, n = i % BN;
      const int* r = a.bcol + (c0 + n) * 3;
      const float* gr = gs + m * L.ldg + r[1];
      const float* xr = X + m * L.ldX + r[0];
      float v = 0.f;
      for (int c = 0; c < r[2]; ++c) v = fmaf(gr[c], xr[c], v);
      dws[m * L.ldc + n] = v;
      if (m < nrow) a.dwbuf[(t0 + m) * a.Wpad + c0 + n] = v;
    }
    __syncthreads();
    const int e0 = a.bepi_start[t], ne = a.bepi_start[t + 1] - e0;
    for (int i = tid; i < ne * BT; i += NTB) {
      const int m = i % BT;
      const int* it = a.bepi + (e0 + i / BT) * BROW;
      const int lo = it[0], hi = it[1], step = it[3];
      const float* cr = cs + m * L.ldc;
      const float* gr = gs + m * L.ldg + it[2];
      float s = 0.f;
      for (int n = lo; n < hi; ++n) s = fmaf(cr[n], gr[(n - lo) * step], s);
      dX[m * L.ldX + it[4]] += s;
    }
    for (int n = 0; n < BN; ++n) {
      const float d0 = dws[(ty * RB) * L.ldc + n], d1 = dws[(ty * RB + 1) * L.ldc + n];  // d1: as h1
#pragma unroll
      for (int j = 0; j < HJ; ++j) {
        const int k = tx + 16 * j;
        if (k < a.H) {
          const float wv = ws[k * L.ldw + n];
          dh[0][j] = fmaf(d0, wv, dh[0][j]);
          if constexpr (RB == 2) dh[1][j] = fmaf(d1, wv, dh[1][j]);
        }
      }
    }
    __syncthreads();
  }

  // 4. sender and harmonic gradients through the CG tensors
  for (int i = tid; i < BT * (a.Din + a.Dsh); i += NTB) {
    const int m = i % BT, o = i / BT;
    if (m >= nrow) continue;
    const float* vec = o < a.Din ? sh + m * L.ldsh : xs + m * L.ldx;
    float acc = 0.f;
    for (int r = a.vtab_start[o]; r < a.vtab_start[o + 1]; ++r) {
      const int* e = a.vtab + r * BROW;
      float s = 0.f;
      for (int q = 0; q < e[2]; ++q) s = fmaf(vec[e[1] + q], a.cg[e[3] + q * e[4]], s);
      acc = fmaf(dX[m * L.ldX + e[0]], s, acc);
    }
    if (o < a.Din)
      a.d_x[(t0 + m) * a.Din + o] = acc;
    else
      a.d_sh[(t0 + m) * a.Dsh + o - a.Din] = acc;
  }

  // 5. MLP backward: dh through the dropout mask and the ReLU, then d_z
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int m = ty * RB + i;
#pragma unroll
    for (int j = 0; j < HJ; ++j) {
      const int k = tx + 16 * j;
      if (k < a.H) {
        float v = 0.f;
        if (m < nrow && h[k * L.ldh + m] > 0.f)
          v = dh[i][j] * (a.dm != nullptr ? a.dm[(t0 + m) * a.hd + k * ks] : 1.f);
        dhs[m * L.ldd + k] = v;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nrow * a.H; i += NTB) {
    const int m = i / a.H, k = i % a.H;
    a.dhbuf[(t0 + m) * a.H + k] = dhs[m * L.ldd + k];
  }
  for (int i = tid; i < nrow * a.F; i += NTB) {
    const int m = i / a.F, f = i % a.F;
    const float* dr = dhs + m * L.ldd;
    const float* wr = a.w1 + f * a.H;
    float acc = 0.f;
    for (int k = 0; k < a.H; ++k) acc = fmaf(dr[k], wr[k], acc);
    a.d_attr[(t0 + m) * a.F + f] = acc;
  }
}

__global__ void __launch_bounds__(NTB) tpconv_bwd_edge_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  bwd_edges<32, 8>(sm, a);
}

__global__ void __launch_bounds__(NTB) tpconv_bwd_edge_wide_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  bwd_edges<16, 12>(sm, a);
}

// part[split][p][q] = sum over the split's rows t of A1[t][p] * B[t][q], where
// A1 = [A | 1] (p < P from A [T, P], p == P the bias row). Grid (ceil(Q/64),
// ceil((P+1)/64), splits); each thread keeps a 4 x 4 tile.
__global__ void __launch_bounds__(NTB) tn_reduce_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                                        int T, int P, int Q, int rows_per_split,
                                                        float* __restrict__ part) {
  __shared__ float As[RT_T][64 + 1];
  __shared__ float Bs[RT_T][64 + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * 64, p0 = blockIdx.y * 64;
  const int ta = blockIdx.z * rows_per_split, tb = min(T, ta + rows_per_split);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t = ta; t < tb; t += RT_T) {
    for (int i = tid; i < RT_T * 64; i += NTB) {
      const int r = i / 64, c = i % 64, row = t + r, p = p0 + c, q = q0 + c;
      const bool in = row < tb;
      As[r][c] = !in ? 0.f : p < P ? A[(size_t)row * P + p] : (p == P ? 1.f : 0.f);
      Bs[r][c] = in && q < Q ? B[(size_t)row * Q + q] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < RT_T; ++r) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * (P + 1) * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + ty * 4 + i, q = q0 + tx + 16 * j;
      if (p <= P && q < Q) out[(size_t)p * Q + q] = acc[i][j];
    }
}

// out[i] = sum_s part[s][i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, int n, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
    out[i] = s;
  }
}

int reduce(const float* A, const float* B, int T, int P, int Q, int splits, float* part, float* out,
           cudaStream_t stream) {
  const int rows = ((T + splits - 1) / splits + RT_T - 1) / RT_T * RT_T;
  const dim3 grid((Q + 63) / 64, (P + 1 + 63) / 64, splits);
  tn_reduce_kernel<<<grid, NTB, 0, stream>>>(A, B, T, P, Q, rows, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (P + 1) * Q;
  sum_splits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, splits, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The whole backward of T edges: the per-edge kernel, then the two weight
// reductions. dw2 [H + 1, Wpad] (row H: db2), dw1 [F + 1, H] (row F: db1),
// in the canonical column order with 1/sqrt(fan) still folded in; part holds
// splits * max((H + 1) * Wpad, (F + 1) * H) floats; bt: edges per block of the
// per-edge kernel, 32 (H <= 128) or 16 (H <= 192). Returns a CUDA error code.
extern "C" int cbt_tpconv_bwd(const float* attr, const float* x, const float* sh, const float* g, const float* dm,
                              int hd, const float* w1, const float* b1, const float* w2, const float* b2,
                              const int* xtab, const float* cg, const int* bcol, const int* bepi,
                              const int* bepi_start, const int* vtab, const int* vtab_start, int T, int F, int H,
                              int Din, int Dsh, int Dout, int S, int n_tiles, int Wpad, float* d_attr, float* d_x,
                              float* d_sh, float* hbuf, float* dhbuf, float* dwbuf, int splits_w2, int splits_w1,
                              float* part, float* dw2, float* dw1, int bt, void* stream) {
  if ((bt != 32 && bt != 16) || H > (bt == 32 ? 128 : 192) || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const BwdArgs a{attr, x, sh, g, dm, hd, w1, b1, w2, b2, xtab, cg, bcol, bepi, bepi_start, vtab, vtab_start,
                  T, F, H, Din, Dsh, Dout, S, n_tiles, Wpad, d_attr, d_x, d_sh, hbuf, dhbuf, dwbuf};
  const size_t smem = (size_t)bwd_layout(bt, F, H, Din, Dsh, Dout, S).total * sizeof(float);
  auto kernel = bt == 32 ? tpconv_bwd_edge_kernel : tpconv_bwd_edge_wide_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(T + bt - 1) / bt, NTB, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int code = reduce(hbuf, dwbuf, T, H, Wpad, splits_w2, part, dw2, st);
  if (code != 0) return code;
  return reduce(attr, dhbuf, T, F, H, splits_w1, part, dw1, st);
}

extern "C" const char* cbt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The per-edge kernel's dynamic shared memory, in bytes, at bt edges a block
// (host mirror: ops/cuda/tpconv_bwd.py: bwd_smem_bytes).
extern "C" long long cbt_bwd_smem_bytes(int bt, int F, int H, int Din, int Dsh, int Dout, int S) {
  return (long long)bwd_layout(bt, F, H, Din, Dsh, Dout, S).total * (long long)sizeof(float);
}
