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
// fit a block's shared memory, so the weight gradients are a second pass: the
// per-edge kernel writes h [T, H], dh [T, H] and d_w [T, Wpad] to scratch,
// then reduce_tc computes [A | 1]^T B on 3xTF32 wgmma over slices of T (dW2,
// db2 from h and d_w; dW1, db1 from z and dh) and sum_splits_kernel adds the
// slices in a fixed order: deterministic, no atomics.
//
// The tensor-core build (second half of this file) takes the layers with
// H <= 96 whose layout fits (the score model's ns=32 ladder): it skips masked
// edges and runs the three H x W products per edge on 3xTF32 wgmma. What
// follows first are the float32 per-edge builds, which run every edge with
// the recompute w = h w2c and dh = d_w w2c^T on the CUDA cores: BT = 32
// edges a block with dh's register tile for H <= 16 * 8 = 128
// (tpconv_bwd_edge_kernel), and BT = 16 with room for H <= 16 * 12 = 192
// (tpconv_bwd_edge_wide_kernel) for wider layers and for layouts that do not
// fit a block's shared memory at 32 edges (the ns=48 ladder: 248,320 bytes
// at 156 -> 156, 143,168 at 16 edges). The host picks one
// (ops/cuda/tpconv_bwd.py: bwd_build); their weight gradients take the same
// reduce_tc as the tensor-core build's, over every edge.
#include "tpconv_engine.cuh"

namespace {

constexpr int BN = 64;     // w2c columns per tile (ops/cuda/tpconv_common.py: TN)
constexpr int NTB = 256;   // threads per block
constexpr int XROW = 8;    // ints per X-table row (as the forward's)
constexpr int BROW = 5;    // ints per backward epilogue item / vector-gradient row

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

// out[i] = sum_s part[s][i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, int n, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
    out[i] = s;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core build (H <= KMAX = 96 and a layout that fits a block)
// ---------------------------------------------------------------------------
//
// The same function over the valid edges only. The host numbers them in order
// (perm: compacted row -> edge, from the running count of the caller's valid
// flags, whose last element is the count: the host never waits for it), zeroes the per-edge outputs, and the
// kernels below touch compacted rows only:
//
//   1. tpconv_bwd_edge_tc_kernel, 64 compacted edges a block: z, the sender
//      features, harmonics and g of its edges; the hidden layer h (dropout
//      mask applied) and the CG contributions X on the CUDA cores; then per
//      TNC-column tile of w2c the recompute w = h w2c + b2c on the engine's
//      tensor-core stage (3xTF32 wgmma, h as hi/lo register fragments, w2c's
//      hi/lo tiles streamed by bulk copies into a two-stage mbarrier ring,
//      every k-step issued with no branch between the wgmmas), d_w of the
//      tile from g and X (bcol) written to scratch, and d_X from w and g
//      (the itemised epilogue bepi, fixed order); last d_x and d_sh through
//      vtab. It writes z, h and d_w of its rows to scratch ([T, F], [T, H],
//      [T, Wpad], compacted rows).
//   2. dh = d_w w2c^T: tn_gemm_tc_kernel<GN, false> over the compacted rows.
//   3. mlp_bwd_kernel: dh through the ReLU and the dropout mask, d_z = dh w1^T
//      scattered to the edges' rows of d_attr, dh kept for step 4.
//   4. The weight gradients [h | 1]^T d_w (dW2, db2) and [z | 1]^T dh (dW1,
//      db1): reduce_tc, tn_gemm_tc_kernel<GN, true> over slices of the
//      compacted rows, then sum_splits_kernel adds the slices in a fixed
//      order (no atomics, the same bits on every run).
//
// tn_gemm_tc_kernel is one 3xTF32 wgmma product C = A B^T over K for strided
// operands: each block stages [128][GK] and [96][GK] chunks of A and B (the
// next chunk's loads in flight while the current one multiplies), splits
// them into hi and lo TF32 parts and stores them into shared memory in the
// K-major core-matrix layout wgmma reads, so the scratch is read in whatever
// order it was written (edge rows for d_w, h and z); each warpgroup
// multiplies 64 rows of the block's 128 x 96 output tile (m64n96k8, both
// operands from shared memory).
// The per-edge kernel writes d_w once per valid edge (4 * Wpad bytes: 6,720 at
// the 74 -> 74 trunk layer); steps 2 and 4 read it once each.
//
// Layers the build does not take (H > 96, or a layout over the shared memory a
// block may have) run the float32 builds above on every edge; the host picks
// (ops/cuda/tpconv_bwd.py: bwd_on_tensor_cores).
namespace {

constexpr int CMT = cbt::TM;  // compacted edges a block of the per-edge kernel
constexpr int GK = 32;        // k a chunk of tn_gemm_tc_kernel
constexpr int GM = 128;       // rows of a tn_gemm_tc_kernel block's output tile: 64 a warpgroup
constexpr int GN = 96;        // its columns: the dh product's H <= KMAX = 96 in one tile
constexpr int TILE_ITEMS = 96;  // d_X epilogue items staged at a time (a tile of the score model's layers has <= 72)

struct BwdArgsTC {
  const float* attr;  // [T, F]
  const float* x;     // [T, Din]
  const float* sh;    // [T, Dsh]
  const float* g;     // [T, Dout]
  const float* dm;    // [T, hd] or null
  int hd;
  const int* perm;    // [T]: compacted row -> edge
  const int* count;   // [1]: valid edges
  cbt::TPWeightsTC W;  // w1, b1; w2hi/w2lo: w2c's TNC-column tiles; b2: b2c, n_tiles * TNC
  const int* xtab;
  const float* cg;
  const int* bcol;        // [Wpad, 3], Wpad = n_tiles * TNC
  const int* bepi;        // items of TNC-column tiles
  const int* bepi_start;  // [n_tiles + 1]
  const int* vtab;
  const int* vtab_start;
  int F, H, Din, Dsh, Dout, S, n_tiles, Wpad;
  int n_cg, n_vtab;  // floats in cg, rows of vtab
  float* d_x;    // [T, Din], zero on masked edges (the host zeroes it)
  float* d_sh;   // [T, Dsh]
  float* zbuf;   // [T, F], compacted rows
  float* hbuf;   // [T, H]
  float* dwbuf;  // [T, Wpad]
};

// Region A holds the transients (z, the sender features, the harmonics, h)
// until h is loaded into registers, then the ring and the w tile, then the
// sender features and harmonics again for d_x and d_sh. The X region holds
// w1 [F, H] while the hidden layer is built, then the edges' dropout mask,
// and vtab, vtab_start and cg for d_x and d_sh; the d_X region holds the X table's rows and cg until the
// contributions are done (L1 is too small beside this much shared memory to
// keep these tables).
struct BLayoutTC {
  int hp, ldz, ldx, ldsh, ldg, ldh, ldX, ldc;
  int c, z, xs, sh, h, X, dX, g, total;
};

__host__ __device__ inline BLayoutTC bwd_layout_tc(int F, int H, int Din, int Dsh, int Dout, int S, int n_cg,
                                                   int n_vtab) {
  BLayoutTC L;
  L.hp = cbt::round8(H);
  L.ldz = odd(F);
  L.ldx = odd(Din);
  L.ldsh = odd(Dsh);
  L.ldg = odd(Dout);
  L.ldh = L.hp + 4;
  L.ldX = odd(S);
  L.ldc = cbt::TNC + 1;
  const int ring = 4 * cbt::TNC * L.hp, csz = cbt::round4(CMT * L.ldc);
  L.c = ring;
  L.z = 0;
  L.xs = cbt::round4(CMT * L.ldz);
  L.sh = L.xs + cbt::round4(CMT * L.ldx);
  L.h = L.sh + cbt::round4(CMT * L.ldsh);
  int o = imax(ring + csz, L.h + cbt::round4(CMT * L.ldh));
  L.X = o;
  o += cbt::round4(imax(imax(CMT * L.ldX, imax(F, CMT) * L.hp), n_vtab * BROW + Din + Dsh + 1 + n_cg));
  L.dX = o;
  o += cbt::round4(imax(CMT * L.ldX, S * XROW + n_cg));
  L.g = o;
  o += cbt::round4(CMT * L.ldg);
  L.total = o;
  return L;
}

// A 4-byte copy from device to shared memory that the thread does not wait
// for (cp.async), so that each thread has many loads in flight: with one
// block an SM, little else hides their latency. copy_wait() completes the
// thread's copies; a __syncthreads() then publishes the block's.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(cbt::smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\n cp.async.wait_group 0;" ::: "memory");
}

// dst[m * ld + q] = src[rows[m] * cols + q] for the block's nrow edges, 0 on the padding rows.
__device__ void gather_rows(float* dst, int ld, const float* src, int cols, const int* rows, int nrow) {
  for (int i = threadIdx.x; i < CMT * cols; i += NTB) {
    const int m = i / cols, q = i % cols;
    if (m < nrow)
      copy4(dst + m * ld + q, src + (size_t)rows[m] * cols + q);
    else
      dst[m * ld + q] = 0.f;
  }
}

__device__ void copy_table(void* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n; i += NTB) copy4(static_cast<int*>(dst) + i, static_cast<const int*>(src) + i);
}

// The sender features and harmonics of the block's edges into shared memory.
__device__ void load_senders(float* xs, float* shs, const BLayoutTC& L, const BwdArgsTC& a, const int* rows,
                             int nrow) {
  gather_rows(xs, L.ldx, a.x, a.Din, rows, nrow);
  gather_rows(shs, L.ldsh, a.sh, a.Dsh, rows, nrow);
}

__global__ void __launch_bounds__(NTB) tpconv_bwd_edge_tc_kernel(BwdArgsTC a) {
  using namespace cbt;
  extern __shared__ __align__(16) float sm[];
  __shared__ int rows[CMT];
  __shared__ uint64_t bar[2];
  __shared__ int bc[TNC * 3];             // the tile's bcol rows
  __shared__ int items[TILE_ITEMS * BROW];  // its d_X epilogue items (L1 keeps little beside this shared memory)
  const int cnt = *a.count, r0 = blockIdx.x * CMT;
  if (r0 >= cnt) return;
  const int nrow = min(CMT, cnt - r0), tid = threadIdx.x;
  const BLayoutTC L = bwd_layout_tc(a.F, a.H, a.Din, a.Dsh, a.Dout, a.S, a.n_cg, a.n_vtab);
  float *z = sm + L.z, *xs = sm + L.xs, *shs = sm + L.sh, *h = sm + L.h;
  float *X = sm + L.X, *dX = sm + L.dX, *gs = sm + L.g;
  const int ks = a.hd > 1 ? 1 : 0;
  if (tid < CMT) rows[tid] = tid < nrow ? a.perm[r0 + tid] : 0;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // 1. the block's edges, w1, the X table's rows and cg
  gather_rows(z, L.ldz, a.attr, a.F, rows, nrow);
  load_senders(xs, shs, L, a, rows, nrow);
  gather_rows(gs, L.ldg, a.g, a.Dout, rows, nrow);
  int* xtab = reinterpret_cast<int*>(dX);
  float* cgs = dX + a.S * XROW;
  copy_table(X, a.W.w1, a.F * a.H);
  copy_table(xtab, a.xtab, a.S * XROW);
  copy_table(cgs, a.cg, a.n_cg);
  copy_wait();
  __syncthreads();
  for (int i = tid; i < nrow * a.F; i += NTB) {  // z to scratch for dW1
    const int m = i / a.F, f = i % a.F;
    a.zbuf[(size_t)(r0 + m) * a.F + f] = z[m * L.ldz + f];
  }

  // 2. hidden layer h [edges][Hp] (the engine's register-tiled hidden_layer_tc
  // from the staged w1, then the dropout mask; zero past H and on the padding
  // rows) and the CG contributions
  {
    LayoutTC lh;
    lh.z = L.z;
    lh.X = L.X;
    lh.h = L.h;
    lh.ldz = L.ldz;
    lh.ldh = L.ldh;
    lh.hp = L.hp;
    const Dims d{0, 0, a.F, a.H, a.Din, a.Dout};
    hidden_layer_tc(sm, lh, d, a.W);
  }
  __syncthreads();  // the dropout mask's rows replace the staged w1
  if (a.dm != nullptr) {
    gather_rows(X, a.hd, a.dm, a.hd, rows, nrow);
    copy_wait();
    __syncthreads();
  }
  for (int i = tid; i < CMT * L.hp; i += NTB) {
    const int m = i / L.hp, k = i % L.hp;
    float& v = h[m * L.ldh + k];
    if (m >= nrow)
      v = 0.f;
    else if (a.dm != nullptr && k < a.H)
      v *= X[m * a.hd + k * ks];
  }
  __syncthreads();  // the contributions overwrite the mask's rows
  for (int i = tid; i < CMT * a.S; i += NTB) {
    const int m = i % CMT, e = i / CMT;
    const int* r = xtab + e * XROW;
    const int di = r[1], ds = r[3], dout = r[4];
    const float* xv = xs + m * L.ldx + r[0];
    const float* sv = shs + m * L.ldsh + r[2];
    const float* c = cgs + r[6] + r[5];
    float acc = 0.f;
    for (int p = 0; p < di; ++p)
      for (int q = 0; q < ds; ++q) acc = fmaf(xv[p] * sv[q], c[(p * ds + q) * dout], acc);
    X[m * L.ldX + e] = acc;
  }
  __syncthreads();  // d_X's region held the X table's rows and cg
  for (int i = tid; i < CMT * L.ldX; i += NTB) dX[i] = 0.f;
#pragma unroll 4
  for (int i = tid; i < nrow * a.H; i += NTB) {
    const int m = i / a.H, k = i % a.H;
    a.hbuf[(size_t)(r0 + m) * a.H + k] = h[m * L.ldh + k];
  }

  // 3. per TNC-column tile: w on the tensor cores, d_w to scratch, d_X
  uint32_t hi[KSTEPS][4], lo[KSTEPS][4];
  load_fragments(h, L.ldh, L.hp, hi, lo);
  fence_proxy_async();  // the ring overwrites the transients
  __syncthreads();
  float* ring = sm;
  float* cs = sm + L.c;
  const int nt = a.n_tiles, stage_sz = 2 * TNC * L.hp;
  if (tid == 0)
    for (int t = 0; t < 2 && t < nt; ++t) load_tile(ring + t * stage_sz, a.W, L.hp, t, bar + t);
  float acc[12];
  mbar_wait(bar, 0);
  mma_tile(acc, hi, lo, ring, L.hp);
  const int lane = tid & 31;
  const int row = ((tid >> 5) & 3) * 16 + (lane >> 2), col = (tid >> 7) * (TNC / 2) + (lane & 3) * 2;
  float b2[6];  // b2 at this thread's accumulator columns of the tile in flight, read while it multiplies
#pragma unroll
  for (int q = 0; q < 6; ++q) b2[q] = a.W.b2[col + (q >> 1) * 8 + (q & 1)];
  for (int t = 0; t < nt; ++t) {
    wgmma_wait_all();
    pin(acc);
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cs[(row + (r >> 1) * 8) * L.ldc + col + j * 8 + (r & 1)] = acc[j * 4 + r] + b2[j * 2 + (r & 1)];
    const int e0 = a.bepi_start[t], ne = a.bepi_start[t + 1] - e0;
    if (tid < TNC * 3) bc[tid] = a.bcol[t * TNC * 3 + tid];
    for (int i = tid; i < min(ne, TILE_ITEMS) * BROW; i += NTB) items[i] = a.bepi[e0 * BROW + i];
    __syncthreads();  // the tile is in cs, its tables staged; both warpgroups are done with stage t
    if (tid == 0 && t + 2 < nt) load_tile(ring + (t & 1) * stage_sz, a.W, L.hp, t + 2, bar + (t & 1));
    if (t + 1 < nt) {
      mbar_wait(bar + ((t + 1) & 1), ((t + 1) >> 1) & 1);
      mma_tile(acc, hi, lo, ring + ((t + 1) & 1) * stage_sz, L.hp);
#pragma unroll
      for (int q = 0; q < 6; ++q) b2[q] = a.W.b2[(t + 1) * TNC + col + (q >> 1) * 8 + (q & 1)];
    }
    // d_w of the tile (the output components of a column: 1 or 3)
#pragma unroll 4
    for (int i = tid; i < nrow * TNC; i += NTB) {
      const int m = i / TNC, n = i % TNC;
      const int* r = bc + n * 3;
      const float* gr = gs + m * L.ldg + r[1];
      const float* xr = X + m * L.ldX + r[0];
      const int nc = r[2];
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < nc) v = fmaf(gr[c], xr[c], v);
      a.dwbuf[(size_t)(r0 + m) * a.Wpad + t * TNC + n] = v;
    }
    // d_X, TILE_ITEMS epilogue items at a time
    for (int done = 0;;) {
      const int here = min(ne - done, TILE_ITEMS);
      for (int i = tid; i < here * CMT; i += NTB) {
        const int m = i % CMT;
        const int* it = items + (i / CMT) * BROW;
        const int lo_n = it[0], hi_n = it[1], step = it[3];
        const float* cr = cs + m * L.ldc;
        const float* gr = gs + m * L.ldg + it[2];
        float s = 0.f;
#pragma unroll 4
        for (int n = lo_n; n < hi_n; ++n) s = fmaf(cr[n], gr[(n - lo_n) * step], s);
        dX[m * L.ldX + it[4]] += s;
      }
      done += here;
      if (done >= ne) break;
      __syncthreads();
      for (int i = tid; i < min(ne - done, TILE_ITEMS) * BROW; i += NTB) items[i] = a.bepi[(e0 + done) * BROW + i];
      __syncthreads();
    }
    __syncthreads();
  }

  // 4. sender and harmonic gradients through the CG tensors, from copies of
  // vtab and cg in the X region
  load_senders(xs, shs, L, a, rows, nrow);
  int* vtab = reinterpret_cast<int*>(X);
  int* vstart = vtab + a.n_vtab * BROW;
  float* vcg = X + a.n_vtab * BROW + a.Din + a.Dsh + 1;
  copy_table(vtab, a.vtab, a.n_vtab * BROW);
  copy_table(vstart, a.vtab_start, a.Din + a.Dsh + 1);
  copy_table(vcg, a.cg, a.n_cg);
  copy_wait();
  __syncthreads();
  for (int i = tid; i < nrow * (a.Din + a.Dsh); i += NTB) {
    const int m = i % nrow, o = i / nrow;
    const float* vec = o < a.Din ? shs + m * L.ldsh : xs + m * L.ldx;
    float s_acc = 0.f;
#pragma unroll 2
    for (int r = vstart[o]; r < vstart[o + 1]; ++r) {
      const int* e = vtab + r * BROW;
      const int n = e[2];
      const float* vv = vec + e[1];
      const float* cc = vcg + e[3];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 7; ++q)  // n <= 7: a harmonic block of l <= 3, or an input block of l <= 1
        if (q < n) s = fmaf(vv[q], cc[q * e[4]], s);
      s_acc = fmaf(dX[m * L.ldX + e[0]], s, s_acc);
    }
    if (o < a.Din)
      a.d_x[(size_t)rows[m] * a.Din + o] = s_acc;
    else
      a.d_sh[(size_t)rows[m] * a.Dsh + o - a.Din] = s_acc;
  }
}

// dh = dh * dm * (h > 0) in place and d_attr[edge] = dh w1^T, for the 64
// compacted rows of a block; w1 staged k-major ([H][F4], F4 = F rounded up to
// 4) so that each thread sums four d_attr columns of a row with float4 reads.
__global__ void __launch_bounds__(NTB) mlp_bwd_kernel(const float* __restrict__ hbuf, float* __restrict__ dhbuf,
                                                      const float* __restrict__ dm, int hd,
                                                      const float* __restrict__ w1, const int* __restrict__ perm,
                                                      const int* __restrict__ count, int F, int H,
                                                      float* __restrict__ d_attr) {
  extern __shared__ __align__(16) float sm[];
  const int cnt = *count, r0 = blockIdx.x * CMT;
  if (r0 >= cnt) return;
  const int nrow = min(CMT, cnt - r0), ldd = odd(H), ks = hd > 1 ? 1 : 0, F4 = (F + 3) & ~3;
  float* w1t = sm;              // [H][F4]
  float* dhs = sm + H * F4;     // [CMT][H | 1]
  for (int i = threadIdx.x; i < H * F4; i += NTB) w1t[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < F * H; i += NTB) w1t[(i % H) * F4 + i / H] = w1[i];
  for (int i = threadIdx.x; i < nrow * H; i += NTB) {
    const int m = i / H, k = i % H;
    const size_t r = (size_t)(r0 + m) * H + k;
    float v = 0.f;
    if (hbuf[r] > 0.f) v = dhbuf[r] * (dm != nullptr ? dm[(size_t)perm[r0 + m] * hd + k * ks] : 1.f);
    dhbuf[r] = v;
    dhs[m * ldd + k] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrow * (F4 / 4); i += NTB) {
    const int m = i / (F4 / 4), f = 4 * (i % (F4 / 4));
    const float* dr = dhs + m * ldd;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < H; ++k) {
      const float d = dr[k];
      const float4 w = *reinterpret_cast<const float4*>(w1t + k * F4 + f);
      acc.x = fmaf(d, w.x, acc.x);
      acc.y = fmaf(d, w.y, acc.y);
      acc.z = fmaf(d, w.z, acc.z);
      acc.w = fmaf(d, w.w, acc.w);
    }
    float* out = d_attr + (size_t)perm[r0 + m] * F + f;
    const float v[4] = {acc.x, acc.y, acc.z, acc.w};
    for (int t = 0; t < 4 && f + t < F; ++t) out[t] = v[t];
  }
}

// A strided operand of tn_gemm_tc_kernel: element (r, k) is p[r * sr + k * sk]
// for r < rows, 1 on row `ones` (the bias row), 0 elsewhere and at k past the
// chunk's end.
struct Operand {
  const float* p;
  int sr, sk, rows, ones;
};

// Element (r, k), k before the chunk's end.
__device__ __forceinline__ float operand_at(const Operand& o, int r, int k) {
  return r < o.rows ? o.p[(size_t)r * o.sr + (size_t)k * o.sk] : (r == o.ones ? 1.f : 0.f);
}

// Offset of element (r, k) of a [R][GK] chunk in the K-major core-matrix
// layout wgmma reads: core matrices of 8 rows x 4 k (16 bytes a row), GK / 4
// of them along k.
__device__ __forceinline__ int core_offset(int r, int k) {
  return ((r >> 3) * (GK / 4) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

// Split x into TF32 hi and lo parts, stored at hi + off and lo + off.
__device__ __forceinline__ void put_split(float* hi, float* lo, int off, float4 x) {
  float4 h, l;
  h.x = __uint_as_float(cbt::tf32_rna(x.x));
  h.y = __uint_as_float(cbt::tf32_rna(x.y));
  h.z = __uint_as_float(cbt::tf32_rna(x.z));
  h.w = __uint_as_float(cbt::tf32_rna(x.w));
  l.x = __uint_as_float(cbt::tf32_rna(x.x - h.x));
  l.y = __uint_as_float(cbt::tf32_rna(x.y - h.y));
  l.z = __uint_as_float(cbt::tf32_rna(x.z - h.z));
  l.w = __uint_as_float(cbt::tf32_rna(x.w - h.w));
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

// One thread's share of a k-contiguous operand's (sk == 1) [R][GK] chunk,
// held in registers from its loads (issued before the previous chunk's
// products) to its stores. A group is four consecutive k of one row (q bits
// 0-2: row & 7, 3-5: k / 4, the rest row / 8: eight rows of 64 contiguous
// bytes a warp, and stores of 16 bytes that hit distinct banks).
template <int R>
struct Chunk {
  static constexpr int NG = R * GK / 4;            // groups a chunk
  static constexpr int G = (NG + NTB - 1) / NTB;  // groups a thread
  float4 v[G];

  __device__ static int row(int q) { return (q & 7) | ((q >> 6) << 3); }
  __device__ static int col(int q) { return ((q >> 3) & 7) * 4; }

  __device__ void load(const Operand& o, int r0, int k0, int k1, bool vec) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int q = threadIdx.x + j * NTB;
      if (q >= NG) break;
      const int r = r0 + row(q), k = k0 + col(q);
      float4& x = v[j];
      if (vec && r < o.rows && k + 3 < k1) {
        x = *reinterpret_cast<const float4*>(o.p + (size_t)r * o.sr + k);
      } else {
        x.x = k < k1 ? operand_at(o, r, k) : 0.f;
        x.y = k + 1 < k1 ? operand_at(o, r, k + 1) : 0.f;
        x.z = k + 2 < k1 ? operand_at(o, r, k + 2) : 0.f;
        x.w = k + 3 < k1 ? operand_at(o, r, k + 3) : 0.f;
      }
    }
  }

  // Split into TF32 hi and lo parts, stored in the core-matrix layout.
  __device__ void store(float* hi, float* lo) const {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int q = threadIdx.x + j * NTB;
      if (q >= NG) break;
      put_split(hi, lo, core_offset(row(q), col(q)), v[j]);
    }
  }
};

// A row-contiguous operand's [R][GK] chunk staged without registers: copied
// raw ([GK][R], k-major as it lies in device memory) by 16-byte cp.async, then
// split into hi and lo parts in the core-matrix layout. The weight products
// stage both operands so, which leaves them registers for two blocks an SM.
template <int R>
struct AsyncRows {
  static constexpr int NG = R * GK / 4;  // 16-byte copies a chunk

  __device__ static void issue(float* raw, const Operand& o, int r0, int k0, int k1, bool vec) {
    for (int q = threadIdx.x; q < NG; q += NTB) {
      const int r = r0 + (q % (R / 4)) * 4, k = q / (R / 4), kk = k0 + k;
      float* dst = raw + k * R + (q % (R / 4)) * 4;
      if (kk < k1 && vec && r + 3 < o.rows) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(cbt::smem_addr(dst)),
                     "l"(o.p + r + (size_t)kk * o.sk)
                     : "memory");
      } else {
        for (int t = 0; t < 4; ++t) dst[t] = kk < k1 ? operand_at(o, r + t, kk) : 0.f;
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  __device__ static void convert(const float* raw, float* hi, float* lo) {
    for (int q = threadIdx.x; q < R * GK / 16; q += NTB) {
      const int r = (q % (R / 4)) * 4, k = (q / (R / 4)) * 4;
      float4 x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = *reinterpret_cast<const float4*>(raw + (k + t) * R + r);
      put_split(hi, lo, core_offset(r, k), make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
      put_split(hi, lo, core_offset(r + 1, k), make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
      put_split(hi, lo, core_offset(r + 2, k), make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
      put_split(hi, lo, core_offset(r + 3, k), make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
    }
  }
};

// acc (+)= A [64 x 8] * B [8 x 96], both from shared memory, TF32 in, float32 sum.
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void pin_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Dynamic shared memory of tn_gemm_tc_kernel at BN columns: hi and lo parts
// of an [GM][GK] chunk of A and a [BN][GK] chunk of B, and with PART two raw
// stages of each (AsyncRows): 112 KB, two blocks an SM.
constexpr size_t gemm_smem_bytes(int BN, bool PART) {
  return (size_t)(2 * (GM + BN) * GK * (PART ? 2 : 1)) * sizeof(float);
}

// C = A B^T over k in [z * k_split, (z + 1) * k_split), bounded by K and by
// *kcount when given; A's rows bounded by *mcount when given (a block past it
// does nothing). Two blocks an SM. Block (x, y, z): C rows GM y.., columns
// BN x..; warpgroup w computes rows 64 w.. with one m64nBNk8 wgmma a k-step.
// The next chunk's loads are in flight while the current chunk multiplies.
// PART (the weight products): A and B row-contiguous, staged by AsyncRows,
// the slice's partial sums to out[z][Mout][Nout]; otherwise (the dh product)
// A and B k-contiguous, staged by Chunk, C to out[Mout][Nout]. 3xTF32:
// A_lo B_hi + A_hi B_lo + A_hi B_hi.
template <int BN, bool PART>
__global__ void __launch_bounds__(NTB, 2) tn_gemm_tc_kernel(Operand A, Operand B, int K, int k_split,
                                                          const int* __restrict__ kcount,
                                                          const int* __restrict__ mcount, float* __restrict__ out,
                                                          int Mout, int Nout) {
  using namespace cbt;
  extern __shared__ __align__(16) float gs[];
  float *ahi = gs, *alo = gs + GM * GK, *bhi = gs + 2 * GM * GK, *blo = bhi + BN * GK;
  float *rawa = blo + BN * GK, *rawb = rawa + 2 * GM * GK;  // PART: two stages of each
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * GM;
  const int k0 = blockIdx.z * k_split;
  int k1 = min(K, k0 + k_split);
  if (kcount != nullptr) k1 = min(k1, *kcount);
  if (mcount != nullptr) {
    const int mc = *mcount;
    if (m0 >= mc) return;
    A.rows = min(A.rows, mc);
  }
  const bool avec = (PART ? (A.sk & 3) : (A.sr & 3)) == 0 && ((uintptr_t)A.p & 15) == 0;
  const bool bvec = (PART ? (B.sk & 3) : (B.sr & 3)) == 0 && ((uintptr_t)B.p & 15) == 0;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  constexpr uint32_t sbo = GK / 4 * 128;  // 8 rows x GK k x 4 bytes
  const uint32_t wg = threadIdx.x >> 7;
  const uint32_t ah = smem_addr(ahi) + wg * 8 * sbo, al = smem_addr(alo) + wg * 8 * sbo;
  const uint32_t bh = smem_addr(bhi), bl = smem_addr(blo);
  Chunk<GM> a;  // the dh product's
  Chunk<BN> b;
  if (k0 < k1) {
    if (PART) {
      AsyncRows<GM>::issue(rawa, A, m0, k0, k1, avec);
      AsyncRows<BN>::issue(rawb, B, n0, k0, k1, bvec);
    } else {
      a.load(A, m0, k0, k1, avec);
      b.load(B, n0, k0, k1, bvec);
    }
  }
  for (int kk = k0, c = 0; kk < k1; kk += GK, ++c) {
    if (PART) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();  // the chunk's raw operands are in
      AsyncRows<GM>::convert(rawa + (c & 1) * GM * GK, ahi, alo);
      AsyncRows<BN>::convert(rawb + (c & 1) * BN * GK, bhi, blo);
    } else {
      a.store(ahi, alo);
      b.store(bhi, blo);
    }
    if (kk + GK < k1) {  // the next chunk's loads, in flight while this one multiplies
      if (PART) {
        AsyncRows<GM>::issue(rawa + ((c + 1) & 1) * GM * GK, A, m0, kk + GK, k1, avec);
        AsyncRows<BN>::issue(rawb + ((c + 1) & 1) * BN * GK, B, n0, kk + GK, k1, bvec);
      } else {
        a.load(A, m0, kk + GK, k1, avec);
        b.load(B, n0, kk + GK, k1, bvec);
      }
    }
    fence_proxy_async();  // the threads' stores, then wgmma's reads
    __syncthreads();
    pin_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < GK / 8; ++st) {
      const uint32_t o = st * 256;
      wgmma_ss(acc, kmajor_desc(al + o, 128, sbo), kmajor_desc(bh + o, 128, sbo));
      wgmma_ss(acc, kmajor_desc(ah + o, 128, sbo), kmajor_desc(bl + o, 128, sbo));
      wgmma_ss(acc, kmajor_desc(ah + o, 128, sbo), kmajor_desc(bh + o, 128, sbo));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin_acc(acc);
    __syncthreads();  // the next chunk overwrites the operands
  }
  const int lane = threadIdx.x & 31;
  const int row = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2), col = n0 + (lane & 3) * 2;
  float* o = PART ? out + (size_t)blockIdx.z * Mout * Nout : out;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = row + (r >> 1) * 8, n = col + j * 8 + (r & 1);
      if (m < Mout && n < Nout) o[(size_t)m * Nout + n] = acc[j * 4 + r];
    }
}

// out [P + 1, Q] = [A | 1]^T B over the rows of A [T, P] and B [T, Q], the
// first *count of them where count is given (the tensor-core build's
// compacted rows), all T otherwise (the float32 builds'): the slices'
// partial sums to part [splits, P + 1, Q], then their sum in slice order.
int reduce_tc(const float* A, const float* B, const int* count, int T, int P, int Q, int splits, float* part,
              float* out, void* stream) {
  const int k_split = ((T + splits - 1) / splits + GK - 1) / GK * GK;
  const Operand a{A, 1, P, P, P}, b{B, 1, Q, Q, -1};
  const dim3 grid((Q + GN - 1) / GN, (P + 1 + GM - 1) / GM, splits);
  int code = cbt::launch(tn_gemm_tc_kernel<GN, true>, grid, gemm_smem_bytes(GN, true), stream, a, b,
                         T, k_split, count, (const int*)nullptr, part, P + 1, Q);
  if (code != 0) return code;
  const int n = (P + 1) * Q;
  sum_splits_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(part, splits, n, out);
  return (int)cudaGetLastError();
}

// w2c = w2 * cscale (canonical columns, 1/sqrt(fan) folded in) padded to
// Wpad columns: the float32 [H, Wpad] matrix the dh product reads, and its hi
// and lo TF32 parts in the layout of ops/cuda/tpconv_common.tile_w2 (tile t,
// 8-column group j, 4-row group q, column r, row e; rows padded to hp); and
// b2c = b2 * cscale padded the same way. One launch where the host would
// take a dozen.
__global__ void pack_w2c_kernel(const float* __restrict__ w2, const float* __restrict__ b2,
                                const float* __restrict__ cscale, int H, int W, int hp, int Wpad,
                                float* __restrict__ w2c, float* __restrict__ w2hi, float* __restrict__ w2lo,
                                float* __restrict__ b2c) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < hp * Wpad; i += gridDim.x * blockDim.x) {
    const int k = i / Wpad, n = i % Wpad;
    const float v = k < H && n < W ? w2[(size_t)k * W + n] * cscale[n] : 0.f;
    if (k < H) w2c[(size_t)k * Wpad + n] = v;
    const float h = __uint_as_float(cbt::tf32_rna(v));
    const size_t off =
        ((((size_t)(n / cbt::TNC) * (cbt::TNC / 8) + (n % cbt::TNC) / 8) * (hp / 4) + k / 4) * 8 + n % 8) * 4 + k % 4;
    w2hi[off] = h;
    w2lo[off] = __uint_as_float(cbt::tf32_rna(v - h));
    if (k == 0) b2c[n] = n < W ? b2[n] * cscale[n] : 0.f;
  }
}

// perm[compacted row] = edge: the valid edges in order, from the inclusive
// count csum of the valid flags.
__global__ void number_edges_kernel(const uint8_t* __restrict__ valid, const int* __restrict__ csum, int T,
                                    int* __restrict__ perm) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T && valid[t]) perm[csum[t] - 1] = t;
}

// The tensor-core build's scratch, carved from one buffer (16-byte aligned parts).
struct Scratch {
  int* perm;  // [T]
  float *zbuf, *hbuf, *dhbuf, *dwbuf, *part, *w2c, *w2hi, *w2lo, *b2c;
  size_t total;  // floats
};

Scratch scratch_layout(float* base, int T, int F, int H, int Wpad, int splits_w2, int splits_w1) {
  const size_t hp = cbt::round8(H);
  const size_t sizes[10] = {(size_t)T, (size_t)T * F, (size_t)T * H, (size_t)T * H, (size_t)T * Wpad,
                            (size_t)splits_w2 * (H + 1) * Wpad + (size_t)splits_w1 * (F + 1) * H, (size_t)H * Wpad,
                            hp * Wpad, hp * Wpad, (size_t)Wpad};
  float* parts[10];
  size_t o = 0;
  for (int i = 0; i < 10; ++i) {
    parts[i] = base == nullptr ? nullptr : base + o;
    o += (sizes[i] + 3) & ~(size_t)3;
  }
  return Scratch{reinterpret_cast<int*>(parts[0]), parts[1], parts[2], parts[3], parts[4], parts[5], parts[6],
                 parts[7], parts[8], parts[9], o};
}

}  // namespace

// The float32 build of the whole backward of T edges: the per-edge kernel,
// then the two weight reductions (reduce_tc over every edge). dw2 [H + 1,
// Wpad] (row H: db2), dw1 [F + 1, H] (row F: db1), in the canonical column
// order with 1/sqrt(fan) still folded in; part holds max(splits_w2 * (H + 1)
// * Wpad, splits_w1 * (F + 1) * H) floats; bt: edges per block of the
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
  const int code = reduce_tc(hbuf, dwbuf, nullptr, T, H, Wpad, splits_w2, part, dw2, stream);
  if (code != 0) return code;
  return reduce_tc(attr, dhbuf, nullptr, T, F, H, splits_w1, part, dw1, stream);
}

// The per-edge kernel's dynamic shared memory, in bytes, at bt edges a block
// (host mirror: ops/cuda/tpconv_bwd.py: bwd_smem_bytes).
extern "C" long long cbt_bwd_smem_bytes(int bt, int F, int H, int Din, int Dsh, int Dout, int S) {
  return (long long)bwd_layout(bt, F, H, Din, Dsh, Dout, S).total * (long long)sizeof(float);
}

// The tensor-core build of the whole backward over the valid edges (see the
// note above). valid: [T] flags of the edges g is not masked on, csum their
// inclusive count (int32; csum[T - 1] is the count of valid edges); w2 [H, W] and
// b2 [W] as the model holds them, canonical columns, cscale [W] 1/sqrt(fan)
// of each; bcol/bepi for TNC-column tiles (Wpad = n_tiles * TNC); n_cg floats
// in cg, n_vtab rows of vtab. scratch: cbt_bwd_tc_scratch_floats floats.
// d_attr [T, F], d_x, d_sh are zeroed here (masked edges keep zero); dw2
// [H + 1, Wpad], dw1 [F + 1, H] as in cbt_tpconv_bwd. Returns a CUDA error
// code.
extern "C" int cbt_tpconv_bwd_tc(const float* attr, const float* x, const float* sh, const float* g,
                                 const float* dm, int hd, const uint8_t* valid, const int* csum, const float* w1,
                                 const float* b1, const float* w2, const float* b2, const float* cscale,
                                 const int* xtab, const float* cg, const int* bcol, const int* bepi,
                                 const int* bepi_start, const int* vtab, const int* vtab_start, int T, int F, int H,
                                 int W, int Din, int Dsh, int Dout, int S, int n_tiles, int Wpad, int n_cg, int n_vtab,
                                 float* d_attr, float* d_x, float* d_sh, float* scratch, int splits_w2, int splits_w1,
                                 float* dw2, float* dw1, void* stream) {
  if (H > cbt::KMAX || T <= 0 || Wpad != n_tiles * cbt::TNC || valid == nullptr || csum == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch sc = scratch_layout(scratch, T, F, H, Wpad, splits_w2, splits_w1);
  const int* count = csum + T - 1;
  cudaError_t err = cudaMemsetAsync(d_attr, 0, (size_t)T * F * sizeof(float), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(d_x, 0, (size_t)T * Din * sizeof(float), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(d_sh, 0, (size_t)T * Dsh * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int hp = cbt::round8(H);
  pack_w2c_kernel<<<(hp * Wpad + NTB - 1) / NTB, NTB, 0, st>>>(w2, b2, cscale, H, W, hp, Wpad, sc.w2c, sc.w2hi,
                                                                sc.w2lo, sc.b2c);
  number_edges_kernel<<<(T + NTB - 1) / NTB, NTB, 0, st>>>(valid, csum, T, sc.perm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const BwdArgsTC a{attr, x, sh, g, dm, hd, sc.perm, count, cbt::TPWeightsTC{w1, b1, sc.w2hi, sc.w2lo, sc.b2c}, xtab,
                    cg, bcol, bepi, bepi_start, vtab, vtab_start, F, H, Din, Dsh, Dout, S, n_tiles, Wpad, n_cg,
                    n_vtab, d_x, d_sh, sc.zbuf, sc.hbuf, sc.dwbuf};
  const int blocks = (T + CMT - 1) / CMT;
  const size_t smem = (size_t)bwd_layout_tc(F, H, Din, Dsh, Dout, S, n_cg, n_vtab).total * sizeof(float);
  int code = cbt::launch(tpconv_bwd_edge_tc_kernel, dim3(blocks), smem, stream, a);
  if (code != 0) return code;
  // dh = d_w w2c^T over the compacted rows
  const Operand dw{sc.dwbuf, Wpad, 1, T, -1}, w2o{sc.w2c, Wpad, 1, H, -1};
  code = cbt::launch(tn_gemm_tc_kernel<GN, false>, dim3(1, (T + GM - 1) / GM, 1),
                     gemm_smem_bytes(GN, false), stream, dw, w2o, Wpad, Wpad, (const int*)nullptr, count, sc.dhbuf, T,
                     H);
  if (code != 0) return code;
  code = cbt::launch(mlp_bwd_kernel, dim3(blocks), (size_t)(H * ((F + 3) & ~3) + CMT * odd(H)) * sizeof(float),
                     stream, (const float*)sc.hbuf, sc.dhbuf, dm, hd, w1, (const int*)sc.perm, count, F, H, d_attr);
  if (code != 0) return code;
  code = reduce_tc(sc.hbuf, sc.dwbuf, count, T, H, Wpad, splits_w2, sc.part, dw2, stream);
  if (code != 0) return code;
  return reduce_tc(sc.zbuf, sc.dhbuf, count, T, F, H, splits_w1, sc.part + (size_t)splits_w2 * (H + 1) * Wpad, dw1,
                   stream);
}

// Floats of cbt_tpconv_bwd_tc's scratch buffer.
extern "C" long long cbt_bwd_tc_scratch_floats(int T, int F, int H, int Wpad, int splits_w2, int splits_w1) {
  return (long long)scratch_layout(nullptr, T, F, H, Wpad, splits_w2, splits_w1).total;
}

// The per-edge tensor-core kernel's dynamic shared memory, in bytes (host
// mirror: ops/cuda/tpconv_bwd.py: bwd_tc_smem_bytes), and its static bytes
// (cudaFuncGetAttributes; host mirror: BWD_TC_STATIC).
extern "C" long long cbt_bwd_tc_smem_bytes(int F, int H, int Din, int Dsh, int Dout, int S, int n_cg, int n_vtab) {
  return (long long)bwd_layout_tc(F, H, Din, Dsh, Dout, S, n_cg, n_vtab).total * (long long)sizeof(float);
}

extern "C" long long cbt_bwd_tc_static_bytes() { return cbt::static_bytes(tpconv_bwd_edge_tc_kernel); }
