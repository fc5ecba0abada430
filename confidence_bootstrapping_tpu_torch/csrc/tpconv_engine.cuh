// Shared edge engine of the three TP-conv kernels (float32, sm_90a).
//
// Every TP-conv message on the score model's path is
//   h   = relu([edge_emb | recv[:ns] | send[:ns]] @ w1 + b1)        (F -> H)
//   w   = h @ w2 + b2                                                 (H -> W)
//   msg = WeightedTensorProduct(send, sh1(send_pos - recv_pos), w)
// summed over the edges of each receiver. The Pallas kernels
// (ops/pallas/tpconv_rec.py, tpconv_lig.py) build it from one-hot gather
// matmuls, a CG matrix G and expand/reduce matrices E/R sized for a 128x128
// MXU. Here a block gathers its own edges and runs the product directly:
//
//   1. compact: warp 0 ballots the candidate edges of the block's receivers
//      and keeps the valid ones in order, TM per chunk, so masked edges cost
//      nothing and contribute exactly zero;
//   2. fill: per edge the MLP input z [F], the sender features [Din] and the
//      lmax=1 harmonics (1, sqrt(3) v / |v|, |v|^2 clamped at 1e-12);
//   3. hidden layer h [H, TM] and the CG contributions X [TM, S]
//      (X[e][g][u][c] = sum_ab x[u,a] sh[b] cg[a,b,c] for output group g);
//   4. the H -> W product as a register-tiled float32 GEMM over TN-column
//      tiles of w2 staged in shared memory. The host stores w2 with its
//      columns v-major inside each output group (n = ofs_g + v*fan_g + u) and
//      1/sqrt(fan_g) folded in, so each tile's epilogue sums over u for a few
//      (g, v) segments: msg[e][v,c] += sum_u X[e][g][u][c] * w[e][g,u,v].
//      The epilogue is a fixed list of (segment, component) items per tile,
//      so the sum order is fixed and the result deterministic.
//
// What bounds it on the card: the H x W product, 2*H*W flops per edge
// (about 0.32 MFLOP at H=96, W=1660), at the 67 TFLOP/s float32 rate of the
// CUDA cores; bytes are small beside it (an edge reads ~1 KB). The design
// keeps w2 tiles in shared memory for TM edges at a time and never writes w
// or the per-edge messages to device memory. Tensor cores (wgmma, bf16 or
// TF32) are later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cbt {

constexpr int TM = 64;    // edges per chunk
constexpr int TN = 64;    // w2 columns per GEMM tile (ops/cuda/tpconv_common.py: TN)
constexpr int NT = 256;   // threads per block (16 x 16 GEMM thread grid)
constexpr int XROW = 8;   // ints per X-table row
constexpr int EROW = 5;   // ints per epilogue item

struct TPWeights {
  const float* w1;  // [F, H] row-major
  const float* b1;  // [H]
  const float* w2;  // [H, Wpad], v-major columns per group, 1/sqrt(fan) folded in
  const float* b2;  // [Wpad]
};

struct TPTables {
  const int* xtab;       // [S, XROW]: in_base, di, sh_base, ds, dout, c, cg_off, 0
  const float* cg;       // CG path tensors [di][ds][dout], sqrt(dout) folded in
  const int* epi;        // [items, EROW]: col_lo, col_hi, x_base, x_step, out_col
  const int* epi_start;  // [n_tiles + 1]
  int S, n_tiles, Wpad;
};

struct Dims {
  int Fe, ns, F, H, Din, Dout;
};

// Dynamic shared memory, in floats. Region A holds z and the sender features
// while the hidden layer and X are built, then the w2 tile and the GEMM tile.
struct Layout {
  int ldz, ldx, ldsh, ldxs, ldc, ldm;
  int z, xs, w, c, sh, h, X, msg, out, total;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline Layout make_layout(const Dims& d, int S, int RT) {
  Layout L;
  L.ldz = d.F | 1;  // odd strides: rows of consecutive threads hit distinct banks
  L.ldx = d.Din | 1;
  L.ldsh = 5;
  L.ldxs = S | 1;
  L.ldc = TN + 1;
  L.ldm = d.Dout | 1;
  const int zsz = round4(TM * L.ldz), xssz = round4(TM * L.ldx);
  const int wsz = round4(d.H * TN), csz = round4(TM * L.ldc);
  int o = 0;
  L.z = o;
  L.xs = o + zsz;
  L.w = o;
  L.c = o + wsz;
  o += (zsz + xssz > wsz + csz) ? zsz + xssz : wsz + csz;
  L.sh = o;
  o += round4(TM * L.ldsh);
  L.h = o;
  o += round4(d.H * TM);
  L.X = o;
  o += round4(TM * L.ldxs);
  L.msg = o;
  o += round4(TM * L.ldm);
  L.out = o;
  o += round4(RT * d.Dout);
  L.total = o;
  return L;
}

// Per-chunk edge records, filled by each kernel for the edges compact() kept.
struct EdgeSlots {
  const float* emb[TM];   // edge embedding row [Fe]
  const float* recv[TM];  // receiver feature row (first ns read)
  const float* send[TM];  // sender feature row [Din]
  float vec[TM][3];       // sender position - receiver position
  int slot[TM];           // receiver row inside the block's tile
  int dst[TM];            // cross_rev: receptor row of the edge
  int cand[TM];           // candidate index of each kept edge
  int count, cursor;
};

// Keep the next (up to TM) valid candidates in [cursor, ncand), in order.
template <class Valid>
__device__ void compact(int ncand, Valid valid, EdgeSlots& s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0, cur = s.cursor;
    while (count < TM && cur < ncand) {
      const int c = cur + lane;
      const bool v = c < ncand && valid(c);
      const unsigned ball = __ballot_sync(0xffffffffu, v);
      const int pos = count + __popc(ball & ((1u << lane) - 1u));
      if (v && pos < TM) s.cand[pos] = c;
      const int total = __popc(ball);
      if (count + total <= TM) {
        count += total;
        cur += 32;
      } else {
        const unsigned last = __ballot_sync(0xffffffffu, v && pos == TM - 1);
        cur += __ffs(last);  // one past the lane of the last edge kept
        count = TM;
      }
    }
    if (lane == 0) {
      s.count = count;
      s.cursor = cur;
    }
  }
  __syncthreads();
}

// MLP input, sender features and harmonics of the first `count` slots.
// recv/send may be swapped by the caller (the reversed cross direction);
// sign flips the edge vector with them. sig (nullable) is added to emb.
__device__ void fill_edges(float* sm, const Layout& L, const Dims& d, int count, const float* const* emb,
                           const float* const* recv, const float* const* send, const float (*vec)[3],
                           const float* sig, float sign) {
  float* z = sm + L.z;
  float* xs = sm + L.xs;
  float* sh = sm + L.sh;
  for (int i = threadIdx.x; i < TM * d.F; i += NT) {
    const int m = i / d.F, f = i % d.F;
    float v = 0.f;
    if (m < count) {
      if (f < d.Fe)
        v = emb[m][f] + (sig ? sig[f] : 0.f);
      else if (f < d.Fe + d.ns)
        v = recv[m][f - d.Fe];
      else
        v = send[m][f - d.Fe - d.ns];
    }
    z[m * L.ldz + f] = v;
  }
  for (int i = threadIdx.x; i < TM * d.Din; i += NT) {
    const int m = i / d.Din, a = i % d.Din;
    xs[m * L.ldx + a] = (m < count) ? send[m][a] : 0.f;
  }
  for (int m = threadIdx.x; m < TM; m += NT) {
    float x = 0.f, y = 0.f, w = 0.f;
    if (m < count) {
      x = sign * vec[m][0];
      y = sign * vec[m][1];
      w = sign * vec[m][2];
    }
    const float r = 1.7320508075688772f / sqrtf(fmaxf(x * x + y * y + w * w, 1e-12f));
    float* s = sh + m * L.ldsh;
    s[0] = 1.f;
    s[1] = x * r;
    s[2] = y * r;
    s[3] = w * r;
  }
}

// h[k][m] = relu(b1[k] + sum_f z[m][f] w1[f][k]), stored k-major for the GEMM.
__device__ void hidden_layer(float* sm, const Layout& L, const Dims& d, const TPWeights& W) {
  const float* z = sm + L.z;
  float* h = sm + L.h;
  for (int i = threadIdx.x; i < TM * d.H; i += NT) {
    const int m = i % TM, k = i / TM;
    const float* zr = z + m * L.ldz;
    float acc = W.b1[k];
    for (int f = 0; f < d.F; ++f) acc = fmaf(zr[f], W.w1[f * d.H + k], acc);
    h[k * TM + m] = fmaxf(acc, 0.f);
  }
}

// X[m][e] = sum_{a,b} x[in_base + a] sh[sh_base + b] cg[(a*ds + b)*dout + c].
__device__ void contributions(float* sm, const Layout& L, const TPTables& T) {
  const float* xs = sm + L.xs;
  const float* sh = sm + L.sh;
  float* X = sm + L.X;
  for (int i = threadIdx.x; i < TM * T.S; i += NT) {
    const int m = i % TM, e = i / TM;
    const int* r = T.xtab + e * XROW;
    const int di = r[1], ds = r[3], dout = r[4];
    const float* x = xs + m * L.ldx + r[0];
    const float* s = sh + m * L.ldsh + r[2];
    const float* cg = T.cg + r[6] + r[5];
    float acc = 0.f;
    for (int a = 0; a < di; ++a)
      for (int b = 0; b < ds; ++b) acc = fmaf(x[a] * s[b], cg[(a * ds + b) * dout], acc);
    X[m * L.ldxs + e] = acc;
  }
}

__device__ void load_w_tile(float* ws, const Dims& d, const TPWeights& W, const TPTables& T, int t) {
  const float4* src = reinterpret_cast<const float4*>(W.w2);
  float4* dst = reinterpret_cast<float4*>(ws);
  for (int i = threadIdx.x; i < d.H * (TN / 4); i += NT) {
    const int k = i / (TN / 4), q = i % (TN / 4);
    dst[i] = src[(k * T.Wpad + t * TN) / 4 + q];
  }
}

// msg[m][:] = the weighted tensor product of every slot (step 4 above).
__device__ void weighted_tp(float* sm, const Layout& L, const Dims& d, const TPWeights& W, const TPTables& T) {
  const float* h = sm + L.h;
  float* ws = sm + L.w;
  float* cs = sm + L.c;
  const float* X = sm + L.X;
  float* msg = sm + L.msg;
  for (int i = threadIdx.x; i < TM * L.ldm; i += NT) msg[i] = 0.f;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_w_tile(ws, d, W, T, 0);
  __syncthreads();
  for (int t = 0; t < T.n_tiles; ++t) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < d.H; ++k) {
      const float4 a = reinterpret_cast<const float4*>(h + k * TM)[ty];
      const float4 b = reinterpret_cast<const float4*>(ws + k * TN)[tx];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[(ty * 4 + i) * L.ldc + tx * 4 + j] = acc[i][j] + W.b2[t * TN + tx * 4 + j];
    __syncthreads();
    if (t + 1 < T.n_tiles) load_w_tile(ws, d, W, T, t + 1);
    const int e0 = T.epi_start[t], ne = T.epi_start[t + 1] - e0;
    for (int i = threadIdx.x; i < ne * TM; i += NT) {
      const int m = i % TM;
      const int* it = T.epi + (e0 + i / TM) * EROW;
      const int lo = it[0], hi = it[1], step = it[3];
      const float* cr = cs + m * L.ldc;
      const float* xr = X + m * L.ldxs + it[2];
      float s = 0.f;
      for (int n = lo; n < hi; ++n) s = fmaf(cr[n], xr[(n - lo) * step], s);
      msg[m * L.ldm + it[4]] += s;
    }
    __syncthreads();
  }
}

// Steps 2-4 for the slots of one chunk; leaves msg in shared memory.
__device__ void run_engine(float* sm, const Layout& L, const Dims& d, const TPWeights& W, const TPTables& T,
                           const EdgeSlots& s, const float* const* recv, const float* const* send,
                           const float* sig, float sign) {
  fill_edges(sm, L, d, s.count, s.emb, recv, send, s.vec, sig, sign);
  __syncthreads();
  hidden_layer(sm, L, d, W);
  contributions(sm, L, T);
  __syncthreads();
  weighted_tp(sm, L, d, W, T);
}

// out_tile[slot[m]][:] += msg[m][:] in slot order (deterministic).
__device__ void reduce_to_tile(float* sm, const Layout& L, const Dims& d, const EdgeSlots& s) {
  const float* msg = sm + L.msg;
  float* outs = sm + L.out;
  for (int o = threadIdx.x; o < d.Dout; o += NT)
    for (int m = 0; m < s.count; ++m) outs[s.slot[m] * d.Dout + o] += msg[m * L.ldm + o];
}

inline size_t smem_bytes(const Layout& L) { return (size_t)L.total * sizeof(float); }

}  // namespace cbt

extern "C" const char* cbt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
