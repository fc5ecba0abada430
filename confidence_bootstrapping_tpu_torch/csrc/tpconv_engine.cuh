// Shared edge engine of the TP-conv kernels (float32, sm_90a).
//
// Every TP-conv message on the score and confidence models' paths is
//   h   = relu([edge_emb | recv[:ns] | send[:ns]] @ w1 + b1)        (F -> H)
//   w   = h @ w2 + b2                                                 (H -> W)
//   msg = WeightedTensorProduct(send, sh(send_pos - recv_pos), w)
// summed over the edges of each receiver, with harmonics of lmax=1 (SHD=4
// components, the score model) or lmax=2 (SHD=9, the all-atom confidence
// model); SHD is a template parameter, so each kernel is compiled for one.
// The Pallas kernels (ops/pallas/tpconv_rec.py, tpconv_lig.py, tpconv_g.py)
// build it from one-hot gather matmuls, a CG matrix G and expand/reduce
// matrices E/R sized for a 128x128 MXU. Here a block gathers its own edges
// and runs the product directly:
//
//   1. compact: warp 0 ballots the candidate edges of the block's receivers
//      and keeps the valid ones in order, TM per chunk, so masked edges cost
//      nothing and contribute exactly zero;
//   2. fill: per edge the MLP input z [F], the sender features [Din] and the
//      harmonics of u = v / |v| (|v|^2 clamped at 1e-12, so a zero vector
//      gives zero in every l >= 1 component): 1, sqrt(3) u and, for SHD=9,
//      the l=2 block (xy, yz, 2z^2-x^2-y^2, zx, x^2-y^2) scaled as in
//      ops/irreps.spherical_harmonics;
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
// (about 0.32 MFLOP at H=96, W=1660; 0.28 MFLOP at the confidence model's
// H=72, W=1944), at the 67 TFLOP/s float32 rate of the CUDA cores; bytes are
// small beside it (an edge reads ~1 KB). The design
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

// At SHD=9 and the confidence trunk's 84 -> 84 layer (S=312, H=72) this is
// about 41k floats (165 KB) plus the receiver tile, under the 227 KB a block
// may take.
template <int SHD>
__host__ __device__ inline Layout make_layout(const Dims& d, int S, int RT) {
  Layout L;
  L.ldz = d.F | 1;  // odd strides: rows of consecutive threads hit distinct banks
  L.ldx = d.Din | 1;
  L.ldsh = SHD | 1;
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
template <int SHD>
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
    float* s = sh + m * L.ldsh;
    s[0] = 1.f;
    if (SHD == 4) {
      const float r = 1.7320508075688772f / sqrtf(fmaxf(x * x + y * y + w * w, 1e-12f));
      s[1] = x * r;
      s[2] = y * r;
      s[3] = w * r;
    } else {
      const float r = 1.f / sqrtf(fmaxf(x * x + y * y + w * w, 1e-12f));
      const float ux = x * r, uy = y * r, uz = w * r;
      s[1] = 1.7320508075688772f * ux;
      s[2] = 1.7320508075688772f * uy;
      s[3] = 1.7320508075688772f * uz;
      s[4] = 3.8729833462074170f * ux * uy;                       // sqrt(15) xy
      s[5] = 3.8729833462074170f * uy * uz;                       // sqrt(15) yz
      s[6] = 1.1180339887498949f * (2.f * uz * uz - ux * ux - uy * uy);  // sqrt(5)/2
      s[7] = 3.8729833462074170f * uz * ux;                       // sqrt(15) zx
      s[8] = 1.9364916731037085f * (ux * ux - uy * uy);           // sqrt(15)/2
    }
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

// The training variant: h[k][m] times the hidden-layer dropout mask of the
// slot's edge, dm[cand[m] * hd + k] ({0, 1/keep}; hd = H, or 1 for one value
// per edge), applied after the ReLU as the JAX package's kernels apply it.
__device__ void hidden_layer_dm(float* sm, const Layout& L, const Dims& d, const TPWeights& W, const EdgeSlots& s,
                                const float* __restrict__ dm, int hd) {
  const float* z = sm + L.z;
  float* h = sm + L.h;
  const int ks = hd > 1 ? 1 : 0;
  for (int i = threadIdx.x; i < TM * d.H; i += NT) {
    const int m = i % TM, k = i / TM;
    const float* zr = z + m * L.ldz;
    float acc = W.b1[k];
    for (int f = 0; f < d.F; ++f) acc = fmaf(zr[f], W.w1[f * d.H + k], acc);
    float v = fmaxf(acc, 0.f);
    if (m < s.count) v *= dm[(size_t)s.cand[m] * hd + k * ks];
    h[k * TM + m] = v;
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

// Steps 2-4 for the slots of one chunk; leaves msg in shared memory. DM
// selects the training variant of the hidden layer (dropout mask dm, whose
// rows are indexed by the slots' candidate numbers); the inference
// instantiation (DM = false) is the code it was before the mask existed.
template <int SHD, bool DM = false>
__device__ void run_engine(float* sm, const Layout& L, const Dims& d, const TPWeights& W, const TPTables& T,
                           const EdgeSlots& s, const float* const* recv, const float* const* send,
                           const float* sig, float sign, const float* dm = nullptr, int hd = 0) {
  fill_edges<SHD>(sm, L, d, s.count, s.emb, recv, send, s.vec, sig, sign);
  __syncthreads();
  if constexpr (DM)
    hidden_layer_dm(sm, L, d, W, s, dm, hd);
  else
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

// One block's tile of RT receivers of a kNN group whose senders and
// receivers are one node table [B, N, Din] (the rec and rec_g kernels).
// Candidates are the RT*K neighbour slots in (receiver, k) order; sig [B, Fe]
// is added to the cached edge embedding in the fill. With DM (training), dm
// [B, N, K, hd] is the hidden-layer dropout mask of every neighbour slot.
template <int SHD, bool DM = false>
__device__ void rec_tile(float* sm, EdgeSlots& s, const float* __restrict__ node, const float* __restrict__ pos,
                         const int64_t* __restrict__ nbr, const float* __restrict__ emb,
                         const float* __restrict__ sig, const uint8_t* __restrict__ mask, const TPWeights& W,
                         const TPTables& T, const Dims& d, int N, int K, int RT, float* __restrict__ out,
                         const float* __restrict__ dm = nullptr, int hd = 0) {
  const Layout L = make_layout<SHD>(d, T.S, RT);
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
    if constexpr (DM)
      run_engine<SHD, true>(sm, L, d, W, T, s, s.recv, s.send, sig + (size_t)b * d.Fe, 1.f,
                            dm + (row0 + i0) * K * hd, hd);
    else
      run_engine<SHD>(sm, L, d, W, T, s, s.recv, s.send, sig + (size_t)b * d.Fe, 1.f);
    reduce_to_tile(sm, L, d, s);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nrecv * d.Dout; i += NT) out[(row0 + i0) * d.Dout + i] = outs[i];
}

// One block's tile of RT receivers [B, L, Din] of a capped cross list over a
// sender table [B, N, Din] (the cross_rev and cross_g kernels). Candidates
// are the tile's RT*K sender slots. Each chunk runs the engine on the
// receivers with the forward weights (summed onto the tile in slot order),
// then, when with_rev is set, sender <- receiver with the roles swapped and
// the harmonics negated, added into out_rec [B, N, Dout] with atomicAdd:
// those sums' order varies from run to run (a few float32 ulps).
template <int SHD>
__device__ void cross_tile(float* sm, EdgeSlots& s, const float* __restrict__ lig, const float* __restrict__ lpos,
                           const float* __restrict__ rec, const float* __restrict__ rpos,
                           const int64_t* __restrict__ idx, const float* __restrict__ emb,
                           const uint8_t* __restrict__ mask, const TPWeights& Wf, const TPWeights& Wr, int with_rev,
                           const TPTables& T, const Dims& d, int L, int N, int K, int RT,
                           float* __restrict__ out_lig, float* __restrict__ out_rec) {
  const Layout Ly = make_layout<SHD>(d, T.S, RT);
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
    run_engine<SHD>(sm, Ly, d, Wf, T, s, s.recv, s.send, nullptr, 1.f);
    reduce_to_tile(sm, Ly, d, s);
    __syncthreads();
    if (with_rev) {
      run_engine<SHD>(sm, Ly, d, Wr, T, s, s.send, s.recv, nullptr, -1.f);
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

// Edge-list fill: the MLP input (all F columns), sender features and
// harmonics (SHD given components) of each kept slot, read from per-edge
// rows; edge e = the slot's candidate number past the block's first edge.
template <int SHD>
__device__ void fill_given(float* sm, const Layout& L, const Dims& d, const EdgeSlots& s,
                           const float* __restrict__ attr, const float* __restrict__ send,
                           const float* __restrict__ shin) {
  float* z = sm + L.z;
  float* xs = sm + L.xs;
  float* sh = sm + L.sh;
  for (int i = threadIdx.x; i < TM * d.F; i += NT) {
    const int m = i / d.F, f = i % d.F;
    z[m * L.ldz + f] = (m < s.count) ? attr[(size_t)s.cand[m] * d.F + f] : 0.f;
  }
  for (int i = threadIdx.x; i < TM * d.Din; i += NT) {
    const int m = i / d.Din, a = i % d.Din;
    xs[m * L.ldx + a] = (m < s.count) ? send[(size_t)s.cand[m] * d.Din + a] : 0.f;
  }
  for (int i = threadIdx.x; i < TM * SHD; i += NT) {
    const int m = i / SHD, b = i % SHD;
    sh[m * L.ldsh + b] = (m < s.count) ? shin[(size_t)s.cand[m] * SHD + b] : 0.f;
  }
}

// One block's RT rows of a pre-gathered edge list [M, K, *] (the edge-list
// kernel): attr [M, K, F], send [M, K, Din], harmonics [M, K, SHD], mask
// [M, K]; with DM the hidden-layer dropout mask dm [M, K, hd]. Candidates are
// the RT*K edges of the rows in order. sum_k: the rows' message sums
// [M, Dout]; otherwise each kept edge's message at out [M, K, Dout] (the
// caller zeroes out, so masked edges read zero).
template <int SHD, bool DM>
__device__ void edge_tile(float* sm, EdgeSlots& s, const float* __restrict__ attr, const float* __restrict__ send,
                          const float* __restrict__ shin, const uint8_t* __restrict__ mask,
                          const float* __restrict__ dm, int hd, const TPWeights& W, const TPTables& T, const Dims& d,
                          int M, int K, int RT, int sum_k, float* __restrict__ out) {
  const Layout L = make_layout<SHD>(d, T.S, RT);
  const int m0 = blockIdx.x * RT;
  const int nrows = min(RT, M - m0);
  const size_t e0 = (size_t)m0 * K;
  float* outs = sm + L.out;
  for (int i = threadIdx.x; i < RT * d.Dout; i += NT) outs[i] = 0.f;
  if (threadIdx.x == 0) s.cursor = 0;
  __syncthreads();
  const uint8_t* mrow = mask + e0;
  while (true) {
    compact(nrows * K, [&](int c) { return mrow[c] != 0; }, s);
    if (s.count == 0) break;
    for (int m = threadIdx.x; m < s.count; m += NT) s.slot[m] = s.cand[m] / K;
    fill_given<SHD>(sm, L, d, s, attr + e0 * d.F, send + e0 * d.Din, shin + e0 * SHD);
    __syncthreads();
    if constexpr (DM)
      hidden_layer_dm(sm, L, d, W, s, dm + e0 * hd, hd);
    else
      hidden_layer(sm, L, d, W);
    contributions(sm, L, T);
    __syncthreads();
    weighted_tp(sm, L, d, W, T);
    if (sum_k) {
      reduce_to_tile(sm, L, d, s);
    } else {
      const float* msg = sm + L.msg;
      for (int i = threadIdx.x; i < s.count * d.Dout; i += NT) {
        const int m = i / d.Dout, o = i % d.Dout;
        out[(e0 + s.cand[m]) * d.Dout + o] = msg[m * L.ldm + o];
      }
    }
    __syncthreads();
  }
  if (sum_k)
    for (int i = threadIdx.x; i < nrows * d.Dout; i += NT) out[(size_t)m0 * d.Dout + i] = outs[i];
}

}  // namespace cbt

extern "C" const char* cbt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
