// Shared edge engine of the TP-conv kernels (float32 and 3xTF32, sm_90a).
//
// Every TP-conv message on the score and confidence models' paths is
//   h   = relu([edge_emb | recv[:ns] | send[:ns]] @ w1 + b1)        (F -> H)
//   w   = h @ w2 + b2                                                 (H -> W)
//   msg = WeightedTensorProduct(send, sh(send_pos - recv_pos), w)
// summed over the edges of each receiver, with harmonics of lmax=1 (SHD=4
// components, the score model) or lmax=2 (SHD=9, the all-atom confidence
// model); SHD is a template parameter, so each kernel is compiled for one.
// Sender and output irreps hold blocks of l <= 2 (l = 2: the second-order
// irreps ladder, 5 components a block).
// The Pallas kernels (ops/pallas/tpconv_rec.py, tpconv_lig.py, tpconv_g.py)
// build it from one-hot gather matmuls, a CG matrix G and expand/reduce
// matrices E/R sized for a 128x128 MXU. Here a block gathers its own edges
// and runs the product directly:
//
//   1. compact: warp 0 ballots the candidate edges of the block's receivers
//      and keeps the valid ones in order, TM (64) per chunk, so masked edges
//      cost nothing and contribute exactly zero; the float32 stage also has
//      builds at TM_WIDE = 32 edges a chunk (template parameter CM) for
//      layers whose 64-edge layout does not fit a block's shared memory;
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
// What bounds the float32 stage on the card: the H x W product, 2*H*W flops
// per edge (0.57 MFLOP at the score model's 100 -> 100 layer, H=96, W=2960;
// 0.28 MFLOP at the confidence model's H=72, W=1944), at the 67 TFLOP/s
// float32 rate of the CUDA cores; bytes are small beside it (an edge reads
// ~1 KB). It keeps w2 tiles in shared memory for TM edges at a time and
// never writes w or the per-edge messages to device memory.
//
// The tensor-core stage (TC = true: the rec, pb, cross_rev, rec_g and row 4
// (cross) inference kernels, rec with the dropout mask and the edge-list
// kernel; cross_g, rec_g with the mask and the layers the stage does not take
// keep the float32 stage; the edge backward's tensor-core build reuses its
// pieces) runs steps 3 and 4 so:
//
//   * 3xTF32: w2 is split once on the host (ops/cuda/tpconv_common.py:
//     pack_weights) into w2_hi = tf32(w2) and w2_lo = tf32(w2 - w2_hi), and
//     h in the block the same way (cvt.rna.tf32.f32); one float32
//     accumulator takes h_lo w_hi + h_hi w_lo + h_hi w_hi, which keeps the
//     product within float32 rounding of the float32 stage's (one TF32
//     product is off by ~3e-4 of the largest value at K=96, over the
//     kernels' 2e-4 bar). H is padded with zeros to
//     Hp, a multiple of 8, and may be at most KMAX = 96. A layer with a
//     larger H, or whose layout below does not fit the 232,448 bytes a block
//     may take (the ns=48/nv=10 ladder: 230,608 bytes at 48 -> 78 before the
//     static 3,104, 310,288 at 156 -> 156), runs the kernel's float32 build at
//     TM_WIDE edges a chunk instead (156,544 bytes at 156 -> 156); the host
//     picks the build from a mirror of these layouts
//     (ops/cuda/tpconv_common.py: pick_build, engine_smem_bytes), and every
//     library exports the C++ bytes (cbt_smem_bytes, and its kernels' static
//     bytes: cbt_static_smem_bytes);
//   * both warpgroups hold the chunk's 64 x Hp hidden layer as wgmma A
//     fragments in registers (hi and lo, loaded once per chunk) and each
//     multiplies it by its 24-column half of a TNC = 48-column w2 tile read
//     from shared memory (wgmma m64n24k8, B K-major, no swizzle);
//   * the host stores each w2 tile in the layout wgmma reads (core matrices
//     of 8 columns x 4 k, tiles [TNC/8][Hp/4][8][4]), so a tile is one bulk
//     copy per part (cp.async.bulk, completion on an mbarrier, no tensor
//     map); a ring of two stages keeps the next tile in flight while the
//     current one multiplies;
//   * tile t+1's wgmma is issued before tile t's epilogue, so that the
//     tensor cores can run while the CUDA cores sum tile t's columns (the
//     same itemised epilogue, b2 added on the way out of the accumulators,
//     fixed order: rec stays deterministic). Every k-step is issued, with no
//     branch between the wgmma instructions: a branch there makes ptxas wait
//     for each one;
//   * what the float32 stage reads through L1 comes from shared memory
//     here (beside this much shared memory L1 is too small to keep it): w1,
//     copied per chunk into the X region until the contributions write X, for
//     a register-tiled hidden layer stored [edges][Hp]; the X table's rows
//     and cg, copied into the msg region until step 4 zeroes msg, for
//     contributions with fixed-trip loops (unrolled to the l = 1 harmonic
//     block at SHD=4, the l = 2 block at SHD=9 and the l = 3 block at
//     SHD=16 (sh_lmax=3) and SHD=20, the torsion head's harmonics); the
//     epilogue items,
//     copied once per block; b2 of a tile is read while the tile multiplies;
//   * cross_rev runs both directions through one call site: two inlined
//     copies of the stage hold too many registers at once and spill;
//   * room: the transients of a chunk (z, the sender features, the
//     harmonics and h, until the fragments are loaded) share one region with
//     the ring and the GEMM tile. Bytes at the score model's ladder layers
//     (Hp=96, RT=8 receivers): 206,448 dynamic (ring 73,728, GEMM tile
//     12,544, X 87,296, msg 25,856, out tile 3,200, epilogue items 3,824) at
//     100 -> 100 (S=340); 172,928 at 68 -> 100 (S=212); 152,160 at 50 -> 68;
//     139,248 at 32 -> 50; plus 3,104 static, under the 227 KB a block may
//     take. pb and cross_rev take (8 - RT) * Dout floats less (RT = 6 and
//     1 at B=32); rec_g at the confidence trunk's 84 -> 84 layer (SHD=9,
//     S=312, H=72, RT=8) 175,296.
//
// What bounds the tensor-core stage: the 3 TF32 products, 6*Hp*W flops per
// edge at 495 TFLOP/s (chip_smoke.py's tensor-core bound). It also streams
// w2 (hi and lo, 2*4*Hp*W bytes, 2.3 MB at 100 -> 100) from L2 once per
// 64-edge chunk, about 36 KB an edge. scripts/engine_ablation.py measures
// what each stage costs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cbt {

constexpr int TM = 64;    // edges per chunk: the tensor-core stage and the float32 stage's default build
constexpr int TM_WIDE = 32;  // edges per chunk of the float32 builds for layers whose TM-edge layout does not fit
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
  int n_epi, n_cg;  // items in epi, floats in cg (read by the tensor-core stage only)
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
// CM: edges per chunk (TM, or TM_WIDE for a layer too wide for TM).
template <int SHD, int CM = TM>
__host__ __device__ inline Layout make_layout(const Dims& d, int S, int RT) {
  Layout L;
  L.ldz = d.F | 1;  // odd strides: rows of consecutive threads hit distinct banks
  L.ldx = d.Din | 1;
  L.ldsh = SHD | 1;
  L.ldxs = S | 1;
  L.ldc = TN + 1;
  L.ldm = d.Dout | 1;
  const int zsz = round4(CM * L.ldz), xssz = round4(CM * L.ldx);
  const int wsz = round4(d.H * TN), csz = round4(CM * L.ldc);
  int o = 0;
  L.z = o;
  L.xs = o + zsz;
  L.w = o;
  L.c = o + wsz;
  o += (zsz + xssz > wsz + csz) ? zsz + xssz : wsz + csz;
  L.sh = o;
  o += round4(CM * L.ldsh);
  L.h = o;
  o += round4(d.H * CM);
  L.X = o;
  o += round4(CM * L.ldxs);
  L.msg = o;
  o += round4(CM * L.ldm);
  L.out = o;
  o += round4(RT * d.Dout);
  L.total = o;
  return L;
}

// Per-chunk edge records, filled by each kernel for the edges compact() kept.
template <int CM = TM>
struct EdgeSlots {
  const float* emb[CM];   // edge embedding row [Fe]
  const float* recv[CM];  // receiver feature row (first ns read)
  const float* send[CM];  // sender feature row [Din]
  float vec[CM][3];       // sender position - receiver position
  int slot[CM];           // receiver row inside the block's tile
  int dst[CM];            // cross_rev: receptor row of the edge
  int cand[CM];           // candidate index of each kept edge
  int count, cursor;
};

// Keep the next (up to CM) valid candidates in [cursor, ncand), in order.
template <int CM, class Valid>
__device__ void compact(int ncand, Valid valid, EdgeSlots<CM>& s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0, cur = s.cursor;
    while (count < CM && cur < ncand) {
      const int c = cur + lane;
      const bool v = c < ncand && valid(c);
      const unsigned ball = __ballot_sync(0xffffffffu, v);
      const int pos = count + __popc(ball & ((1u << lane) - 1u));
      if (v && pos < CM) s.cand[pos] = c;
      const int total = __popc(ball);
      if (count + total <= CM) {
        count += total;
        cur += 32;
      } else {
        const unsigned last = __ballot_sync(0xffffffffu, v && pos == CM - 1);
        cur += __ffs(last);  // one past the lane of the last edge kept
        count = CM;
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
template <int SHD, int CM = TM>
__device__ void fill_edges(float* sm, const Layout& L, const Dims& d, int count, const float* const* emb,
                           const float* const* recv, const float* const* send, const float (*vec)[3],
                           const float* sig, float sign) {
  float* z = sm + L.z;
  float* xs = sm + L.xs;
  float* sh = sm + L.sh;
  for (int i = threadIdx.x; i < CM * d.F; i += NT) {
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
  for (int i = threadIdx.x; i < CM * d.Din; i += NT) {
    const int m = i / d.Din, a = i % d.Din;
    xs[m * L.ldx + a] = (m < count) ? send[m][a] : 0.f;
  }
  for (int m = threadIdx.x; m < CM; m += NT) {
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
template <int CM = TM>
__device__ void hidden_layer(float* sm, const Layout& L, const Dims& d, const TPWeights& W) {
  const float* z = sm + L.z;
  float* h = sm + L.h;
  for (int i = threadIdx.x; i < CM * d.H; i += NT) {
    const int m = i % CM, k = i / CM;
    const float* zr = z + m * L.ldz;
    float acc = W.b1[k];
    for (int f = 0; f < d.F; ++f) acc = fmaf(zr[f], W.w1[f * d.H + k], acc);
    h[k * CM + m] = fmaxf(acc, 0.f);
  }
}

// The training variant: h[k][m] times the hidden-layer dropout mask of the
// slot's edge, dm[cand[m] * hd + k] ({0, 1/keep}; hd = H, or 1 for one value
// per edge), applied after the ReLU as the JAX package's kernels apply it.
template <int CM = TM>
__device__ void hidden_layer_dm(float* sm, const Layout& L, const Dims& d, const TPWeights& W,
                                const EdgeSlots<CM>& s, const float* __restrict__ dm, int hd) {
  const float* z = sm + L.z;
  float* h = sm + L.h;
  const int ks = hd > 1 ? 1 : 0;
  for (int i = threadIdx.x; i < CM * d.H; i += NT) {
    const int m = i % CM, k = i / CM;
    const float* zr = z + m * L.ldz;
    float acc = W.b1[k];
    for (int f = 0; f < d.F; ++f) acc = fmaf(zr[f], W.w1[f * d.H + k], acc);
    float v = fmaxf(acc, 0.f);
    if (m < s.count) v *= dm[(size_t)s.cand[m] * hd + k * ks];
    h[k * CM + m] = v;
  }
}

// X[m][e] = sum_{a,b} x[in_base + a] sh[sh_base + b] cg[(a*ds + b)*dout + c].
template <int CM = TM>
__device__ void contributions(float* sm, const Layout& L, const TPTables& T) {
  const float* xs = sm + L.xs;
  const float* sh = sm + L.sh;
  float* X = sm + L.X;
  for (int i = threadIdx.x; i < CM * T.S; i += NT) {
    const int m = i % CM, e = i / CM;
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

// msg[m][:] = the weighted tensor product of every slot (step 4 above). The
// 16 x 16 thread grid holds CM/16 rows and 4 columns of a tile each.
template <int CM = TM>
__device__ void weighted_tp(float* sm, const Layout& L, const Dims& d, const TPWeights& W, const TPTables& T) {
  constexpr int RM = CM / 16;
  static_assert(RM == 4 || RM == 2, "chunks of 64 or 32 edges");
  const float* h = sm + L.h;
  float* ws = sm + L.w;
  float* cs = sm + L.c;
  const float* X = sm + L.X;
  float* msg = sm + L.msg;
  for (int i = threadIdx.x; i < CM * L.ldm; i += NT) msg[i] = 0.f;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_w_tile(ws, d, W, T, 0);
  __syncthreads();
  for (int t = 0; t < T.n_tiles; ++t) {
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < d.H; ++k) {
      float av[RM];
      if constexpr (RM == 4) {
        const float4 a = reinterpret_cast<const float4*>(h + k * CM)[ty];
        av[0] = a.x;
        av[1] = a.y;
        av[2] = a.z;
        av[3] = a.w;
      } else {
        const float2 a = reinterpret_cast<const float2*>(h + k * CM)[ty];
        av[0] = a.x;
        av[1] = a.y;
      }
      const float4 b = reinterpret_cast<const float4*>(ws + k * TN)[tx];
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[(ty * RM + i) * L.ldc + tx * 4 + j] = acc[i][j] + W.b2[t * TN + tx * 4 + j];
    __syncthreads();
    if (t + 1 < T.n_tiles) load_w_tile(ws, d, W, T, t + 1);
    const int e0 = T.epi_start[t], ne = T.epi_start[t + 1] - e0;
    for (int i = threadIdx.x; i < ne * CM; i += NT) {
      const int m = i % CM;
      const int* it = T.epi + (e0 + i / CM) * EROW;
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
template <int SHD, bool DM = false, int CM = TM>
__device__ void run_engine(float* sm, const Layout& L, const Dims& d, const TPWeights& W, const TPTables& T,
                           const EdgeSlots<CM>& s, const float* const* recv, const float* const* send,
                           const float* sig, float sign, const float* dm = nullptr, int hd = 0) {
  fill_edges<SHD, CM>(sm, L, d, s.count, s.emb, recv, send, s.vec, sig, sign);
  __syncthreads();
  if constexpr (DM)
    hidden_layer_dm<CM>(sm, L, d, W, s, dm, hd);
  else
    hidden_layer<CM>(sm, L, d, W);
  contributions<CM>(sm, L, T);
  __syncthreads();
  weighted_tp<CM>(sm, L, d, W, T);
}

// out_tile[slot[m]][:] += msg[m][:] in slot order (deterministic).
template <int CM>
__device__ void reduce_to_tile(float* sm, const Layout& L, const Dims& d, const EdgeSlots<CM>& s) {
  const float* msg = sm + L.msg;
  float* outs = sm + L.out;
  for (int o = threadIdx.x; o < d.Dout; o += NT)
    for (int m = 0; m < s.count; ++m) outs[s.slot[m] * d.Dout + o] += msg[m * L.ldm + o];
}

inline size_t smem_bytes(const Layout& L) { return (size_t)L.total * sizeof(float); }

// ---------------------------------------------------------------------------
// The tensor-core stage (3xTF32 wgmma; see the note at the top)
// ---------------------------------------------------------------------------

constexpr int TNC = 48;         // w2 columns per tensor-core tile (ops/cuda/tpconv_common.py: TNC)
constexpr int KMAX = 96;        // largest hidden width H the stage takes
constexpr int KSTEPS = KMAX / 8;

struct TPWeightsTC {
  const float* w1;    // [F, H] row-major
  const float* b1;    // [H]
  const float* w2hi;  // [n_tiles][TNC/8][Hp/4][8][4]: tf32(w2), columns as TPWeights::w2
  const float* w2lo;  // the same layout: tf32(w2 - w2hi)
  const float* b2;    // [n_tiles * TNC]
};

// Layout plus the stage's fields: Hp, the hidden layer's row stride, the
// epilogue tables' copy (epi, then epi_start) and the ring (two stages of hi
// and lo tiles, at L.w); L.c is the GEMM tile.
struct LayoutTC : Layout {
  int hp, ldh, epi;
};

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

template <int SHD>
__host__ __device__ inline LayoutTC make_layout_tc(const Dims& d, const TPTables& T, int RT) {
  const int S = T.S;
  LayoutTC L;
  L.hp = round8(d.H);
  L.ldz = d.F | 1;
  L.ldx = d.Din | 1;
  L.ldsh = SHD | 1;
  L.ldxs = S | 1;
  L.ldc = TNC + 1;
  L.ldm = d.Dout | 1;
  L.ldh = L.hp + 4;  // fragment loads: rows g, g+8 at columns t, t+4 hit distinct banks
  const int ring = 4 * TNC * L.hp, csz = round4(TM * L.ldc);
  const int zsz = round4(TM * L.ldz), xssz = round4(TM * L.ldx), shsz = round4(TM * L.ldsh);
  const int hsz = round4(TM * L.ldh);
  L.w = 0;
  L.c = ring;
  L.z = 0;
  L.xs = zsz;
  L.sh = zsz + xssz;
  L.h = zsz + xssz + shsz;
  int o = (ring + csz > L.h + hsz) ? ring + csz : L.h + hsz;
  L.X = o;  // also holds w1 [F, H] while the hidden layer is built
  o += round4(TM * L.ldxs > d.F * d.H ? TM * L.ldxs : d.F * d.H);
  L.msg = o;  // also holds the X table's rows [S, XROW] and cg until step 4 zeroes msg
  o += round4(TM * L.ldm > S * XROW + T.n_cg ? TM * L.ldm : S * XROW + T.n_cg);
  L.out = o;
  o += round4(RT * d.Dout);
  L.epi = o;
  o += round4(T.n_epi * EROW + T.n_tiles + 1);
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// Round to TF32, nearest with ties away from zero; the low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Order this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (bulk copies into memory the threads have used).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// Copy `bytes` (a multiple of 16) from device to shared memory; completion
// counts against the barrier's expected transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keep the accumulators in their registers across the asynchronous wgmma.
__device__ __forceinline__ void pin(float (&acc)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Materialise the A fragments where they are loaded, so that the compiler
// does not sink their loads between the wgmma instructions that read them.
__device__ __forceinline__ void pin(uint32_t (&a)[KSTEPS][4]) {
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[s][j])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand with no swizzle:
// core matrices of 8 rows x 16 bytes, lbo bytes apart along K and sbo bytes
// apart along the rows.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// acc (+)= A [64 x 8] (registers) * B [8 x 24] (shared memory), TF32 in, float32 sum.
__device__ __forceinline__ void wgmma_n24(float (&d)[12], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// This thread's A fragments of the [64][ldh] hidden layer, split hi/lo.
// Warp w of a warpgroup owns rows 16w..16w+15; lane (g = lane/4, q = lane%4)
// holds rows g, g+8 at columns q, q+4 of each 8-wide k-step. Columns past hp
// read as zero.
__device__ __forceinline__ void load_fragments(const float* h, int ldh, int hp, uint32_t (&hi)[KSTEPS][4],
                                               uint32_t (&lo)[KSTEPS][4]) {
  const int lane = threadIdx.x & 31, r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2), c0 = lane & 3;
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = s * 8 + c0 + (j >> 1) * 4;
      const float x = c < hp ? h[(r0 + (j & 1) * 8) * ldh + c] : 0.f;
      hi[s][j] = tf32_rna(x);
      lo[s][j] = tf32_rna(x - __uint_as_float(hi[s][j]));
    }
  pin(hi);
  pin(lo);
}

// One stage of the ring: tile t's hi and lo parts, TNC * hp floats each.
__device__ __forceinline__ void load_tile(float* stage, const TPWeightsTC& W, int hp, int t, uint64_t* bar) {
  const uint32_t part = TNC * hp * sizeof(float);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(2 * part)
               : "memory");
  bulk_load(stage, W.w2hi + (size_t)t * TNC * hp, part, bar);
  bulk_load(stage + TNC * hp, W.w2lo + (size_t)t * TNC * hp, part, bar);
}

// Issue this warpgroup's 24 columns of one tile: for each k-step
// h_lo w_hi + h_hi w_lo + h_hi w_hi into acc (zeroed by the first). All
// KSTEPS steps are issued, with no branch between the wgmma instructions (a
// branch there makes ptxas wait for each one): past hp the A fragments are
// zero and B is the tile's last k-step, so those steps add exact zeros.
__device__ __forceinline__ void mma_tile(float (&acc)[12], const uint32_t (&hi)[KSTEPS][4],
                                         const uint32_t (&lo)[KSTEPS][4], const float* stage, int hp) {
  const uint32_t sbo = hp * 32;  // 8 columns x hp k x 4 bytes
  const uint32_t bhi = smem_addr(stage) + (threadIdx.x >> 7) * (TNC / 16) * sbo;
  const uint32_t blo = bhi + TNC * hp * sizeof(float);
  const int last = hp / 8 - 1;
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const uint32_t k = (s < last ? s : last) * 256;
    wgmma_n24(acc, lo[s], kmajor_desc(bhi + k, 128, sbo), s > 0);
    wgmma_n24(acc, hi[s], kmajor_desc(blo + k, 128, sbo), 1);
    wgmma_n24(acc, hi[s], kmajor_desc(bhi + k, 128, sbo), 1);
  }
  wgmma_commit();
}

// w1 [F, H] into the X region, free until contributions_tc() writes X, and
// the X table's rows and cg into the msg region, free until step 4 zeroes
// msg: the hidden layer and the contributions then read them from shared
// memory (L1 is too small beside the block's shared memory to keep them).
__device__ void stage_tables(float* sm, const LayoutTC& L, const Dims& d, const TPWeightsTC& W, const TPTables& T) {
  float* w1 = sm + L.X;
  int* xtab = reinterpret_cast<int*>(sm + L.msg);
  float* cg = sm + L.msg + T.S * XROW;
#pragma unroll 4
  for (int i = threadIdx.x; i < d.F * d.H; i += NT) w1[i] = W.w1[i];
#pragma unroll 4
  for (int i = threadIdx.x; i < T.S * XROW; i += NT) xtab[i] = T.xtab[i];
  for (int i = threadIdx.x; i < T.n_cg; i += NT) cg[i] = T.cg[i];
}

// contributions() from stage_tables' copies, its loops unrolled to the
// stage's irreps (input blocks of at most DI components: 3, l <= 1, or 5, the
// second-order ladder's l = 2 blocks, a build of its own so that the l <= 1
// layers keep their code; harmonic blocks up to l = 1 at SHD=4, l = 2 at
// SHD=9, l = 3 at SHD=16 and 20: ds <= 3, 5 or 7); the same terms in the same order,
// so X is the same bit for bit.
template <int SHD, int DI = 3>
__device__ void contributions_tc(float* sm, const LayoutTC& L, const TPTables& T) {
  constexpr int DS = SHD == 4 ? 3 : SHD == 9 ? 5 : 7;
  const float* xs = sm + L.xs;
  const float* sh = sm + L.sh;
  const int* xtab = reinterpret_cast<const int*>(sm + L.msg);
  const float* cgs = sm + L.msg + T.S * XROW;
  float* X = sm + L.X;
#pragma unroll 2
  for (int i = threadIdx.x; i < TM * T.S; i += NT) {
    const int m = i % TM, e = i / TM;
    const int* r = xtab + e * XROW;
    const int di = r[1], ds = r[3], dout = r[4];
    const float* x = xs + m * L.ldx + r[0];
    const float* s = sh + m * L.ldsh + r[2];
    const float* cg = cgs + r[6] + r[5];
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < DI; ++a)
#pragma unroll
      for (int b = 0; b < DS; ++b)
        if (a < di && b < ds) acc = fmaf(x[a] * s[b], cg[(a * ds + b) * dout], acc);
    X[m * L.ldxs + e] = acc;
  }
}

// h[m][k] = relu(b1[k] + sum_f z[m][f] w1[f][k]) ([edges][Hp], zero past H),
// summed in the float32 stage's order. Each thread holds rows ty + 16i and
// columns tx + 16j, 4 x KMAX/16 sums, from the w1 stage_tables put in X.
__device__ void hidden_layer_tc(float* sm, const LayoutTC& L, const Dims& d, const TPWeightsTC& W) {
  constexpr int KJ = KMAX / 16;
  const float* z = sm + L.z;
  const float* w1 = sm + L.X;
  float* h = sm + L.h;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = tx + 16 * j;
    const float b = k < d.H ? W.b1[k] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = b;
  }
#pragma unroll 4
  for (int f = 0; f < d.F; ++f) {
    float zv[4], wv[KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) zv[i] = z[(ty + 16 * i) * L.ldz + f];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = tx + 16 * j;
      wv[j] = k < d.H ? w1[f * d.H + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) acc[i][j] = fmaf(zv[i], wv[j], acc[i][j]);
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = tx + 16 * j;
    if (k < L.hp)
#pragma unroll
      for (int i = 0; i < 4; ++i) h[(ty + 16 * i) * L.ldh + k] = k < d.H ? fmaxf(acc[i][j], 0.f) : 0.f;
  }
}

// The training variant: h[m][k] times the dropout mask of the slot's edge,
// dm[cand[m] * hd + k] (hd = H, or 1 for one value per edge), after the ReLU
// and before the TF32 split, as hidden_layer_dm applies it; columns past H
// stay zero. A function of its own, so that hidden_layer_tc's callers keep
// their code.
__device__ void hidden_layer_tc_dm(float* sm, const LayoutTC& L, const Dims& d, const TPWeightsTC& W,
                                   const EdgeSlots<TM>& s, const float* __restrict__ dm, int hd) {
  constexpr int KJ = KMAX / 16;
  const float* z = sm + L.z;
  const float* w1 = sm + L.X;
  float* h = sm + L.h;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = tx + 16 * j;
    const float b = k < d.H ? W.b1[k] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = b;
  }
#pragma unroll 4
  for (int f = 0; f < d.F; ++f) {
    float zv[4], wv[KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) zv[i] = z[(ty + 16 * i) * L.ldz + f];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = tx + 16 * j;
      wv[j] = k < d.H ? w1[f * d.H + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) acc[i][j] = fmaf(zv[i], wv[j], acc[i][j]);
  }
  const int ks = hd > 1 ? 1 : 0;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = tx + 16 * j;
    if (k < L.hp)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty + 16 * i;
        float v = 0.f;
        if (k < d.H) {
          v = fmaxf(acc[i][j], 0.f);
          if (m < s.count) v *= dm[(size_t)s.cand[m] * hd + k * ks];
        }
        h[m * L.ldh + k] = v;
      }
  }
}

// Step 4 on the tensor cores (T's tables are those of TNC-column tiles).
// bar: the ring's two barriers; tiles: the block's running count of tiles
// loaded, which gives each stage's barrier parity.
__device__ void weighted_tp_tc(float* sm, const LayoutTC& L, const TPWeightsTC& W, const TPTables& T, uint64_t* bar,
                               uint32_t& tiles) {
  uint32_t hi[KSTEPS][4], lo[KSTEPS][4];
  load_fragments(sm + L.h, L.ldh, L.hp, hi, lo);
  float* msg = sm + L.msg;
  for (int i = threadIdx.x; i < TM * L.ldm; i += NT) msg[i] = 0.f;
  fence_proxy_async();  // the ring overwrites the transients
  __syncthreads();
  float* ring = sm + L.w;
  float* cs = sm + L.c;
  const float* X = sm + L.X;
  const int nt = T.n_tiles, stage_sz = 2 * TNC * L.hp;
  if (threadIdx.x == 0)
    for (int t = 0; t < 2 && t < nt; ++t) load_tile(ring + ((tiles + t) & 1) * stage_sz, W, L.hp, t, bar + ((tiles + t) & 1));
  float acc[12];
  mbar_wait(bar + (tiles & 1), (tiles >> 1) & 1);
  mma_tile(acc, hi, lo, ring + (tiles & 1) * stage_sz, L.hp);
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2), col = (threadIdx.x >> 7) * (TNC / 2) + (lane & 3) * 2;
  const int* epi = reinterpret_cast<const int*>(sm + L.epi);  // init_tc's copy
  const int* epi_start = epi + T.n_epi * EROW;
  float b2[6];  // b2 at this thread's accumulator columns of the tile in flight, read while it multiplies
#pragma unroll
  for (int q = 0; q < 6; ++q) b2[q] = W.b2[col + (q >> 1) * 8 + (q & 1)];
  for (int t = 0; t < nt; ++t) {
    const uint32_t cur = tiles + t;
    wgmma_wait_all();
    pin(acc);
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cs[(row + (r >> 1) * 8) * L.ldc + col + j * 8 + (r & 1)] = acc[j * 4 + r] + b2[j * 2 + (r & 1)];
    __syncthreads();  // the tile is in cs; both warpgroups are done with stage cur
    if (threadIdx.x == 0 && t + 2 < nt) load_tile(ring + (cur & 1) * stage_sz, W, L.hp, t + 2, bar + (cur & 1));
    if (t + 1 < nt) {
      mbar_wait(bar + ((cur + 1) & 1), ((cur + 1) >> 1) & 1);
      mma_tile(acc, hi, lo, ring + ((cur + 1) & 1) * stage_sz, L.hp);
#pragma unroll
      for (int q = 0; q < 6; ++q) b2[q] = W.b2[(t + 1) * TNC + col + (q >> 1) * 8 + (q & 1)];
    }
    const int e0 = epi_start[t], ne = epi_start[t + 1] - e0;
    for (int i = threadIdx.x; i < ne * TM; i += NT) {
      const int m = i % TM;
      const int* it = epi + (e0 + i / TM) * EROW;
      const int lo_n = it[0], hi_n = it[1], step = it[3];
      const float* cr = cs + m * L.ldc;
      const float* xr = X + m * L.ldxs + it[2];
      float s = 0.f;
      for (int n = lo_n; n < hi_n; ++n) s = fmaf(cr[n], xr[(n - lo_n) * step], s);
      msg[m * L.ldm + it[4]] += s;
    }
    __syncthreads();
  }
  tiles += nt;
}

// Steps 3-4 of one chunk on the tensor-core stage, after a fill (fill_edges
// or fill_given) of the slots' z, sender features and harmonics; leaves msg
// in shared memory. DM: the training variant of the hidden layer (dropout
// mask dm, rows indexed by the slots' candidate numbers).
template <int SHD, bool DM = false, int DI = 3>
__device__ void engine_tc_stages(float* sm, const LayoutTC& L, const Dims& d, const TPWeightsTC& W,
                                 const TPTables& T, const EdgeSlots<TM>& s, uint64_t* bar, uint32_t& tiles,
                                 const float* dm = nullptr, int hd = 0) {
  stage_tables(sm, L, d, W, T);
  __syncthreads();
  if constexpr (DM)
    hidden_layer_tc_dm(sm, L, d, W, s, dm, hd);
  else
    hidden_layer_tc(sm, L, d, W);
  __syncthreads();  // contributions_tc() overwrites the staged w1
  contributions_tc<SHD, DI>(sm, L, T);
  __syncthreads();
  weighted_tp_tc(sm, L, W, T, bar, tiles);
}

// Steps 2-4 of one chunk on the tensor-core stage; leaves msg in shared memory.
template <int SHD, bool DM = false, int DI = 3>
__device__ void run_engine_tc(float* sm, const LayoutTC& L, const Dims& d, const TPWeightsTC& W, const TPTables& T,
                              const EdgeSlots<TM>& s, const float* const* recv, const float* const* send,
                              const float* sig, float sign, uint64_t* bar, uint32_t& tiles,
                              const float* dm = nullptr, int hd = 0) {
  fill_edges<SHD>(sm, L, d, s.count, s.emb, recv, send, s.vec, sig, sign);
  engine_tc_stages<SHD, DM, DI>(sm, L, d, W, T, s, bar, tiles, dm, hd);
}

// The layout and weights of the float32 (TC = false) or tensor-core stage.
template <bool TC>
using WeightsOf = std::conditional_t<TC, TPWeightsTC, TPWeights>;

template <int SHD, bool TC, int CM = TM>
__host__ __device__ inline auto engine_layout(const Dims& d, const TPTables& T, int RT) {
  static_assert(!TC || CM == TM, "the tensor-core stage takes TM-edge chunks");
  if constexpr (TC)
    return make_layout_tc<SHD>(d, T, RT);
  else
    return make_layout<SHD, CM>(d, T.S, RT);
}

// The block's setup for the tensor-core stage: the ring's barriers, one
// arrival (the loading thread's) per phase, and a copy of the epilogue
// tables, read once per tile in the tile loop.
__device__ void init_tc(float* sm, const LayoutTC& L, const TPTables& T, uint64_t* bar) {
  int* epi = reinterpret_cast<int*>(sm + L.epi);
  for (int i = threadIdx.x; i < T.n_epi * EROW; i += NT) epi[i] = T.epi[i];
  for (int i = threadIdx.x; i <= T.n_tiles; i += NT) epi[T.n_epi * EROW + i] = T.epi_start[i];
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// One block's tile of RT receivers of a kNN group whose senders and
// receivers are one node table [B, N, Din] (the rec and rec_g kernels).
// Candidates are the RT*K neighbour slots in (receiver, k) order; sig [B, Fe]
// is added to the cached edge embedding in the fill. With DM (training), dm
// [B, N, K, hd] is the hidden-layer dropout mask of every neighbour slot, on
// either stage. CM: edges per chunk of the float32 stage (TM_WIDE for layers
// too wide for TM).
template <int SHD, bool DM = false, bool TC = false, int CM = TM, int DI = 3>
__device__ void rec_tile(float* sm, EdgeSlots<CM>& s, const float* __restrict__ node, const float* __restrict__ pos,
                         const int64_t* __restrict__ nbr, const float* __restrict__ emb,
                         const float* __restrict__ sig, const uint8_t* __restrict__ mask, const WeightsOf<TC>& W,
                         const TPTables& T, const Dims& d, int N, int K, int RT, float* __restrict__ out,
                         const float* __restrict__ dm = nullptr, int hd = 0, uint64_t* bar = nullptr) {
  const auto L = engine_layout<SHD, TC, CM>(d, T, RT);
  uint32_t tiles = 0;
  if constexpr (TC) init_tc(sm, L, T, bar);
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
    if constexpr (TC && DM)
      run_engine_tc<SHD, true, DI>(sm, L, d, W, T, s, s.recv, s.send, sig + (size_t)b * d.Fe, 1.f, bar, tiles,
                               dm + (row0 + i0) * K * hd, hd);
    else if constexpr (TC)
      run_engine_tc<SHD, false, DI>(sm, L, d, W, T, s, s.recv, s.send, sig + (size_t)b * d.Fe, 1.f, bar, tiles);
    else if constexpr (DM)
      run_engine<SHD, true, CM>(sm, L, d, W, T, s, s.recv, s.send, sig + (size_t)b * d.Fe, 1.f,
                                dm + (row0 + i0) * K * hd, hd);
    else
      run_engine<SHD, false, CM>(sm, L, d, W, T, s, s.recv, s.send, sig + (size_t)b * d.Fe, 1.f);
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
// those sums' order varies from run to run (a few float32 ulps). CM as in
// rec_tile.
template <int SHD, bool TC = false, int CM = TM, int DI = 3>
__device__ void cross_tile(float* sm, EdgeSlots<CM>& s, const float* __restrict__ lig, const float* __restrict__ lpos,
                           const float* __restrict__ rec, const float* __restrict__ rpos,
                           const int64_t* __restrict__ idx, const float* __restrict__ emb,
                           const uint8_t* __restrict__ mask, const WeightsOf<TC>& Wf, const WeightsOf<TC>& Wr,
                           int with_rev, const TPTables& T, const Dims& d, int L, int N, int K, int RT,
                           float* __restrict__ out_lig, float* __restrict__ out_rec, uint64_t* bar = nullptr) {
  const auto Ly = engine_layout<SHD, TC, CM>(d, T, RT);
  uint32_t tiles = 0;
  if constexpr (TC) init_tc(sm, Ly, T, bar);
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
    if constexpr (TC) {
      // One call site for both directions: two inlined copies of the stage
      // hold too many registers at once and spill.
      for (int rev = 0; rev <= (with_rev != 0); ++rev) {
        const TPWeightsTC W = rev ? Wr : Wf;
        run_engine_tc<SHD, false, DI>(sm, Ly, d, W, T, s, rev ? s.send : s.recv, rev ? s.recv : s.send, nullptr,
                           rev ? -1.f : 1.f, bar, tiles);
        if (!rev) {
          reduce_to_tile(sm, Ly, d, s);
        } else {
          const float* msg = sm + Ly.msg;
          for (int i = threadIdx.x; i < s.count * d.Dout; i += NT) {
            const int m = i / d.Dout, o = i % d.Dout;
            atomicAdd(out_rec + (rrow0 + s.dst[m]) * d.Dout + o, msg[m * Ly.ldm + o]);
          }
        }
        __syncthreads();
      }
    } else {
      run_engine<SHD, false, CM>(sm, Ly, d, Wf, T, s, s.recv, s.send, nullptr, 1.f);
      reduce_to_tile(sm, Ly, d, s);
      __syncthreads();
      if (with_rev) {
        run_engine<SHD, false, CM>(sm, Ly, d, Wr, T, s, s.send, s.recv, nullptr, -1.f);
        const float* msg = sm + Ly.msg;
        for (int i = threadIdx.x; i < s.count * d.Dout; i += NT) {
          const int m = i / d.Dout, o = i % d.Dout;
          atomicAdd(out_rec + (rrow0 + s.dst[m]) * d.Dout + o, msg[m * Ly.ldm + o]);
        }
        __syncthreads();
      }
    }
  }
  for (int i = threadIdx.x; i < nrecv * d.Dout; i += NT) out_lig[(lrow0 + l0) * d.Dout + i] = outs[i];
}

// Edge-list fill: the MLP input (all F columns), sender features and
// harmonics (SHD given components) of each kept slot, read from per-edge
// rows; edge e = the slot's candidate number past the block's first edge.
template <int SHD, int CM>
__device__ void fill_given(float* sm, const Layout& L, const Dims& d, const EdgeSlots<CM>& s,
                           const float* __restrict__ attr, const float* __restrict__ send,
                           const float* __restrict__ shin) {
  float* z = sm + L.z;
  float* xs = sm + L.xs;
  float* sh = sm + L.sh;
  for (int i = threadIdx.x; i < CM * d.F; i += NT) {
    const int m = i / d.F, f = i % d.F;
    z[m * L.ldz + f] = (m < s.count) ? attr[(size_t)s.cand[m] * d.F + f] : 0.f;
  }
  for (int i = threadIdx.x; i < CM * d.Din; i += NT) {
    const int m = i / d.Din, a = i % d.Din;
    xs[m * L.ldx + a] = (m < s.count) ? send[(size_t)s.cand[m] * d.Din + a] : 0.f;
  }
  for (int i = threadIdx.x; i < CM * SHD; i += NT) {
    const int m = i / SHD, b = i % SHD;
    sh[m * L.ldsh + b] = (m < s.count) ? shin[(size_t)s.cand[m] * SHD + b] : 0.f;
  }
}

// One block's RT rows of a pre-gathered edge list [M, K, *] (the edge-list
// kernel): attr [M, K, F], send [M, K, Din], harmonics [M, K, SHD], mask
// [M, K]; with DM the hidden-layer dropout mask dm [M, K, hd]. Candidates are
// the RT*K edges of the rows in order. sum_k: the rows' message sums
// [M, Dout]; otherwise each kept edge's message at out [M, K, Dout] (the
// caller zeroes out, so masked edges read zero). TC: the tensor-core stage
// (one call site, as in rec_tile); CM as in rec_tile.
template <int SHD, bool DM, bool TC = false, int CM = TM, int DI = 3>
__device__ void edge_tile(float* sm, EdgeSlots<CM>& s, const float* __restrict__ attr, const float* __restrict__ send,
                          const float* __restrict__ shin, const uint8_t* __restrict__ mask,
                          const float* __restrict__ dm, int hd, const WeightsOf<TC>& W, const TPTables& T,
                          const Dims& d, int M, int K, int RT, int sum_k, float* __restrict__ out,
                          uint64_t* bar = nullptr) {
  const auto L = engine_layout<SHD, TC, CM>(d, T, RT);
  uint32_t tiles = 0;
  if constexpr (TC) init_tc(sm, L, T, bar);
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
    if constexpr (TC) {
      if constexpr (DM)
        engine_tc_stages<SHD, true, DI>(sm, L, d, W, T, s, bar, tiles, dm + e0 * hd, hd);
      else
        engine_tc_stages<SHD, false, DI>(sm, L, d, W, T, s, bar, tiles);
    } else {
      __syncthreads();
      if constexpr (DM)
        hidden_layer_dm<CM>(sm, L, d, W, s, dm + e0 * hd, hd);
      else
        hidden_layer<CM>(sm, L, d, W);
      contributions<CM>(sm, L, T);
      __syncthreads();
      weighted_tp<CM>(sm, L, d, W, T);
    }
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

// Launch kernel k on grid x NT threads with smem bytes of dynamic shared
// memory (raised past 48 KB first). Returns a CUDA error code: a launch the
// card refuses (too much shared memory) returns it here, never runs.
template <class Kernel, class... Args>
int launch(Kernel k, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int SHD>
inline long long layout_bytes(int tc, int cm, const Dims& d, const TPTables& T, int RT) {
  if (tc) return cm == TM ? (long long)smem_bytes(make_layout_tc<SHD>(d, T, RT)) : -1;
  if (cm == TM) return (long long)smem_bytes(make_layout<SHD, TM>(d, T.S, RT));
  if (cm == TM_WIDE) return (long long)smem_bytes(make_layout<SHD, TM_WIDE>(d, T.S, RT));
  return -1;
}

// Static shared memory, in bytes, of the kernels of one build
// (cudaFuncGetAttributes): the value all of them have, or -2 where they
// differ or a query fails. Each library's cbt_static_smem_bytes returns it,
// -1 for a build the library does not have; the host mirror is
// ops/cuda/tpconv_common.engine_static_bytes.
template <class Kernel, class... More>
long long static_bytes(Kernel k, More... more) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, k) != cudaSuccess) return -2;
  if constexpr (sizeof...(more) > 0) {
    if (static_bytes(more...) != (long long)a.sharedSizeBytes) return -2;
  }
  return (long long)a.sharedSizeBytes;
}

}  // namespace cbt

extern "C" const char* cbt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The dynamic shared memory, in bytes, of one block of this library's
// kernels at a layer: the tensor-core stage (tc) or the float32 stage at cm
// edges a chunk (TM or TM_WIDE), shd harmonic components (4, 9, 16 or 20); -1
// for a build that does not exist. The host mirror is
// ops/cuda/tpconv_common.engine_smem_bytes.
extern "C" long long cbt_smem_bytes(int tc, int cm, int shd, int Fe, int ns, int F, int H, int Din, int Dout, int S,
                                    int n_tiles, int n_epi, int n_cg, int RT) {
  const cbt::Dims d{Fe, ns, F, H, Din, Dout};
  const cbt::TPTables T{nullptr, nullptr, nullptr, nullptr, S, n_tiles, 0, n_epi, n_cg};
  switch (shd) {
    case 4:
      return cbt::layout_bytes<4>(tc, cm, d, T, RT);
    case 9:
      return cbt::layout_bytes<9>(tc, cm, d, T, RT);
    case 16:
      return cbt::layout_bytes<16>(tc, cm, d, T, RT);
    case 20:
      return cbt::layout_bytes<20>(tc, cm, d, T, RT);
    default:
      return -1;
  }
}
