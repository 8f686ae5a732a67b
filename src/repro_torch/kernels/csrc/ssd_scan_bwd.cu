// Backward of the Mamba2 SSD scan from a zero state with the final state
// dropped (the training path), for Hopper (sm_90a), bound through a plain
// C interface.  bf16 x, dy, B, C and dx, dB, dC; fp32 dt, A_log, D and
// ddt, dA_log, dD.
//
// Replaces: the backward of src/repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel, pallas_call at line 74).  The Pallas kernel has no
// backward of its own (JAX differentiates the plain jnp scan,
// src/repro/models/mamba2.py::ssd_chunked); this is the gradient of
// csrc/ssd_scan.cu's state-in-None form, chunk by chunk.  Per (batch row,
// head) and chunk, with la the within-chunk cumsum of dt * A (A =
// -exp(A_log)), G_t = exp(la_t), wv_u = exp(la_end - la_u) dt_u, decay_tu =
// exp(la_t - la_u) (u <= t, selected before exp), cb = C B^T, M = dy x^T
// (over the head dim p), S the state entering the chunk and dS the
// gradient of the state leaving it:
//   dx_u   = sum_t cb_tu decay_tu dt_u dy_t + D dy_u + wv_u dS B_u
//   dC_t  += sum_u M_tu decay_tu dt_u B_u + G_t dy_t^T S      (over heads)
//   dB_u  += sum_t M_tu decay_tu dt_u C_t + wv_u x_u^T dS     (over heads)
// and through la, with Q = cb decay M, P_tu = Q_tu dt_u, r_u = x_u^T dS B_u
// and c_t = G_t dy_t^T S C_t:
//   d la_t = sum_u P_tu - sum_u P_ut + c_t - wv_t r_t, and at the chunk's
//            end exp(la_end) <dS, S> + sum_u wv_u r_u more;
//   ddt_u  = sum_t Q_tu + exp(la_end - la_u) r_u + A sum_{t>=u} d la_t;
//   dA    += sum_u dt_u sum_{t>=u} d la_t;  dA_log = A dA;  dD = sum dy x.
// The states link the chunks, and only linearly:
//   S_0 = 0,  S_{c+1} = exp(la_end_c) S_c + Delta_c,
//   Delta_c = sum_u (x_u wv_u) B_u^T;
//   dS_{nc-1} = 0,  dS_{c-1} = exp(la_end_c) dS_c + Gamma_c,
//   Gamma_c = sum_t (dy_t G_t) C_t^T.
// (kernels/ref.py::ssd_bwd_ref is the same algebra in plain torch.)
//
// The design: chunk-parallel, every product on bf16 tensor cores.  One C
// entry, four kernels:
//   1. ssd_bwd_chunk_kernel, a block per (chunk, head group, batch row):
//      Delta_c and Gamma_c of each head, written to two fp32 [b, nh, nc,
//      64, 64] scratch tensors, and la_end;
//   2. ssd_bwd_pass_kernel, a thread per 4 state elements of a (batch row,
//      head): the two recurrences above, 32 steps each at the training
//      shape, in fp32, overwriting Delta_c with S_c and Gamma_c with dS_c;
//   3. ssd_bwd_grad_kernel, a block per (chunk, head group, batch row):
//      with S_c and dS_c every gradient of the chunk is local.  The heads
//      of a block share the chunk's B and C tiles and sum their dB and dC
//      in registers, so the fp32 partial rows ([b, groups, s, 128]) are
//      fewer by the heads a block takes (ops.ssd_bwd_plan, plain Python);
//   4. ssd_bwd_reduce_kernel: the groups' partial rows summed in group
//      order, dA_log and dD over (batch row, chunk) in order: bitwise
//      deterministic, no float atomics.
// Products are mma.sync m16n8k16 with fp32 accumulation: C.B^T and dy.x^T
// have two bf16 operands; every other product has one fp32 operand (W, Z,
// S, dS, x wv, dy G), split into a bf16 hi and lo part and multiplied
// twice (relative error 2^-17, as in csrc/ssd_scan.cu), the other operand
// exactly bf16.  A block is 4 warps of 16 rows of each 64 x 64 product;
// tiles of x, dy, B and C come in with cp.async, rows padded by 16 bytes
// so that ldmatrix reads distinct banks.  A ragged last chunk is
// zero-filled: its missing positions have dt = 0 and zero x, dy, B, C,
// which add nothing and leave la flat.
//
// What bounds it on the H100, at the training shape (b = 1, s = 2048, 112
// heads of 64, chunk 64): the function's own bytes (x, dy and dx in bf16,
// 88 MB, with dt, ddt, B, C, dB, dC: 91 MB) are 0.027 ms at 3.35 TB/s; its
// products, 14 GFLOP of causal halves and full 64^3 products, 0.014 ms at
// the bf16 peak, and 28 GFLOP as run here (64 x 64 tiles, the causal ones
// in blocks of 16, the hi/lo splits), 0.028 ms.  This design's own floor
// is its scratch: Delta/S and Gamma/dS each written by kernel 1, read and
// written by kernel 2, read by kernel 3 (470 MB), x and dy read twice
// (59 MB) and the partial rows written and read (29 MB at 8 heads a
// block): 649 MB in all, 0.19 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kN = 64;           // head dim = state dim = longest chunk
constexpr int kLd = kN + 8;      // bf16 tile pitch
constexpr int kTile = kN * kLd;  // bf16 per tile
constexpr int kThreads = 128;    // 4 warps of 16 rows
constexpr int kMaxHeads = 8;     // heads a block takes at most
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 8;    // chunks whose loads are in flight at once
constexpr int kRedThreads = 256;

// kernel 3's shared memory: 10 bf16 tiles, then fp32 vectors
constexpr int kGradTiles = 10;
constexpr int kGradFloats = 2 * kMaxHeads * kN + 7 * kN + 4 * kN + 8;
constexpr int kGradSmem = kGradTiles * kTile * 2 + kGradFloats * 4;

struct Args {
  const bf16* x;       // [b, s, nh, 64] contiguous
  const float* dt;     // [b, s, nh] contiguous
  const float* A_log;  // [nh]
  const bf16* B;       // [b, s, 64], strides b_sb, b_ss
  const bf16* C;
  const float* D;      // [nh]
  const bf16* dy;      // as x
  bf16* dx;            // as x
  float* ddt;          // as dt
  float* dA_log;       // [nh]
  bf16* dB;            // [b, s, 64] contiguous
  bf16* dC;
  float* dD;           // [nh]
  float* st;           // [b, nh, nc, 64, 64]: Delta_c, then S_c
  float* dst;          // the same: Gamma_c, then dS_c
  float* lae;          // [b, nh, nc]: la_end of each chunk
  float* part;         // [b, groups, s, 128]: dB | dC of each head group
  float* part_ad;      // [2, b, nc, nh]: dA, dD of each (row, chunk, head)
  int b, s, nh, chunk, nc, heads, groups;
  long long b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (v0, v1) = hi + lo, each a packed bf16 pair: hi rounds v, lo rounds the
// remainder
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi,
                                       unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// Fragment loads from a bf16 tile of pitch kLd.  The A operand (16 x 16)
// of rows m0.., k0..: from an [m][k] tile, or (lda_t) from a [k][m] tile,
// which multiplies its transpose.  The B operands of the two n8 tiles n0
// and n0 + 8 over k0..k0 + 15 (b[0..1] and b[2..3]): from an [n][k] tile,
// or (ldb_kn) from a [k][n] tile.
__device__ __forceinline__ void lda(unsigned* a, const bf16* t, int m0,
                                    int k0, int lane) {
  ldsm_x4(a, t + (m0 + lane % 16) * kLd + k0 + (lane / 16) * 8);
}

__device__ __forceinline__ void lda_t(unsigned* a, const bf16* t, int m0,
                                      int k0, int lane) {
  ldsm_x4_trans(a, t + (k0 + (lane / 16) * 8 + lane % 8) * kLd + m0 +
                       ((lane / 8) % 2) * 8);
}

__device__ __forceinline__ void ldb_nk(unsigned* b, const bf16* t, int n0,
                                       int k0, int lane) {
  ldsm_x4(b, t + (n0 + lane % 8 + (lane / 16) * 8) * kLd + k0 +
                 ((lane / 8) % 2) * 8);
}

__device__ __forceinline__ void ldb_kn(unsigned* b, const bf16* t, int n0,
                                       int k0, int lane) {
  ldsm_x4_trans(b, t + (k0 + lane % 16) * kLd + n0 + (lane / 16) * 8);
}

__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// acc (this warp's 16 rows m0.. of a 64 x 64 product; n8 tiles j < n_hi)
// += A B over the k tiles k_lo <= kk < k_hi.  A from a_hi (and a_lo: the
// lo part of an fp32 operand, multiplied too), an [m][k] tile, or [k][m]
// with AT; B from b_hi (and b_lo), an [n][k] tile, or [k][n] with BKN.
// At most one of a_lo and b_lo is given.
template <bool AT, bool BKN>
__device__ __forceinline__ void mm(float (*acc)[4], const bf16* a_hi,
                                   const bf16* a_lo, const bf16* b_hi,
                                   const bf16* b_lo, int m0, int k_lo,
                                   int k_hi, int n_hi, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < k_lo || kk >= k_hi) continue;
    unsigned ah[4], al[4];
    if (AT) {
      lda_t(ah, a_hi, m0, 16 * kk, lane);
      if (a_lo) lda_t(al, a_lo, m0, 16 * kk, lane);
    } else {
      lda(ah, a_hi, m0, 16 * kk, lane);
      if (a_lo) lda(al, a_lo, m0, 16 * kk, lane);
    }
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      if (j >= n_hi) continue;
      unsigned bh[4];
      if (BKN)
        ldb_kn(bh, b_hi, 8 * j, 16 * kk, lane);
      else
        ldb_nk(bh, b_hi, 8 * j, 16 * kk, lane);
      mma16816(acc[j], ah, bh);
      mma16816(acc[j + 1], ah, bh + 2);
      if (a_lo) {
        mma16816(acc[j], al, bh);
        mma16816(acc[j + 1], al, bh + 2);
      }
      if (b_lo) {
        unsigned bl[4];
        if (BKN)
          ldb_kn(bl, b_lo, 8 * j, 16 * kk, lane);
        else
          ldb_nk(bl, b_lo, 8 * j, 16 * kk, lane);
        mma16816(acc[j], ah, bl);
        mma16816(acc[j + 1], ah, bl + 2);
      }
    }
  }
}

// rows t0.. of a [b, s, 64]-like bf16 tensor (row stride rs) into a tile,
// zero past len
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int len, int tid) {
  for (int i = tid; i < kN * 8; i += kThreads) {
    const int r = i / 8, c = (i % 8) * 8;
    const bool ok = r < len;
    cp_async16(dst + r * kLd + c, ok ? src + r * rs + c : src, ok);
  }
}

// The chunk's la (inclusive cumsum of dt A; not kept where la is null),
// exp(la), exp(la_end - la) (where eo is given) and wv = exp(la_end - la)
// dt, by one warp (a lane per positions lane and lane + 32); returns
// la_end.  dt = 0 past the chunk's end.
__device__ __forceinline__ float chunk_vectors(const float* dtv, float A,
                                               float* la, float* gv,
                                               float* eo, float* wv,
                                               int lane) {
  const float d0 = dtv[lane], d1 = dtv[lane + 32];
  float v0 = d0 * A, v1 = d1 * A;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
    const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
    if (lane >= off) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  const float la_end = __shfl_sync(0xffffffffu, v1, 31);
  if (la) {
    la[lane] = v0;
    la[lane + 32] = v1;
  }
  gv[lane] = expf(v0);
  gv[lane + 32] = expf(v1);
  const float e0 = expf(la_end - v0), e1 = expf(la_end - v1);  // <= 1
  if (eo) {
    eo[lane] = e0;
    eo[lane + 32] = e1;
  }
  wv[lane] = e0 * d0;
  wv[lane + 32] = e1 * d1;
  return la_end;
}

// dt of the block's heads over the chunk's positions into dts[head][t]
__device__ __forceinline__ void load_dt(const Args& a, float* dts, int bb,
                                        int t0, int len, int h0, int nhd,
                                        int tid) {
  for (int i = tid; i < kMaxHeads * kN; i += kThreads) {
    const int t = i / kMaxHeads, hh = i % kMaxHeads;
    dts[hh * kN + t] = t < len && hh < nhd
                           ? a.dt[((size_t)bb * a.s + t0 + t) * a.nh + h0 + hh]
                           : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// 1. Per chunk and head: Delta_c [p][n] = sum_u (x_u[p] wv_u) B_u[n] and
//    Gamma_c [p][n] = sum_t (dy_t[p] G_t) C_t[n], and la_end.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_kernel(
    const Args a) {
  __shared__ __align__(128) bf16 xs[kTile];
  __shared__ __align__(128) bf16 ys[kTile];
  __shared__ __align__(128) bf16 bs[kTile];
  __shared__ __align__(128) bf16 cs[kTile];
  __shared__ float dts[kMaxHeads * kN];
  __shared__ float gv[kN], wv[kN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int c = blockIdx.x, grp = blockIdx.y, bb = blockIdx.z;
  const int t0 = c * a.chunk, len = min(a.chunk, a.s - t0);
  const int h0 = grp * a.heads, nhd = min(a.heads, a.nh - h0);
  const long long xrow = (long long)a.nh * kN;  // x's and dy's row stride
  const int m0 = 16 * warp;                     // this warp's rows p

  load_tile(bs, a.B + bb * a.b_sb + t0 * a.b_ss, a.b_ss, len, tid);
  load_tile(cs, a.C + bb * a.c_sb + t0 * a.c_ss, a.c_ss, len, tid);
  load_dt(a, dts, bb, t0, len, h0, nhd, tid);

  for (int hh = 0; hh < nhd; ++hh) {
    const int h = h0 + hh;
    const bf16* xb = a.x + ((size_t)bb * a.s + t0) * xrow + (size_t)h * kN;
    const bf16* yb = a.dy + ((size_t)bb * a.s + t0) * xrow + (size_t)h * kN;
    load_tile(xs, xb, xrow, len, tid);
    load_tile(ys, yb, xrow, len, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the tiles, dt (and, first, B and C) are in
    if (warp == 0) {
      const float la_end =
          chunk_vectors(dts + hh * kN, -expf(a.A_log[h]), nullptr, gv,
                        nullptr, wv, lane);
      if (lane == 0)
        a.lae[((size_t)bb * a.nh + h) * a.nc + c] = la_end;
    }
    __syncthreads();  // the vectors are in

    const size_t out = (((size_t)bb * a.nh + h) * a.nc + c) * kN * kN;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      // A = (x wv)^T or (dy G)^T from the [u][p] tile, hi/lo; B = B or C
      const bf16* src = which ? ys : xs;
      const float* scale = which ? gv : wv;
      const bf16* bt = which ? cs : bs;
      float acc[8][4];
      zero(acc);
#pragma unroll
      for (int ku = 0; ku < 4; ++ku) {
        if (ku * 16 >= len) continue;  // zero-filled positions add nothing
        unsigned xa[4], ahi[4], alo[4];
        lda_t(xa, src, m0, 16 * ku, lane);
        const float2 w01 =
            *reinterpret_cast<const float2*>(scale + ku * 16 + 2 * tq);
        const float2 w89 =
            *reinterpret_cast<const float2*>(scale + ku * 16 + 8 + 2 * tq);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 xv = unpack(xa[r]);
          // a0, a1: k = 2tq; a2, a3: 8 + 2tq
          const float2 wp = r < 2 ? w01 : w89;
          split2(xv.x * wp.x, xv.y * wp.y, ahi[r], alo[r]);
        }
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          unsigned bf[4];
          ldb_kn(bf, bt, 8 * j, 16 * ku, lane);
          mma16816(acc[j], ahi, bf);
          mma16816(acc[j], alo, bf);
          mma16816(acc[j + 1], ahi, bf + 2);
          mma16816(acc[j + 1], alo, bf + 2);
        }
      }
      float* dst = (which ? a.dst : a.st) + out;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          *reinterpret_cast<float2*>(dst + (m0 + g + 8 * e2) * kN + 8 * j +
                                     2 * tq) =
              make_float2(acc[j][2 * e2], acc[j][2 * e2 + 1]);
    }
    __syncthreads();  // every warp is done with this head's tiles
  }
}

// ---------------------------------------------------------------------------
// 2. The recurrences, a thread per 4 state elements of a (batch row, head):
//    forwards S, backwards dS, each in place over its increments.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads) ssd_bwd_pass_kernel(
    const Args a) {
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  const int h = blockIdx.y, bb = blockIdx.z, nc = a.nc;
  const size_t base = ((size_t)bb * a.nh + h) * nc * kN * kN + e;
  const float* lae = a.lae + ((size_t)bb * a.nh + h) * nc;
  float4 S = make_float4(0.0f, 0.0f, 0.0f, 0.0f), dS = S;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float4 inc[kPassBatch], ginc[kPassBatch];
    float ge[kPassBatch], gb[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int cf = c0 + k, cb = nc - 1 - cf;  // forwards, backwards
      if (cf < nc) {
        inc[k] = *reinterpret_cast<const float4*>(a.st + base +
                                                  (size_t)cf * kN * kN);
        ginc[k] = *reinterpret_cast<const float4*>(a.dst + base +
                                                   (size_t)cb * kN * kN);
        ge[k] = expf(lae[cf]);
        gb[k] = expf(lae[cb]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int cf = c0 + k, cb = nc - 1 - cf;
      if (cf >= nc) break;
      *reinterpret_cast<float4*>(a.st + base + (size_t)cf * kN * kN) = S;
      S.x = S.x * ge[k] + inc[k].x;
      S.y = S.y * ge[k] + inc[k].y;
      S.z = S.z * ge[k] + inc[k].z;
      S.w = S.w * ge[k] + inc[k].w;
      *reinterpret_cast<float4*>(a.dst + base + (size_t)cb * kN * kN) = dS;
      dS.x = dS.x * gb[k] + ginc[k].x;
      dS.y = dS.y * gb[k] + ginc[k].y;
      dS.z = dS.z * gb[k] + ginc[k].z;
      dS.w = dS.w * gb[k] + ginc[k].w;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. Per chunk and head, with S and dS: every gradient of the chunk.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_grad_kernel(
    const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);  // B [u][n]
  bf16* cs = bs + kTile;                         // C [t][n]
  bf16* xs = cs + kTile;                         // x [u][p]
  bf16* ys = xs + kTile;                         // dy [t][p]
  bf16* shi = ys + kTile;   // S [p][n] hi and lo; then W [t][u]
  bf16* slo = shi + kTile;
  bf16* dhi = slo + kTile;  // dS [p][n] hi and lo
  bf16* dlo = dhi + kTile;
  bf16* zhi = dlo + kTile;  // Z [t][u] hi and lo
  bf16* zlo = zhi + kTile;
  float* dts = reinterpret_cast<float*>(zlo + kTile);  // [head][t]
  float* ddts = dts + kMaxHeads * kN;                  // [t][head]
  float* la = ddts + kMaxHeads * kN;
  float* gv = la + kN;    // exp(la)
  float* eo = gv + kN;    // exp(la_end - la)
  float* wv = eo + kN;    // eo dt
  float* rowp = wv + kN;  // sum_u P_tu
  float* cv = rowp + kN;  // c_t
  float* rv = cv + kN;    // r_u
  float* colq = rv + kN;  // [warp][u]: sum_t Q_tu over the warp's t
  float* red = colq + 4 * kN;  // [warp]: <dS, S>; [4 + warp]: dD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int c = blockIdx.x, grp = blockIdx.y, bb = blockIdx.z;
  const int t0 = c * a.chunk, len = min(a.chunk, a.s - t0);
  const int h0 = grp * a.heads, nhd = min(a.heads, a.nh - h0);
  const long long xrow = (long long)a.nh * kN;
  const int m0 = 16 * warp;       // this warp's rows t (or u)
  const int n_own = 2 * warp + 2;  // n8 tiles of u <= t for rows t

  load_tile(bs, a.B + bb * a.b_sb + t0 * a.b_ss, a.b_ss, len, tid);
  load_tile(cs, a.C + bb * a.c_sb + t0 * a.c_ss, a.c_ss, len, tid);
  load_dt(a, dts, bb, t0, len, h0, nhd, tid);

  float dBacc[8][4], dCacc[8][4];  // summed over the block's heads
  zero(dBacc);
  zero(dCacc);

  for (int hh = 0; hh < nhd; ++hh) {
    const int h = h0 + hh;
    const float A = -expf(a.A_log[h]);
    const float Dh = a.D[h];
    const bf16* xb = a.x + ((size_t)bb * a.s + t0) * xrow + (size_t)h * kN;
    const bf16* yb = a.dy + ((size_t)bb * a.s + t0) * xrow + (size_t)h * kN;
    load_tile(xs, xb, xrow, len, tid);
    load_tile(ys, yb, xrow, len, tid);
    cp_async_commit();
    const size_t sm = (((size_t)bb * a.nh + h) * a.nc + c) * kN * kN;
    // S and dS (fp32, 16 KB each): every load in flight at once, then
    // each split into its hi and lo tiles
    constexpr int kPer = kN * kN / 4 / kThreads;  // float4s a thread
    float4 sv[kPer], dv[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      sv[k] = *reinterpret_cast<const float4*>(a.st + sm + 4 * i);
      dv[k] = *reinterpret_cast<const float4*>(a.dst + sm + 4 * i);
    }
    float inner = 0.0f;  // this thread's part of <dS, S>
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      const float4 v = sv[k], d = dv[k];
      inner += v.x * d.x + v.y * d.y + v.z * d.z + v.w * d.w;
      const int r = (4 * i) / kN, col = (4 * i) % kN;
      unsigned h0v, l0v, h1v, l1v;
      split2(v.x, v.y, h0v, l0v);
      split2(v.z, v.w, h1v, l1v);
      *reinterpret_cast<uint2*>(shi + r * kLd + col) = make_uint2(h0v, h1v);
      *reinterpret_cast<uint2*>(slo + r * kLd + col) = make_uint2(l0v, l1v);
      split2(d.x, d.y, h0v, l0v);
      split2(d.z, d.w, h1v, l1v);
      *reinterpret_cast<uint2*>(dhi + r * kLd + col) = make_uint2(h0v, h1v);
      *reinterpret_cast<uint2*>(dlo + r * kLd + col) = make_uint2(l0v, l1v);
    }
    cp_async_wait_all();
    __syncthreads();  // tiles, S, dS (and, first, B, C and dt) are in
    if (warp == 0)
      chunk_vectors(dts + hh * kN, A, la, gv, eo, wv, lane);
    __syncthreads();  // the vectors are in

    // ---- rows t: cb and M, then W = cb decay dt_u, Z = M decay dt_u and
    // Q = cb decay M (0 for u > t) in registers; P's row sums, Q's column
    // sums
    float W[8][4], Z[8][4];
    zero(W);
    zero(Z);
    mm<false, false>(W, cs, nullptr, bs, nullptr, m0, 0, 4, n_own, lane);
    mm<false, false>(Z, ys, nullptr, xs, nullptr, m0, 0, 4, n_own, lane);
    float rp[2] = {0.0f, 0.0f};
    float la_r[2] = {la[m0 + g], la[m0 + g + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float cq[2] = {0.0f, 0.0f};
      if (j < n_own) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = m0 + g + 8 * (e / 2);
          const int u = 8 * j + 2 * tq + (e & 1);
          float w = 0.0f, z = 0.0f, q = 0.0f;
          if (u <= t) {  // select, then exp: for u > t it may overflow
            const float dec = expf(la_r[e / 2] - la[u]);
            const float du = dts[hh * kN + u];
            q = W[j][e] * dec * Z[j][e];
            w = W[j][e] * dec * du;
            z = Z[j][e] * dec * du;
            rp[e / 2] += q * du;
          }
          W[j][e] = w;
          Z[j][e] = z;
          cq[e & 1] += q;
        }
      }
      // Q's column sums over the warp's 16 rows t (lanes of one tq)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float v = cq[k];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) colq[warp * kN + 8 * j + 2 * tq + k] = v;
      }
    }

    // dC += Z B (Z from registers, split) + G_t (dy S); c_t
    float tmp[8][4];
#pragma unroll
    for (int ku = 0; ku < 4; ++ku) {
      if (ku > warp) continue;  // u > t for every row of the warp
      unsigned zh[4], zl[4];
      split2(Z[2 * ku][0], Z[2 * ku][1], zh[0], zl[0]);
      split2(Z[2 * ku][2], Z[2 * ku][3], zh[1], zl[1]);
      split2(Z[2 * ku + 1][0], Z[2 * ku + 1][1], zh[2], zl[2]);
      split2(Z[2 * ku + 1][2], Z[2 * ku + 1][3], zh[3], zl[3]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        unsigned bf[4];
        ldb_kn(bf, bs, 8 * j, 16 * ku, lane);
        mma16816(dCacc[j], zh, bf);
        mma16816(dCacc[j], zl, bf);
        mma16816(dCacc[j + 1], zh, bf + 2);
        mma16816(dCacc[j + 1], zl, bf + 2);
      }
    }
    // Z to shared memory as hi/lo [t][u], for dB (u <= t tiles only: the
    // others are never read)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= n_own) continue;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int off = (m0 + g + 8 * e2) * kLd + 8 * j + 2 * tq;
        unsigned hv, lv;
        split2(Z[j][2 * e2], Z[j][2 * e2 + 1], hv, lv);
        *reinterpret_cast<unsigned*>(zhi + off) = hv;
        *reinterpret_cast<unsigned*>(zlo + off) = lv;
      }
    }
    zero(tmp);
    mm<false, true>(tmp, ys, nullptr, shi, slo, m0, 0, 4, 8, lane);
    float cp[2] = {0.0f, 0.0f};
    const float gr[2] = {gv[m0 + g], gv[m0 + g + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int t = m0 + g + 8 * e2, n = 8 * j + 2 * tq;
        const float2 cc =
            unpack(*reinterpret_cast<const unsigned*>(cs + t * kLd + n));
        cp[e2] += tmp[j][2 * e2] * cc.x + tmp[j][2 * e2 + 1] * cc.y;
        dCacc[j][2 * e2] += gr[e2] * tmp[j][2 * e2];
        dCacc[j][2 * e2 + 1] += gr[e2] * tmp[j][2 * e2 + 1];
      }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const float rsum = quad_sum(rp[e2]), csum = quad_sum(cp[e2]);
      if (tq == 0) {
        rowp[m0 + g + 8 * e2] = rsum;
        cv[m0 + g + 8 * e2] = gr[e2] * csum;
      }
    }

    // W to shared memory as hi/lo [t][u], over S: every warp is done with S
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= n_own) continue;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int off = (m0 + g + 8 * e2) * kLd + 8 * j + 2 * tq;
        unsigned hv, lv;
        split2(W[j][2 * e2], W[j][2 * e2 + 1], hv, lv);
        *reinterpret_cast<unsigned*>(shi + off) = hv;
        *reinterpret_cast<unsigned*>(slo + off) = lv;
      }
    }
    __syncthreads();  // W and Z are in

    // ---- rows u: dx = W^T dy + D dy + wv_u (B dS^T); dD
    float dsb[8][4];
    zero(tmp);
    zero(dsb);
    mm<true, true>(tmp, shi, slo, ys, nullptr, m0, warp, 4, 8, lane);
    mm<false, false>(dsb, bs, nullptr, dhi, dlo, m0, 0, 4, 8, lane);
    float dd = 0.0f;
    {
      bf16* dxb = a.dx + ((size_t)bb * a.s + t0) * xrow + (size_t)h * kN;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int u = m0 + g + 8 * e2;
        const float wu = wv[u];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + 2 * tq;
          const float2 yv =
              unpack(*reinterpret_cast<const unsigned*>(ys + u * kLd + p));
          const float2 xv =
              unpack(*reinterpret_cast<const unsigned*>(xs + u * kLd + p));
          dd += yv.x * xv.x + yv.y * xv.y;
          if (u < len)
            *reinterpret_cast<__nv_bfloat162*>(dxb + (size_t)u * xrow + p) =
                __floats2bfloat162_rn(
                    tmp[j][2 * e2] + Dh * yv.x + wu * dsb[j][2 * e2],
                    tmp[j][2 * e2 + 1] + Dh * yv.y + wu * dsb[j][2 * e2 + 1]);
        }
      }
    }

    // ---- rows u: dB += Z^T C + wv_u (x dS); r_u
    mm<true, true>(dBacc, zhi, zlo, cs, nullptr, m0, warp, 4, 8, lane);
    zero(tmp);
    mm<false, true>(tmp, xs, nullptr, dhi, dlo, m0, 0, 4, 8, lane);
    float rr[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int u = m0 + g + 8 * e2;
      const float wu = wv[u];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * tq;
        const float2 bv =
            unpack(*reinterpret_cast<const unsigned*>(bs + u * kLd + n));
        rr[e2] += tmp[j][2 * e2] * bv.x + tmp[j][2 * e2 + 1] * bv.y;
        dBacc[j][2 * e2] += wu * tmp[j][2 * e2];
        dBacc[j][2 * e2 + 1] += wu * tmp[j][2 * e2 + 1];
      }
      const float rsum = quad_sum(rr[e2]);
      if (tq == 0) rv[u] = rsum;
    }
    inner = warp_sum(inner);
    dd = warp_sum(dd);
    if (lane == 0) {
      red[warp] = inner;
      red[4 + warp] = dd;
    }
    __syncthreads();  // rowp, cv, rv, colq and red are in; every warp is
                      // done with this head's tiles

    // ---- d la, its reverse cumsum d a, then ddt, dA and dD (warp 0; a
    // lane per positions lane and lane + 32)
    if (warp == 0) {
      float cq[2], dla[2], wr = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = lane + 32 * k;
        const float colQ = colq[t] + colq[kN + t] + colq[2 * kN + t] +
                           colq[3 * kN + t];
        const float du = dts[hh * kN + t];
        dla[k] = rowp[t] - colQ * du + cv[t] - wv[t] * rv[t];
        wr += wv[t] * rv[t];
        cq[k] = colQ;
      }
      wr = warp_sum(wr);
      const float sd = red[0] + red[1] + red[2] + red[3];
      if (lane == 31) dla[1] += expf(la[kN - 1]) * sd + wr;
      // reverse inclusive scans over positions 32..63, then 0..31
      float v0 = dla[0], v1 = dla[1];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float u0 = __shfl_down_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_down_sync(0xffffffffu, v1, off);
        if (lane + off < 32) {
          v0 += u0;
          v1 += u1;
        }
      }
      v0 += __shfl_sync(0xffffffffu, v1, 0);
      float dA = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = lane + 32 * k;
        const float run = k ? v1 : v0;
        ddts[t * kMaxHeads + hh] = cq[k] + eo[t] * rv[t] + A * run;
        dA += dts[hh * kN + t] * run;
      }
      dA = warp_sum(dA);
      if (lane == 0) {
        const size_t i = ((size_t)bb * a.nc + c) * a.nh + h;
        a.part_ad[i] = dA;
        a.part_ad[(size_t)a.b * a.nc * a.nh + i] =
            red[4] + red[5] + red[6] + red[7];
      }
    }
  }
  __syncthreads();  // ddts is complete

  for (int i = tid; i < len * nhd; i += kThreads) {
    const int t = i / nhd, hh = i % nhd;
    a.ddt[((size_t)bb * a.s + t0 + t) * a.nh + h0 + hh] =
        ddts[t * kMaxHeads + hh];
  }
  // this head group's partial rows of dB (columns 0-63) and dC (64-127)
  float* prow = a.part + ((size_t)bb * a.groups + grp) * a.s * 2 * kN;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int r = m0 + g + 8 * e2;
    if (r >= len) continue;
    float* pr = prow + (size_t)(t0 + r) * 2 * kN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(pr + n) =
          make_float2(dBacc[j][2 * e2], dBacc[j][2 * e2 + 1]);
      *reinterpret_cast<float2*>(pr + kN + n) =
          make_float2(dCacc[j][2 * e2], dCacc[j][2 * e2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dB and dC: the head groups' partial rows summed in group order; dA_log
//    and dD: the (batch row, chunk) partials summed in that order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRedThreads) ssd_bwd_reduce_kernel(
    const Args a) {
  const long long i = (long long)blockIdx.x * kRedThreads + threadIdx.x;
  const long long per_row = (long long)a.s * 2 * kN;
  if (i < (long long)a.b * per_row) {
    const int bb = (int)(i / per_row);
    const long long rem = i % per_row;  // t * 128 + column
    const float* p = a.part + (size_t)bb * a.groups * per_row + rem;
    float sum = 0.0f;
#pragma unroll 4
    for (int gi = 0; gi < a.groups; ++gi) sum += p[(size_t)gi * per_row];
    const long long t = rem / (2 * kN);
    const int col = (int)(rem % (2 * kN));
    bf16* out = col < kN ? a.dB : a.dC;
    out[((size_t)bb * a.s + t) * kN + col % kN] = __float2bfloat16(sum);
  }
  if (blockIdx.x == 0) {
    const size_t half = (size_t)a.b * a.nc * a.nh;
    for (int h = threadIdx.x; h < a.nh; h += kRedThreads) {
      float dA = 0.0f, dD = 0.0f;
      for (int k = 0; k < a.b * a.nc; ++k) {
        dA += a.part_ad[(size_t)k * a.nh + h];
        dD += a.part_ad[half + (size_t)k * a.nh + h];
      }
      a.dA_log[h] = -expf(a.A_log[h]) * dA;
      a.dD[h] = dD;
    }
  }
}

}  // namespace

// x, dy [b, s, nh, 64] bf16 contiguous, dt [b, s, nh] fp32 contiguous;
// B/C [b, s, 64] bf16 with the given strides of b and s (unit stride along
// the last dim, 16-byte-aligned rows); A_log, D [nh] fp32.  Outputs: dx as
// x, ddt as dt, dB/dC [b, s, 64] bf16 contiguous, dA_log/dD [nh] fp32.
// Scratch (fp32): st and dst b * nh * nc * 64 * 64 each (nc = ceil(s /
// chunk)), lae b * nh * nc, part b * ceil(nh / heads) * s * 128, part_ad
// 2 * b * nc * nh.  hd = ds = 64, 1 <= chunk <= 64, 1 <= heads <= 8 (the
// heads a block takes, ops.ssd_bwd_plan).  Four launches: the chunks'
// increments, the recurrences, the chunks' gradients, the fixed-order sums.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_ssd_scan_bwd_bf16(
    const void* x, const void* dt, const void* A_log, const void* B,
    const void* C, const void* D, const void* dy, void* dx, void* ddt,
    void* dA_log, void* dB, void* dC, void* dD, void* st, void* dst,
    void* lae, void* part, void* part_ad, int b, int s, int nh, int hd,
    int ds, int chunk, int heads, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || nh > 65535 || b > 65535 || hd != kN ||
      ds != kN ||
      chunk < 1 || chunk > kN || heads < 1 || heads > kMaxHeads)
    return cudaErrorInvalidValue;
  const int nc = (s + chunk - 1) / chunk;
  const int groups = (nh + heads - 1) / heads;
  if (groups > 65535) return cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
         static_cast<const float*>(A_log), static_cast<const bf16*>(B),
         static_cast<const bf16*>(C), static_cast<const float*>(D),
         static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
         static_cast<float*>(ddt), static_cast<float*>(dA_log),
         static_cast<bf16*>(dB), static_cast<bf16*>(dC),
         static_cast<float*>(dD), static_cast<float*>(st),
         static_cast<float*>(dst), static_cast<float*>(lae),
         static_cast<float*>(part), static_cast<float*>(part_ad),
         b, s, nh, chunk, nc, heads, groups, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGradSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(nc, groups, b);
  ssd_bwd_chunk_kernel<<<grid, kThreads, 0, stm>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_pass_kernel<<<dim3(kN * kN / 4 / kPassThreads, nh, b),
                        kPassThreads, 0, stm>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_grad_kernel<<<grid, kThreads, kGradSmem, stm>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)b * s * 2 * kN;
  ssd_bwd_reduce_kernel<<<(unsigned)((n + kRedThreads - 1) / kRedThreads),
                          kRedThreads, 0, stm>>>(a);
  return cudaGetLastError();
}
