// Mamba2 SSD scan with an initial and a final state, for Hopper (sm_90a),
// bound through a plain C interface.  bf16 x, B, C and y; fp32 dt, A_log, D
// and state.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel,
// pallas_call at line 74; wrapper src/repro/kernels/ops.py:69).  Per
// (batch row, head), chunk by chunk, with la the within-chunk cumsum of
// dt * A (A = -exp(A_log)):
//   y_t   = sum_{u<=t} exp(la_t - la_u) dt_u (C_t . B_u) x_u
//           + exp(la_t) C_t . state + D x_t
//   state <- state exp(la_end) + sum_u exp(la_end - la_u) dt_u x_u B_u^T
// The TPU kernel is the special case state_in = 0 with the final state
// dropped and s % chunk == 0.  This one starts from any state, writes the
// final one, and takes any s >= 1: the last chunk is ragged, and its
// missing positions get dt = 0, which leaves la and the state untouched.
// At s = 1 it is mamba2.ssd_step.
//
// The state is either a [b, nh, 64, 64] tensor in and another out, or a
// pool of per-slot rows read and written in place: batch row b uses pool
// row slot[b]; a row with fresh[b] set reads zeros (a new request in a
// recycled slot); a slot id outside [0, slots) is the sentinel of a
// masked row, which reads zeros and writes nothing.  Live slot ids must be
// distinct (the caller checks).
//
// What bounds it on the H100: a one-token step moves the 16 KB fp32 state
// of each (batch row, head) in and out and does 4 flops per state element,
// so it is bound by those bytes; a 64-token chunk adds x, y, B and C and
// about 1.6 MFLOP per head, which is still under the bytes on tensor cores
// (and about as large as them in fp32 on CUDA cores).  At the serving
// shapes (112 heads, one row for a prefill chunk, 4 for a decode tick) the
// work is a few MB, so what the design fights is latency and idle SMs:
//   - s = 1 takes a kernel without chunk machinery: a half-warp owns a
//     state row p of one (batch row, head), reads its 256 bytes with
//     16-byte loads, updates them in registers, reduces C . S_p with
//     shuffles and writes the row once; blocks of 16 rows over (row group,
//     head, batch row), so one batch row already launches 448 blocks;
//   - s > 1 splits each (batch row, head) over the head dim: y[:, p] and
//     the state rows S[p, :] depend on x[:, p] alone, and the one shared
//     product, the decayed W = C.B^T, is cheap to recompute, so each block
//     takes 64 / splits rows p (ops.ssd_plan, plain Python) and loops over
//     the chunks with its slice of the state in the fp32 accumulators of
//     its tensor-core products;
//   - every product runs on mma.sync bf16 tensor cores with fp32
//     accumulation: C.B^T has two bf16 operands; W.x, C.S^T and the state
//     update each have one fp32 operand (W, S, x exp(la_end - la) dt), which
//     is split into a bf16 hi part and a bf16 lo part and multiplied twice.
//     The other operand is exactly bf16, so the two products carry 16
//     mantissa bits of the fp32 operand (relative error 2^-17, far under
//     the fp32 state's tolerance), at half the cost of 3xTF32;
//   - the decay is selected, never multiplied by a 0/1 mask: for u > t the
//     exponent la_t - la_u is positive and exp may overflow to inf;
//   - x, B, C and dt come in with cp.async through their strides (no
//     chunk-major copy), double-buffered: the next chunk's tiles load while
//     this one computes; tile rows are padded by 16 bytes so that ldmatrix
//     reads distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kHD = 64;               // head dim
constexpr int kDS = 64;               // state dim
constexpr int kCL = 64;               // longest chunk
constexpr int kLdBC = kDS + 8;        // B/C/state tile pitch (bf16)
constexpr int kChunkThreads = 128;    // 4 warps of 16 chunk positions
constexpr int kStepRows = 16;         // state rows per one-token block
constexpr int kStepThreads = kStepRows * 16;  // a half-warp per row

struct Args {
  const bf16* x;
  const float* dt;
  const float* A_log;
  const bf16* B;
  const bf16* C;
  const float* D;
  const float* st_in;          // null: zeros
  float* st_out;               // equals st_in in the pool form
  const int* slot;             // null: batch row b uses state row b
  const unsigned char* fresh;  // null: no row is fresh
  bf16* y;
  long long st_stride;         // floats between state rows
  int slots;                   // state rows; an id outside is the sentinel
  int s, nh, chunk;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss;
};

struct StateRow {
  long long off;  // floats from the base to this batch row's state
  bool read;      // false: the state starts at zero
  bool write;     // false: the sentinel, nothing is written
};

__device__ __forceinline__ StateRow state_row(const Args& a, int b) {
  const int r = a.slot ? a.slot[b] : b;
  const bool live = r >= 0 && r < a.slots;
  const bool fresh = a.fresh && a.fresh[b];
  return {live ? (long long)r * a.st_stride : 0,
          live && !fresh && a.st_in != nullptr, live};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// ---------------------------------------------------------------------------
// s = 1: S <- S exp(dt A) + dt x_p B^T, then y_p = C . S_p + D x_p.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kStepThreads) ssd_step_kernel(const Args a) {
  const int tid = threadIdx.x, lane = tid % 16;
  const int p = blockIdx.x * kStepRows + tid / 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const StateRow sr = state_row(a, b);
  const long long soff = sr.off + ((long long)h * kHD + p) * kDS + 4 * lane;
  float4 S = sr.read ? *reinterpret_cast<const float4*>(a.st_in + soff)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float dtv = a.dt[b * a.dt_sb + h * a.dt_sh];
  const float xp = __bfloat162float(a.x[b * a.x_sb + h * a.x_sh + p]);
  const uint2 braw =
      *reinterpret_cast<const uint2*>(a.B + b * a.b_sb + 4 * lane);
  const uint2 craw =
      *reinterpret_cast<const uint2*>(a.C + b * a.c_sb + 4 * lane);
  const float2 b01 = unpack(braw.x), b23 = unpack(braw.y);
  const float2 c01 = unpack(craw.x), c23 = unpack(craw.y);
  const float g = expf(dtv * -expf(a.A_log[h]));
  const float u = xp * dtv;
  S.x = S.x * g + u * b01.x;
  S.y = S.y * g + u * b01.y;
  S.z = S.z * g + u * b23.x;
  S.w = S.w * g + u * b23.y;
  float yp = c01.x * S.x + c01.y * S.y + c23.x * S.z + c23.y * S.w;
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    yp += __shfl_xor_sync(0xffffffffu, yp, off);
  if (lane == 0)
    a.y[((size_t)b * a.nh + h) * kHD + p] = __float2bfloat16(yp + a.D[h] * xp);
  if (sr.write) *reinterpret_cast<float4*>(a.st_out + soff) = S;
}

// ---------------------------------------------------------------------------
// s > 1: P = 64 / splits state rows p per block, chunk by chunk.
// ---------------------------------------------------------------------------

template <int P>
struct ChunkSmem {
  static constexpr int kLdX = P + 8;           // x tile pitch (bf16)
  static constexpr int kX = kCL * kLdX;        // x tile [u][p]
  static constexpr int kBC = kCL * kLdBC;      // B or C tile [u][n]
  static constexpr int kStage = kX + 2 * kBC;  // bf16 per stage
  static constexpr int kState = P * kLdBC;     // S hi or lo [p][n]
  static constexpr int kBf16 = 2 * kStage + 2 * kState;
  // then fp32: dt [2 stages][kCL], la and wv [4 warps][kCL] each
  static constexpr int kBytes = kBf16 * 2 + (2 + 8) * kCL * 4;
};

template <int P>
__global__ void __launch_bounds__(kChunkThreads)
    ssd_chunk_kernel(const Args a) {
  using L = ChunkSmem<P>;
  constexpr int kLdX = L::kLdX;
  constexpr int kMT = P / 16;             // m16 tiles of state rows
  constexpr int kWarpsPerMT = 4 / kMT;    // warps that split one m16 tile
  constexpr int kSN = kDS / kWarpsPerMT / 8;  // n8 state tiles per warp
  constexpr int kYN = P / 8;              // n8 tiles of y per warp
  static_assert(P == 16 || P == 32 || P == 64, "16, 32 or 64 rows");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  bf16* Shi = stages + 2 * L::kStage;
  bf16* Slo = Shi + L::kState;
  float* dts = reinterpret_cast<float*>(Slo + L::kState);  // [2][kCL]
  float* la_all = dts + 2 * kCL;                            // [4][kCL]
  float* wv_all = la_all + 4 * kCL;                         // [4][kCL]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int p0 = blockIdx.x * P, h = blockIdx.y, b = blockIdx.z;
  const StateRow sr = state_row(a, b);
  const float A = -expf(a.A_log[h]);
  const float Dh = a.D[h];

  const bf16* xb = a.x + b * a.x_sb + h * a.x_sh + p0;
  const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;
  const bf16* Bb = a.B + b * a.b_sb;
  const bf16* Cb = a.C + b * a.c_sb;

  auto load_chunk = [&](int stage, int c0) {
    const int len = min(a.chunk, a.s - c0);
    bf16* xs = stages + stage * L::kStage;
    bf16* bs = xs + L::kX;
    bf16* cs = bs + L::kBC;
    constexpr int kXV = P / 8;  // 16-byte pieces of an x row
    for (int i = tid; i < kCL * kXV; i += kChunkThreads) {
      const int u = i / kXV, c = (i % kXV) * 8;
      const bool ok = u < len;  // beyond: zero-filled
      cp_async16(xs + u * kLdX + c, ok ? xb + (c0 + u) * a.x_ss + c : xb, ok);
    }
    for (int i = tid; i < kCL * 8; i += kChunkThreads) {
      const int u = i / 8, c = (i % 8) * 8;
      const bool ok = u < len;
      cp_async16(bs + u * kLdBC + c, ok ? Bb + (c0 + u) * a.b_ss + c : Bb, ok);
      cp_async16(cs + u * kLdBC + c, ok ? Cb + (c0 + u) * a.c_ss + c : Cb, ok);
    }
    if (tid < kCL) {
      const bool ok = tid < len;
      cp_async4(dts + stage * kCL + tid, ok ? dtb + (c0 + tid) * a.dt_ss : dtb,
                ok);
    }
  };

  // this warp's part of the state update: rows mt*16.. of the block's P,
  // columns nb.. of the 64; its fp32 state lives in these accumulators
  const int mt = warp / kWarpsPerMT;
  const int nb = (warp % kWarpsPerMT) * kSN * 8;
  const long long srow = sr.off + ((long long)h * kHD + p0 + mt * 16) * kDS;
  float sacc[kSN][4];

  load_chunk(0, 0);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < kSN; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float2 v = make_float2(0.0f, 0.0f);
      if (sr.read)
        v = *reinterpret_cast<const float2*>(
            a.st_in + srow + (g + 8 * hh) * kDS + nb + 8 * j + 2 * tq);
      sacc[j][2 * hh] = v.x;
      sacc[j][2 * hh + 1] = v.y;
    }

  // the state as the bf16 hi/lo pair that C.S^T reads
  auto put_state = [&]() {
#pragma unroll
    for (int j = 0; j < kSN; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        unsigned hi, lo;
        split2(sacc[j][2 * hh], sacc[j][2 * hh + 1], hi, lo);
        const int off = (mt * 16 + g + 8 * hh) * kLdBC + nb + 8 * j + 2 * tq;
        *reinterpret_cast<unsigned*>(Shi + off) = hi;
        *reinterpret_cast<unsigned*>(Slo + off) = lo;
      }
  };
  put_state();

  const size_t y_ss = (size_t)a.nh * kHD;  // y is contiguous [b, s, nh, hd]
  bf16* yb = a.y + (size_t)b * a.s * y_ss + (size_t)h * kHD + p0;
  float* la = la_all + warp * kCL;
  float* wv = wv_all + warp * kCL;
  const int t0 = warp * 16;  // this warp's chunk positions
  const int n_chunks = (a.s + a.chunk - 1) / a.chunk;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * a.chunk, len = min(a.chunk, a.s - c0), st = ci & 1;
    if (ci + 1 < n_chunks) {
      load_chunk(st ^ 1, c0 + a.chunk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's tiles and the state's hi/lo are in
    const bf16* xs = stages + st * L::kStage;
    const bf16* bs = xs + L::kX;
    const bf16* cs = bs + L::kBC;
    const float* dtc = dts + st * kCL;

    // la, and wv_u = exp(la_end - la_u) dt_u, each warp its own copy;
    // positions past len have dt = 0, so la[kCL - 1] is la_end
    {
      const float d0 = dtc[lane], d1 = dtc[lane + 32];
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
      la[lane] = v0;
      la[lane + 32] = v1;
      wv[lane] = expf(la_end - v0) * d0;  // la_end <= la_u: no overflow
      wv[lane + 32] = expf(la_end - v1) * d1;
      __syncwarp();
    }
    const float la_r[2] = {la[t0 + g], la[t0 + g + 8]};

    // C fragments of this warp's 16 positions, over the 4 k steps of n
    unsigned ca[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(ca[kk], cs + (t0 + lane % 16) * kLdBC + kk * 16 + (lane / 16) * 8);

    // W = select(u <= t, (C_t . B_u) exp(la_t - la_u) dt_u, 0) for u < t0 + 16,
    // as hi/lo A fragments of the k steps of u
    unsigned whi[4][4], wlo[4][4];
#pragma unroll
    for (int ku = 0; ku < 4; ++ku) {
      if (ku > warp) continue;  // u > t for every row of the warp
      float gacc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned bb[4];
        ldsm_x4(bb, bs + (ku * 16 + lane % 8 + (lane / 16) * 8) * kLdBC +
                        kk * 16 + ((lane / 8) % 2) * 8);
        mma16816(gacc[0], ca[kk], bb);
        mma16816(gacc[1], ca[kk], bb + 2);
      }
      float w[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + g + 8 * (e / 2);
          const int u = ku * 16 + jj * 8 + 2 * tq + (e & 1);
          // select, then exp: for u > t the exponent is positive
          w[jj][e] = u <= t ? gacc[jj][e] * expf(la_r[e / 2] - la[u]) * dtc[u]
                            : 0.0f;
        }
      split2(w[0][0], w[0][1], whi[ku][0], wlo[ku][0]);
      split2(w[0][2], w[0][3], whi[ku][1], wlo[ku][1]);
      split2(w[1][0], w[1][1], whi[ku][2], wlo[ku][2]);
      split2(w[1][2], w[1][3], whi[ku][3], wlo[ku][3]);
    }

    // y = W x + exp(la_t) C . S^T + D x, for the block's P columns p
    float yi[kYN][4], yc[kYN][4];
#pragma unroll
    for (int n = 0; n < kYN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[n][e] = yc[n][e] = 0.0f;
#pragma unroll
    for (int ku = 0; ku < 4; ++ku) {
      if (ku > warp) continue;
#pragma unroll
      for (int n = 0; n < kYN; n += 2) {
        unsigned xf[4];
        ldsm_x4_trans(xf, xs + (ku * 16 + lane % 16) * kLdX + n * 8 +
                              (lane / 16) * 8);
        mma16816(yi[n], whi[ku], xf);
        mma16816(yi[n], wlo[ku], xf);
        mma16816(yi[n + 1], whi[ku], xf + 2);
        mma16816(yi[n + 1], wlo[ku], xf + 2);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < kYN; n += 2) {
        const int off = (n * 8 + lane % 8 + (lane / 16) * 8) * kLdBC +
                        kk * 16 + ((lane / 8) % 2) * 8;
        unsigned sh[4], sl[4];
        ldsm_x4(sh, Shi + off);
        ldsm_x4(sl, Slo + off);
        mma16816(yc[n], ca[kk], sh);
        mma16816(yc[n], ca[kk], sl);
        mma16816(yc[n + 1], ca[kk], sh + 2);
        mma16816(yc[n + 1], ca[kk], sl + 2);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + g + 8 * hh;
      if (t >= len) continue;
      const float gt = expf(la_r[hh]);
#pragma unroll
      for (int n = 0; n < kYN; ++n) {
        const int p = n * 8 + 2 * tq;
        const float2 xv =
            unpack(*reinterpret_cast<const unsigned*>(xs + t * kLdX + p));
        const float v0 = yi[n][2 * hh] + gt * yc[n][2 * hh] + Dh * xv.x;
        const float v1 = yi[n][2 * hh + 1] + gt * yc[n][2 * hh + 1] + Dh * xv.y;
        *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)(c0 + t) * y_ss + p) =
            __floats2bfloat162_rn(v0, v1);
      }
    }

    // S <- S exp(la_end) + (x wv)^T B for this warp's rows and columns
    const float g_end = expf(la[kCL - 1]);
#pragma unroll
    for (int j = 0; j < kSN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] *= g_end;
#pragma unroll
    for (int ku = 0; ku < 4; ++ku) {
      if (ku * 16 >= len) continue;  // zero-filled positions add nothing
      unsigned xa[4];
      ldsm_x4_trans(xa, xs + (ku * 16 + (lane / 16) * 8 + lane % 8) * kLdX +
                            mt * 16 + ((lane / 8) % 2) * 8);
      const float2 w01 = *reinterpret_cast<const float2*>(wv + ku * 16 + 2 * tq);
      const float2 w89 =
          *reinterpret_cast<const float2*>(wv + ku * 16 + 8 + 2 * tq);
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 xv = unpack(xa[r]);
        const float2 wp = r < 2 ? w01 : w89;  // a0, a1: u = 2tq; a2, a3: 8 + 2tq
        split2(xv.x * wp.x, xv.y * wp.y, ahi[r], alo[r]);
      }
#pragma unroll
      for (int j = 0; j < kSN; j += 2) {
        unsigned bb[4];
        ldsm_x4_trans(bb, bs + (ku * 16 + lane % 16) * kLdBC + nb + j * 8 +
                              (lane / 16) * 8);
        mma16816(sacc[j], ahi, bb);
        mma16816(sacc[j], alo, bb);
        mma16816(sacc[j + 1], ahi, bb + 2);
        mma16816(sacc[j + 1], alo, bb + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage and the old hi/lo
    put_state();
  }

  if (!sr.write) return;
#pragma unroll
  for (int j = 0; j < kSN; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(a.st_out + srow + (g + 8 * hh) * kDS + nb +
                                 8 * j + 2 * tq) =
          make_float2(sacc[j][2 * hh], sacc[j][2 * hh + 1]);
}

template <int P>
cudaError_t launch_chunk(const Args& a, int b, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ChunkSmem<P>::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  ssd_chunk_kernel<P><<<dim3(kHD / P, a.nh, b), kChunkThreads,
                         ChunkSmem<P>::kBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x [b, s, nh, 64] bf16 and dt [b, s, nh] fp32, each with the given strides
// of b, s and h (unit stride along the last dim of x); B/C [b, s, 64] bf16
// with the given strides of b and s (unit stride along the last dim); x, B
// and C 16-byte aligned with strides in multiples of 8; A_log, D [nh] fp32;
// y [b, s, nh, 64] bf16 contiguous.  The state: rows of nh * 64 * 64 fp32,
// st_stride floats apart; batch row i reads row slot[i] (row i when slot is
// null) unless fresh[i] is set or st_in is null, and writes it to st_out
// unless the id is outside [0, slots).  1 <= chunk <= 64.  splits: 4 for
// s = 1 (the one-token kernel, 16 rows a block), else 1, 2 or 4 blocks per
// (batch row, head) of 64 / splits rows each (ops.ssd_plan).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_scan_bf16(
    const void* x, const void* dt, const void* A_log, const void* B,
    const void* C, const void* D, const void* st_in, void* st_out,
    const void* slot, const void* fresh, void* y, long long st_stride,
    int slots, int b, int s, int nh, int hd, int ds, int chunk, int splits,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || nh > 65535 || hd != kHD || ds != kDS ||
      chunk < 1 || chunk > kCL || b > 65535 || st_out == nullptr)
    return cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
         static_cast<const float*>(A_log), static_cast<const bf16*>(B),
         static_cast<const bf16*>(C), static_cast<const float*>(D),
         static_cast<const float*>(st_in), static_cast<float*>(st_out),
         static_cast<const int*>(slot),
         static_cast<const unsigned char*>(fresh), static_cast<bf16*>(y),
         st_stride, slots, s, nh, chunk,
         x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == 1) {
    if (splits != kHD / kStepRows) return cudaErrorInvalidValue;
    ssd_step_kernel<<<dim3(splits, nh, b), kStepThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  switch (splits) {
    case 1: return launch_chunk<64>(a, b, st);
    case 2: return launch_chunk<32>(a, b, st);
    case 4: return launch_chunk<16>(a, b, st);
    default: return cudaErrorInvalidValue;
  }
}
