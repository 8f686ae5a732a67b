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
//   dS    <- exp(la_end) dS + sum_t G_t dy_t C_t^T
// and through la, with Q = cb decay M, P_tu = Q_tu dt_u, r_u = x_u^T dS B_u
// and c_t = G_t dy_t^T S C_t:
//   d la_t = sum_u P_tu - sum_u P_ut + c_t - wv_t r_t, and at the chunk's
//            end exp(la_end) <dS, S> + sum_u wv_u r_u more;
//   ddt_u  = sum_t Q_tu + exp(la_end - la_u) r_u + A sum_{t>=u} d la_t;
//   dA    += sum_u dt_u sum_{t>=u} d la_t;  dA_log = A dA;  dD = sum dy x.
// (kernels/ref.py::ssd_bwd_ref is the same algebra in plain torch.)
//
// What bounds it on the H100: bytes, at the training shape (b = 1, s =
// 2048, 112 heads of 64): x, dy and dx in bf16 are 88 MB, about 27 us at
// 3.35 TB/s; its products are 10 of 64 x 64 x 64 per head and chunk, 15
// GFLOP, 15 us on bf16 tensor cores and 0.22 ms on fp32 CUDA cores.  This
// first design is simple, and far from either bound:
//   - one block per (batch row, head), 256 threads, walking the chunks
//     forwards to recompute the state entering each chunk (written to an
//     fp32 scratch, [b, nh, chunks, 64, 64]: 58.7 MB at the training
//     shape, read back by the same block), then backwards carrying dS in
//     shared memory;
//   - every product is a 64 x 64 x 64 one on fp32 CUDA cores from fp32
//     tiles in shared memory, each thread a 4 x 4 tile of the output;
//     x, dy, B and C are exactly bf16, so fp32 products carry no rounding
//     of their own beyond the sums';
//   - the sums over the head dim (M, r, c, <dS, S>) stay inside the block;
//     the sums over heads (dB, dC) and over batch rows (dA_log, dD) go
//     through fp32 partials that a second kernel adds in a fixed order,
//     so the result is bitwise deterministic (no float atomics);
//   - a ragged last chunk is zero-filled: its missing positions have dt =
//     0 and zero x, dy, B, C, which add nothing and leave la flat.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kN = 64;          // head dim = state dim = longest chunk
constexpr int kLd = kN + 1;     // tile pitch (floats)
constexpr int kTile = kN * kLd;
constexpr int kThreads = 256;   // 16 x 16 threads, each a 4 x 4 tile
constexpr int kRedThreads = 256;

// shared memory: 9 tiles, then vectors
constexpr int kTiles = 9;
constexpr int kVecs = 14;       // kN floats each
constexpr int kSmemFloats = kTiles * kTile + kVecs * kN + kThreads + 16 * kN * 2;
constexpr int kSmemBytes = kSmemFloats * 4;

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
  float* states;       // [b, nh, nc, 64, 64] scratch
  float* part;         // [b, nh, s, 128] scratch: dB | dC of each head
  float* part_ad;      // [2, b, nh] scratch: dA, dD of each (batch row, head)
  int b, s, nh, chunk, nc;
  long long b_sb, b_ss, c_sb, c_ss;
};

// acc[i][j] += sum_k A(r0 + i, k) * scale[k] * Bm(k, c0 + j) over k < kN,
// with A(r, k) = TA ? A[k * kLd + r] : A[r * kLd + k] and Bm(k, c) = TB ?
// Bm[c * kLd + k] : Bm[k * kLd + c]; no scale where it is null.
template <bool TA, bool TB>
__device__ __forceinline__ void mm4(const float* A, const float* Bm,
                                    const float* scale, int r0, int c0,
                                    float acc[4][4]) {
#pragma unroll 4
  for (int k = 0; k < kN; ++k) {
    float a[4], bv[4];
    const float sk = scale ? scale[k] : 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = (TA ? A[k * kLd + r0 + i] : A[(r0 + i) * kLd + k]) * sk;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = TB ? Bm[(c0 + j) * kLd + k] : Bm[k * kLd + c0 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
  }
}

__device__ __forceinline__ void zero4(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // x [u][p]
  float* ys = xs + kTile;     // dy [t][p]
  float* bs = ys + kTile;     // B [u][n]
  float* cs = bs + kTile;     // C [t][n]
  float* Sm = cs + kTile;     // S entering the chunk [p][n]
  float* dS = Sm + kTile;     // gradient of the state leaving it [p][n]
  float* Wm = dS + kTile;     // cb decay dt_u [t][u]
  float* Zm = Wm + kTile;     // M decay dt_u [t][u]
  float* Qm = Zm + kTile;     // cb decay M [t][u]
  float* dtv = Qm + kTile;    // the vectors, kN each
  float* la = dtv + kN;
  float* Gv = la + kN;        // exp(la)
  float* eo = Gv + kN;        // exp(la_end - la)
  float* wv = eo + kN;        // eo dt
  float* rowP = wv + kN;      // sum_u P_tu
  float* colP = rowP + kN;    // sum_t P_tu
  float* colQ = colP + kN;    // sum_t Q_tu
  float* cv = colQ + kN;      // c_t
  float* rv = cv + kN;        // r_u
  float* scal = rv + kN;      // [0]: <dS, S>
  float* spare = scal + kN;
  float* red = spare + 2 * kN;   // [kThreads] per-thread partials
  float* cred = red + kThreads;  // [kN][16] c's partials by column group
  float* rred = cred + 16 * kN;  // [kN][16] r's

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int r0 = 4 * ty, c0 = 4 * tx;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int nh = a.nh, s = a.s, nc = a.nc;
  const float A = -expf(a.A_log[h]);
  const float Dh = a.D[h];
  float* st = a.states + ((size_t)bb * nh + h) * nc * kN * kN;

  // dt, la, exp(la), exp(la_end - la) and wv of the chunk at t0 (dt = 0
  // past its end, so la stays flat there and la[kN - 1] is la_end)
  auto chunk_vectors = [&](int t0, int len) {
    if (tid < kN)
      dtv[tid] = tid < len ? a.dt[((size_t)bb * s + t0 + tid) * nh + h] : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int t = 0; t < kN; ++t) {
        run += dtv[t] * A;
        la[t] = run;
      }
    }
    __syncthreads();
    if (tid < kN) {
      Gv[tid] = expf(la[tid]);
      eo[tid] = expf(la[kN - 1] - la[tid]);  // la_end <= la_t: no overflow
      wv[tid] = eo[tid] * dtv[tid];
    }
    __syncthreads();
  };
  // a [len, 64] tile of rows t0.. of a bf16 tensor (row stride rs), zero
  // past len
  auto load_tile = [&](float* dst, const bf16* src, long long rs, int len) {
    for (int i = tid; i < kN * kN; i += kThreads) {
      const int r = i / kN, c = i % kN;
      dst[r * kLd + c] = r < len ? __bfloat162float(src[r * rs + c]) : 0.0f;
    }
  };
  const long long xrow = (long long)nh * kN;  // x's and dy's row stride
  auto x_at = [&](const bf16* base, int t0) {
    return base + ((size_t)bb * s + t0) * xrow + (size_t)h * kN;
  };

  // Forwards: the state entering each chunk, this thread's 4 x 4 of it
  // (rows p, columns n) in registers.
  float S[4][4];
  zero4(S);
  for (int ci = 0; ci < nc; ++ci) {
    float* out = st + (size_t)ci * kN * kN;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[(r0 + i) * kN + c0 + j] = S[i][j];
    if (ci + 1 == nc) break;
    const int t0 = ci * a.chunk, len = min(a.chunk, s - t0);
    __syncthreads();  // the previous chunk's tiles are read
    load_tile(xs, x_at(a.x, t0), xrow, len);
    load_tile(bs, a.B + bb * a.b_sb + t0 * a.b_ss, a.b_ss, len);
    chunk_vectors(t0, len);
    // S <- S exp(la_end) + sum_u x_u wv_u B_u^T
    const float g_end = expf(la[kN - 1]);
    float upd[4][4];
    zero4(upd);
    mm4<true, false>(xs, bs, wv, r0, c0, upd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[i][j] = S[i][j] * g_end + upd[i][j];
  }

  // Backwards, carrying dS (zero after the last chunk).
  for (int i = tid; i < kN * kN; i += kThreads)
    dS[(i / kN) * kLd + i % kN] = 0.0f;
  float dA_acc = 0.0f, dD_acc = 0.0f;
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * a.chunk, len = min(a.chunk, s - t0);
    __syncthreads();  // the states are written; the last chunk's are read
    load_tile(xs, x_at(a.x, t0), xrow, len);
    load_tile(ys, x_at(a.dy, t0), xrow, len);
    load_tile(bs, a.B + bb * a.b_sb + t0 * a.b_ss, a.b_ss, len);
    load_tile(cs, a.C + bb * a.c_sb + t0 * a.c_ss, a.c_ss, len);
    const float* sin = st + (size_t)ci * kN * kN;
    for (int i = tid; i < kN * kN; i += kThreads)
      Sm[(i / kN) * kLd + i % kN] = sin[i];
    chunk_vectors(t0, len);
    const float la_end = la[kN - 1];

    // cb and M for this thread's (t, u), then W, Z and Q (0 for u > t)
    {
      float cb[4][4], M[4][4];
      zero4(cb);
      zero4(M);
      mm4<false, true>(cs, bs, nullptr, r0, c0, cb);
      mm4<false, true>(ys, xs, nullptr, r0, c0, M);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = r0 + i, u = c0 + j;
          float w = 0.0f, z = 0.0f, q = 0.0f;
          if (u <= t) {  // select, then exp: for u > t it may overflow
            const float dec = expf(la[t] - la[u]);
            w = cb[i][j] * dec * dtv[u];
            z = M[i][j] * dec * dtv[u];
            q = cb[i][j] * dec * M[i][j];
          }
          Wm[t * kLd + u] = w;
          Zm[t * kLd + u] = z;
          Qm[t * kLd + u] = q;
        }
    }
    __syncthreads();

    float* part = a.part + ((size_t)bb * nh + h) * s * 2 * kN;
    {
      // dx for rows u, columns p
      float p1[4][4], p2[4][4];
      zero4(p1);
      zero4(p2);
      mm4<true, false>(Wm, ys, nullptr, r0, c0, p1);   // sum_t W_tu dy_t
      mm4<false, true>(bs, dS, nullptr, r0, c0, p2);   // (dS B_u)[p]
      bf16* dxb = a.dx + ((size_t)bb * s + t0) * xrow + (size_t)h * kN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = r0 + i;
        if (u >= len) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = c0 + j;
          const float dyv = ys[u * kLd + p];
          dxb[(size_t)u * xrow + p] =
              __float2bfloat16(p1[i][j] + Dh * dyv + wv[u] * p2[i][j]);
          dD_acc += dyv * xs[u * kLd + p];
        }
      }
    }
    {
      // dC for rows t, columns n; YS = dy^T S feeds c
      float p1[4][4], p2[4][4];
      zero4(p1);
      zero4(p2);
      mm4<false, false>(Zm, bs, nullptr, r0, c0, p1);  // sum_u Z_tu B_u
      mm4<false, false>(ys, Sm, nullptr, r0, c0, p2);  // YS_t
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + i;
        float c_part = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = c0 + j;
          c_part += cs[t * kLd + n] * p2[i][j];
          if (t < len)
            part[(size_t)(t0 + t) * 2 * kN + kN + n] =
                p1[i][j] + Gv[t] * p2[i][j];
        }
        cred[t * 16 + tx] = c_part;
      }
    }
    {
      // dB for rows u, columns n; XdS = x^T dS feeds r
      float p1[4][4], p2[4][4];
      zero4(p1);
      zero4(p2);
      mm4<true, false>(Zm, cs, nullptr, r0, c0, p1);   // sum_t Z_tu C_t
      mm4<false, false>(xs, dS, nullptr, r0, c0, p2);  // XdS_u
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = r0 + i;
        float r_part = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = c0 + j;
          r_part += bs[u * kLd + n] * p2[i][j];
          if (u < len)
            part[(size_t)(t0 + u) * 2 * kN + n] = p1[i][j] + wv[u] * p2[i][j];
        }
        rred[u * 16 + tx] = r_part;
      }
    }
    {
      // <dS, S> over this thread's (p, n)
      float inner = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          inner += dS[(r0 + i) * kLd + c0 + j] * Sm[(r0 + i) * kLd + c0 + j];
      red[tid] = inner;
    }
    __syncthreads();  // every read of dS, cred, rred and red is done

    // dS <- exp(la_end) dS + sum_t G_t dy_t C_t^T (this thread's p, n)
    {
      float p1[4][4];
      zero4(p1);
      mm4<true, false>(ys, cs, Gv, r0, c0, p1);
      const float g_end = expf(la_end);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& d = dS[(r0 + i) * kLd + c0 + j];
          d = d * g_end + p1[i][j];
        }
    }
    // the vectors: rows t (threads 0-63), columns u (64-127), <dS, S>
    if (tid < kN) {
      const int t = tid;
      float rp = 0.0f, c = 0.0f;
      for (int u = 0; u < kN; ++u) rp += Qm[t * kLd + u] * dtv[u];
      for (int k = 0; k < 16; ++k) c += cred[t * 16 + k];
      rowP[t] = rp;
      cv[t] = Gv[t] * c;
    } else if (tid < 2 * kN) {
      const int u = tid - kN;
      float cq = 0.0f, r = 0.0f;
      for (int t = 0; t < kN; ++t) cq += Qm[t * kLd + u];
      for (int k = 0; k < 16; ++k) r += rred[u * 16 + k];
      colQ[u] = cq;
      colP[u] = cq * dtv[u];
      rv[u] = r;
    } else if (tid == 2 * kN) {
      float inner = 0.0f;
      for (int k = 0; k < kThreads; ++k) inner += red[k];
      scal[0] = inner;
    }
    __syncthreads();
    if (tid == 0) {
      // d la, its reverse cumsum d a, then ddt and dA
      float end = expf(la_end) * scal[0];
      for (int u = 0; u < kN; ++u) end += wv[u] * rv[u];
      float run = 0.0f;
      for (int t = kN - 1; t >= 0; --t) {
        run += rowP[t] - colP[t] + cv[t] - wv[t] * rv[t] +
               (t == kN - 1 ? end : 0.0f);
        if (t < len)
          a.ddt[((size_t)bb * s + t0 + t) * nh + h] =
              colQ[t] + eo[t] * rv[t] + A * run;
        dA_acc += dtv[t] * run;
      }
    }
  }

  // this (batch row, head)'s dA and dD
  __syncthreads();
  red[tid] = dD_acc;
  __syncthreads();
  if (tid == 0) {
    float d = 0.0f;
    for (int k = 0; k < kThreads; ++k) d += red[k];
    a.part_ad[bb * nh + h] = dA_acc;
    a.part_ad[(a.b + bb) * nh + h] = d;
  }
}

// dB and dC: each head's partials summed in head order; dA_log and dD:
// each batch row's summed in row order.
__global__ void __launch_bounds__(kRedThreads) ssd_bwd_reduce_kernel(
    const Args a) {
  const long long i = (long long)blockIdx.x * kRedThreads + threadIdx.x;
  const long long per_row = (long long)a.s * 2 * kN;
  if (i < (long long)a.b * per_row) {
    const int bb = (int)(i / per_row);
    const long long rem = i % per_row;  // t * 128 + column
    const float* p = a.part + (size_t)bb * a.nh * per_row + rem;
    float sum = 0.0f;
    for (int h = 0; h < a.nh; ++h) sum += p[(size_t)h * per_row];
    const long long t = rem / (2 * kN);
    const int col = (int)(rem % (2 * kN));
    bf16* out = col < kN ? a.dB : a.dC;
    out[((size_t)bb * a.s + t) * kN + col % kN] = __float2bfloat16(sum);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < a.nh; h += kRedThreads) {
      float dA = 0.0f, dD = 0.0f;
      for (int bb = 0; bb < a.b; ++bb) {
        dA += a.part_ad[bb * a.nh + h];
        dD += a.part_ad[(a.b + bb) * a.nh + h];
      }
      a.dA_log[h] = -expf(a.A_log[h]) * dA;
      a.dD[h] = dD;
    }
}

}  // namespace

// x, dy [b, s, nh, 64] bf16 contiguous, dt [b, s, nh] fp32 contiguous;
// B/C [b, s, 64] bf16 with the given strides of b and s (unit stride along
// the last dim); A_log, D [nh] fp32.  Outputs: dx as x, ddt as dt, dB/dC
// [b, s, 64] bf16 contiguous, dA_log/dD [nh] fp32.  Scratch (fp32):
// states b * nh * ceil(s / chunk) * 64 * 64, part b * nh * s * 128,
// part_ad 2 * b * nh.  hd = ds = 64, 1 <= chunk <= 64.  Two launches: the
// (batch row, head) blocks, then the fixed-order sums.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_ssd_scan_bwd_bf16(
    const void* x, const void* dt, const void* A_log, const void* B,
    const void* C, const void* D, const void* dy, void* dx, void* ddt,
    void* dA_log, void* dB, void* dC, void* dD, void* states, void* part,
    void* part_ad, int b, int s, int nh, int hd, int ds, int chunk,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || nh > 65535 || b > 65535 || hd != kN ||
      ds != kN || chunk < 1 || chunk > kN)
    return cudaErrorInvalidValue;
  const int nc = (s + chunk - 1) / chunk;
  Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
         static_cast<const float*>(A_log), static_cast<const bf16*>(B),
         static_cast<const bf16*>(C), static_cast<const float*>(D),
         static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
         static_cast<float*>(ddt), static_cast<float*>(dA_log),
         static_cast<bf16*>(dB), static_cast<bf16*>(dC),
         static_cast<float*>(dD), static_cast<float*>(states),
         static_cast<float*>(part), static_cast<float*>(part_ad),
         b, s, nh, chunk, nc, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  ssd_bwd_kernel<<<dim3(nh, b), kThreads, kSmemBytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)b * s * 2 * kN;
  ssd_bwd_reduce_kernel<<<(unsigned)((n + kRedThreads - 1) / kRedThreads),
                          kRedThreads, 0, st>>>(a);
  return cudaGetLastError();
}
