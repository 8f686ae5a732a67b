// Mamba2 SSD chunked scan with an initial and a final state, for Hopper
// (sm_90a), bound through a plain C interface.  bf16 x, B, C and y; fp32
// dt, A_log, D and state.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel,
// pallas_call at line 74; wrapper src/repro/kernels/ops.py:69).  Per
// (batch row, head), chunk by chunk, with la the within-chunk cumsum of
// dt * A (A = -exp(A_log)):
//   y_t   = sum_{u<=t} exp(la_t - la_u) dt_u (C_t . B_u) x_u
//           + exp(la_t) C_t . state + D x_t
//   state <- state exp(la_end) + sum_u exp(la_end - la_u) dt_u x_u B_u^T
// The TPU kernel is the special case state_in = 0 with the final state
// dropped and s % chunk == 0.  This one takes an optional state_in, writes
// state_out, and takes any s >= 1: the last chunk is ragged, and its
// missing positions get dt = 0, which leaves la and the state untouched.
// At s = 1 it is mamba2.ssd_step.
//
// What bounds it on the H100: at the serving shapes (112 heads of hd 64,
// ds 64, chunks of 64) the four products per chunk are about 2 MFLOP per
// head, and the bytes are x, y, B, C, dt and the 16 KB state of each head
// in and out.  Neither is large: a decode step is bound by the
// state's bytes, a prefill chunk by fp32 operations on CUDA cores.  The
// design keeps every intermediate on chip:
//   - one block per (head, batch row); the block loops over the chunks (the
//     TPU's sequential grid axis becomes this loop) with the [hd, ds] fp32
//     state in shared memory, read from device memory once and written once;
//   - per chunk, x, B, C (as fp32), C.B^T masked by the causal decay, la and
//     the per-position state weights sit in shared memory (about 84 KB,
//     dynamic), every row padded to 65 floats so that the 4x4 register
//     tiles of the products read distinct banks;
//   - the decay is selected, never multiplied by a 0/1 mask: for u > t the
//     exponent la_t - la_u is positive and exp may overflow to inf;
//   - x, B and C are read through their strides in the model's layout (no
//     chunk-major copy), and B and C, shared by all heads (one group), are
//     read again by every head's block.
// Tensor-core products and a variant that reads and writes the slot's row
// of the state pool directly are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kHD = 64;        // head dim
constexpr int kDS = 64;        // state dim
constexpr int kCL = 64;        // longest chunk
constexpr int kThreads = 256;  // a 16 x 16 grid of 4 x 4 output tiles
constexpr int kLd = 65;        // padded row pitch (floats) of every tile
constexpr int kTile = 64 * kLd;
constexpr int kSmemFloats = 5 * kTile + 3 * kCL;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

struct Args {
  const bf16* x;
  const float* dt;
  const float* A_log;
  const bf16* B;
  const bf16* C;
  const float* D;
  const float* state_in;  // may be null: zeros
  bf16* y;
  float* state_out;
  int s, nh, chunk;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss;
};

__global__ void __launch_bounds__(kThreads) ssd_kernel(const Args a) {
  extern __shared__ float smem[];
  float* S = smem;         // [kHD][kLd] state, row p, column n
  float* X = S + kTile;    // [kCL][kLd] x of the chunk, row u, column p
  float* Bs = X + kTile;   // [kCL][kLd]
  float* Cs = Bs + kTile;  // [kCL][kLd]
  float* W = Cs + kTile;   // [kCL][kLd] (C_t . B_u) exp(la_t - la_u) dt_u
  float* la = W + kTile;   // [kCL]
  float* dts = la + kCL;   // [kCL]
  float* wv = dts + kCL;   // [kCL] exp(la_end - la_u) dt_u

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float A = -expf(a.A_log[h]);
  const float Dh = a.D[h];
  const size_t st_off = ((size_t)b * a.nh + h) * kHD * kDS;

  for (int e = tid; e < kHD * kDS; e += kThreads)
    S[(e / kDS) * kLd + e % kDS] = a.state_in ? a.state_in[st_off + e] : 0.0f;

  const bf16* xb = a.x + b * a.x_sb + h * a.x_sh;
  const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;
  const bf16* Bb = a.B + b * a.b_sb;
  const bf16* Cb = a.C + b * a.c_sb;
  const size_t y_ss = (size_t)a.nh * kHD;  // y is contiguous [b, s, nh, hd]
  bf16* yb = a.y + (size_t)b * a.s * y_ss + (size_t)h * kHD;

  for (int c0 = 0; c0 < a.s; c0 += a.chunk) {
    const int len = min(a.chunk, a.s - c0);
    __syncthreads();  // the previous chunk is done with X, Bs, Cs, W and S
    for (int e = tid; e < kCL * kHD; e += kThreads) {
      int u = e / kHD, p = e % kHD;
      X[u * kLd + p] =
          u < len ? __bfloat162float(xb[(c0 + u) * a.x_ss + p]) : 0.0f;
    }
    for (int e = tid; e < kCL * kDS; e += kThreads) {
      int u = e / kDS, n = e % kDS;
      bool ok = u < len;
      Bs[u * kLd + n] = ok ? __bfloat162float(Bb[(c0 + u) * a.b_ss + n]) : 0.0f;
      Cs[u * kLd + n] = ok ? __bfloat162float(Cb[(c0 + u) * a.c_ss + n]) : 0.0f;
    }
    if (tid < 32) {
      // inclusive cumsum of dt * A, two positions a lane; positions past
      // len have dt = 0, so la[kCL - 1] is la at the chunk's last position
      float d0 = tid < len ? dtb[(c0 + tid) * a.dt_ss] : 0.0f;
      float d1 = tid + 32 < len ? dtb[(c0 + tid + 32) * a.dt_ss] : 0.0f;
      float v0 = d0 * A, v1 = d1 * A;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        float t0 = __shfl_up_sync(0xffffffffu, v0, off);
        float t1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (tid >= off) {
          v0 += t0;
          v1 += t1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float la_end = __shfl_sync(0xffffffffu, v1, 31);
      la[tid] = v0;
      la[tid + 32] = v1;
      dts[tid] = d0;
      dts[tid + 32] = d1;
      wv[tid] = expf(la_end - v0) * d0;  // la_end <= la_u: no overflow
      wv[tid + 32] = expf(la_end - v1) * d1;
    }
    __syncthreads();

    // W[t][u] for rows t = ty + 16i, columns u = tx + 16j
    {
      float acc[4][4] = {};
      if (ty < len) {
        for (int n = 0; n < kDS; ++n) {
          float c[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = Cs[(ty + 16 * i) * kLd + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = Bs[(tx + 16 * j) * kLd + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += c[i] * bb[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = tx + 16 * j;
          // select, then exp: for u > t the exponent is positive
          W[t * kLd + u] = (u <= t && t < len)
                               ? acc[i][j] * expf(la[t] - la[u]) * dts[u]
                               : 0.0f;
        }
      }
    }
    __syncthreads();

    // y[t][p] for rows t = ty + 16i, columns p = tx + 16j
    if (ty < len) {
      float intra[4][4] = {}, cross[4][4] = {};
      for (int u = 0; u < len; ++u) {  // W[t][u] is 0 for u > t
        float w[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = W[(ty + 16 * i) * kLd + u];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = X[u * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) intra[i][j] += w[i] * xv[j];
      }
      for (int n = 0; n < kDS; ++n) {
        float c[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = Cs[(ty + 16 * i) * kLd + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = S[(tx + 16 * j) * kLd + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cross[i][j] += c[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= len) continue;
        const float g = expf(la[t]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          float v = intra[i][j] + g * cross[i][j] + Dh * X[t * kLd + p];
          yb[(size_t)(c0 + t) * y_ss + p] = __float2bfloat16(v);
        }
      }
    }
    __syncthreads();  // every read of S for this chunk's y is done

    // S[p][n] for rows p = ty + 16i, columns n = tx + 16j
    {
      float acc[4][4] = {};
      for (int u = 0; u < len; ++u) {
        float xw[4], bb[4];
        const float wu = wv[u];
#pragma unroll
        for (int i = 0; i < 4; ++i) xw[i] = X[u * kLd + ty + 16 * i] * wu;
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[u * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += xw[i] * bb[j];
      }
      const float g = expf(la[kCL - 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* sp = S + (ty + 16 * i) * kLd + tx + 16 * j;
          *sp = *sp * g + acc[i][j];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < kHD * kDS; e += kThreads)
    a.state_out[st_off + e] = S[(e / kDS) * kLd + e % kDS];
}

}  // namespace

// x [b, s, nh, 64] bf16 and dt [b, s, nh] fp32, each with the given
// strides of b, s and h (unit stride along the last dim of x); B/C [b, s, 64]
// bf16 with the given strides of b and s (unit stride along the last dim);
// A_log, D [nh] fp32; state_in (or null) and state_out [b, nh, 64, 64] fp32
// contiguous; y [b, s, nh, 64] bf16 contiguous.  1 <= chunk <= 64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_scan_bf16(
    const void* x, const void* dt, const void* A_log, const void* B,
    const void* C, const void* D, const void* state_in, void* y,
    void* state_out, int b, int s, int nh, int hd, int ds, int chunk,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || hd != kHD || ds != kDS || chunk < 1 ||
      chunk > kCL || b > 65535)
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
         static_cast<const float*>(A_log), static_cast<const bf16*>(B),
         static_cast<const bf16*>(C), static_cast<const float*>(D),
         static_cast<const float*>(state_in), static_cast<bf16*>(y),
         static_cast<float*>(state_out), s, nh, chunk,
         x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss};
  ssd_kernel<<<dim3(nh, b), kThreads, kSmemBytes,
               static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
