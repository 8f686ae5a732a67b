// RMSNorm over rows, with a per-group scale and an optional SiLU gate, for
// Hopper (sm_90a), bound through a plain C interface.  bf16 x, gate and
// output; fp32 scale.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (body _rmsnorm_kernel,
// pallas_call at line 30): per row in fp32, x * rsqrt(mean(x^2) + eps) *
// gamma, cast back to bf16.  The rows are (token, group) pairs: row r of
// token i and group j reads x[i * x_stride + j * width ...] and scales by
// gamma[j]; groups = 1 is the model's block norm, groups = the rank's SSD
// heads is the Mamba2 grouped norm (src/repro/models/mamba2.py,
// _group_rmsnorm), one head's 64 channels a row.  With a gate z (bf16,
// read through its own token stride: a slice of the z|x GEMM output) the
// output is bf16(bf16(norm) * bf16(silu(z))), the rounding order of the
// plain bf16 path (y.to(bf16) * F.silu(z)) and of JAX's.
//
// What bounds it on the H100: bytes, each row read once and written once
// with a handful of flops per element; at the serving shapes (64 or 4 rows
// of 3584-4096, or 7168 or 448 rows of 64) that is at most a few MB, so the
// kernel is a latency: one round trip to memory.  So a row goes to T
// threads holding at most 4 vectors of 8 values each (ops.rmsnorm_plan,
// plain Python: an 8-lane group for a 64-wide row of the grouped norm, a
// warp up to 1024, 4 warps for a block norm's 3584 or 4096), and a block
// to few rows, so that the rows spread over the SMs; every thread issues
// all its 16-byte loads of x, gamma and the gate before the reduction,
// which is shuffles within a warp and, for a row of several warps, one
// exchange of their partial sums through shared memory; each row is
// written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxWidth = 4096;
constexpr int kMaxThreads = 256;

struct Args {
  const bf16* x;
  const float* gamma;  // [groups, width]
  const bf16* gate;    // null: no gate
  bf16* out;           // [tokens * groups, width] contiguous
  long long x_stride, gate_stride;  // elements between tokens
  int tokens, groups, width;
  float eps;
};

__device__ __forceinline__ float2 unpack(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ unsigned pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

// T threads per row (8, or a multiple of 32), each with N <= 4 16-byte
// vectors (8 values) of the row; blockDim.x / T rows per block
template <int T, int N, bool GATE>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(const Args a) {
  constexpr int kWarps = T / 32;  // warps per row (0: a row is part of one)
  __shared__ float part[kMaxThreads / 32];
  const int sub = threadIdx.x % T;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  const bool valid = row < (long long)a.tokens * a.groups;
  const long long tok = valid ? row / a.groups : 0;
  const int grp = valid ? (int)(row % a.groups) : 0;
  const uint4* xr = reinterpret_cast<const uint4*>(a.x + tok * a.x_stride +
                                                   (long long)grp * a.width);
  const float4* gr =
      reinterpret_cast<const float4*>(a.gamma + (long long)grp * a.width);
  const uint4* zr = nullptr;
  if (GATE)
    zr = reinterpret_cast<const uint4*>(a.gate + tok * a.gate_stride +
                                        (long long)grp * a.width);
  const int nv = a.width / 8;

  uint4 xv[N], zv[GATE ? N : 1];
  float4 gv[N][2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int v = sub + i * T;
    const bool ok = valid && v < nv;
    xv[i] = ok ? xr[v] : make_uint4(0, 0, 0, 0);
    if (GATE) zv[i] = ok ? zr[v] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int v = sub + i * T;
    const bool ok = valid && v < nv;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    gv[i][0] = ok ? gr[2 * v] : zero;
    gv[i][1] = ok ? gr[2 * v + 1] : zero;
  }

  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const unsigned w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = unpack(w[k]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
#pragma unroll
  for (int off = (T < 32 ? T : 32) / 2; off > 0; off /= 2)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (kWarps > 1) {  // a row of several warps: sum their partials
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    const int w0 = threadIdx.x / T * kWarps;
    ss = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) ss += part[w0 + k];
  }
  const float inv = rsqrtf(ss / a.width + a.eps);

  uint4* orow = reinterpret_cast<uint4*>(a.out + row * a.width);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int v = sub + i * T;
    if (!valid || v >= nv) continue;
    const unsigned w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
    const float gs[8] = {gv[i][0].x, gv[i][0].y, gv[i][0].z, gv[i][0].w,
                         gv[i][1].x, gv[i][1].y, gv[i][1].z, gv[i][1].w};
    unsigned zw[4] = {0, 0, 0, 0};
    if (GATE) {
      const uint4 z = zv[GATE ? i : 0];
      zw[0] = z.x;
      zw[1] = z.y;
      zw[2] = z.z;
      zw[3] = z.w;
    }
    unsigned o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = unpack(w[k]);
      float v0 = f.x * inv * gs[2 * k], v1 = f.y * inv * gs[2 * k + 1];
      if (GATE) {
        const float2 z = unpack(zw[k]);
        v0 = round_bf16(v0) * round_bf16(silu(z.x));
        v1 = round_bf16(v1) * round_bf16(silu(z.y));
      }
      o[k] = pack(v0, v1);
    }
    orow[v] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int T, int N>
cudaError_t launch(const Args& a, int rows_per_block, cudaStream_t stream) {
  // whole warps only: the shuffles name all 32 lanes
  if (rows_per_block < 1 || rows_per_block * T > kMaxThreads ||
      rows_per_block * T % 32)
    return cudaErrorInvalidValue;
  const long long rows = (long long)a.tokens * a.groups;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned threads = rows_per_block * T;
  if (a.gate)
    rmsnorm_kernel<T, N, true><<<(unsigned)blocks, threads, 0, stream>>>(a);
  else
    rmsnorm_kernel<T, N, false><<<(unsigned)blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: tokens rows of groups * width bf16, x_stride elements apart (unit
// stride inside); gamma [groups, width] fp32 contiguous; gate (or null) as
// x, gate_stride apart; out [tokens * groups, width] bf16 contiguous.
// width a multiple of 8 up to 4096; every pointer 16-byte aligned and both
// strides multiples of 8.  The plan (ops.rmsnorm_plan): T threads per row,
// N vectors of 8 values per thread (T * N * 8 >= width), rows_per_block.
// Returns the cudaError_t of the launch.
extern "C" int repro_rmsnorm_bf16(const void* x, const void* gamma,
                                  const void* gate, void* out,
                                  long long x_stride, long long gate_stride,
                                  int tokens, int groups, int width, float eps,
                                  int T, int N, int rows_per_block,
                                  void* stream) {
  if (tokens < 0 || groups < 1 || width < 8 || width % 8 ||
      width > kMaxWidth || T * N * 8 < width)
    return cudaErrorInvalidValue;
  if (tokens == 0) return 0;
  Args a{static_cast<const bf16*>(x), static_cast<const float*>(gamma),
         static_cast<const bf16*>(gate), static_cast<bf16*>(out),
         x_stride, gate_stride, tokens, groups, width, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = rows_per_block;
  switch (T * 100 + N) {
    case 801: return launch<8, 1>(a, r, st);
    case 3204: return launch<32, 4>(a, r, st);
    case 12804: return launch<128, 4>(a, r, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward, for training: the gradient of the block norm (groups = 1) with
// respect to x and gamma.  The Pallas kernel has none (JAX differentiates
// the plain jnp norm); this is the gradient of the function above:
//   xhat = x * rstd,  rstd = rsqrt(mean(x^2) + eps),
//   dx = rstd * (gamma * dy - xhat * mean(xhat * gamma * dy)),
//   dgamma = sum over rows of dy * xhat.
// rstd is recomputed from x (one more read of a row the kernel reads
// anyway).  Bound by bytes: x and dy read once, dx written once.  A block
// of 256 threads takes rows blockIdx.x, blockIdx.x + gridDim.x, ..., each
// thread holding up to 16 columns of the row and its columns' dgamma sums
// across the block's rows; a second kernel sums the blocks' partial
// dgamma rows in block order, so dgamma is deterministic (no float
// atomics).
// ---------------------------------------------------------------------------
namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdCols = kMaxWidth / kBwdThreads;  // columns a thread holds

__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  a = 0.0f;
  b = 0.0f;
#pragma unroll
  for (int w = 0; w < kBwdThreads / 32; ++w) {
    a += red[2 * w];
    b += red[2 * w + 1];
  }
  __syncthreads();  // red is reused by the next row
}

__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ gamma,
                       const bf16* __restrict__ dy, bf16* __restrict__ dx,
                       float* __restrict__ partial, int rows, int width,
                       float eps) {
  __shared__ float red[2 * kBwdThreads / 32];
  const int tid = threadIdx.x;
  float g[kBwdCols], dg[kBwdCols];
#pragma unroll
  for (int k = 0; k < kBwdCols; ++k) {
    const int c = tid + k * kBwdThreads;
    g[k] = c < width ? gamma[c] : 0.0f;
    dg[k] = 0.0f;
  }
  const float inv_w = 1.0f / static_cast<float>(width);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const bf16* xr = x + (size_t)row * width;
    const bf16* dr = dy + (size_t)row * width;
    float xv[kBwdCols], dv[kBwdCols];
    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int k = 0; k < kBwdCols; ++k) {
      const int c = tid + k * kBwdThreads;
      xv[k] = c < width ? __bfloat162float(xr[c]) : 0.0f;
      dv[k] = c < width ? __bfloat162float(dr[c]) : 0.0f;
      ss += xv[k] * xv[k];
      dot += xv[k] * g[k] * dv[k];
    }
    block_sum2(ss, dot, red);
    const float r = rsqrtf(ss * inv_w + eps);
    const float m = r * r * r * dot * inv_w;  // rstd * mean(xhat*gamma*dy)
    bf16* out = dx + (size_t)row * width;
#pragma unroll
    for (int k = 0; k < kBwdCols; ++k) {
      const int c = tid + k * kBwdThreads;
      if (c >= width) continue;
      out[c] = __float2bfloat16(r * g[k] * dv[k] - xv[k] * m);
      dg[k] += dv[k] * xv[k] * r;
    }
  }
  float* pr = partial + (size_t)blockIdx.x * width;
#pragma unroll
  for (int k = 0; k < kBwdCols; ++k) {
    const int c = tid + k * kBwdThreads;
    if (c < width) pr[c] = dg[k];
  }
}

__global__ void rmsnorm_dgamma_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dgamma, int blocks,
                                      int width) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * width + c];
  dgamma[c] = s;
}

}  // namespace

// x, dy, dx [rows, width] contiguous bf16 (16-byte-aligned bases), gamma and
// dgamma [width] fp32, partial [blocks, width] fp32 scratch; width <= 4096,
// blocks >= 1 (ops.rmsnorm_backward sizes the grid).  Two launches: the
// rows, then the block-ordered sum of the partial dgamma rows.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_rmsnorm_bwd_bf16(const void* x, const void* gamma,
                                      const void* dy, void* dx, void* partial,
                                      void* dgamma, int rows, int width,
                                      float eps, int blocks, void* stream) {
  if (rows < 1 || width < 1 || width > kMaxWidth || blocks < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rmsnorm_bwd_kernel<<<blocks, kBwdThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<float*>(partial), rows, width, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_dgamma_kernel<<<(width + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dgamma), blocks,
      width);
  return cudaGetLastError();
}
