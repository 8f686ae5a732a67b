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
//
// The split norm, for d2 > 1 (ops.split_rmsnorm): a row's features are cut
// over the tp2 ranks, so each of the norm's two row sums is the sum of the
// ranks' partial sums, all-reduced over tp2 between a partial launch and an
// apply launch (the JAX model splits its plain norm the same way around its
// psum: src/repro/models/layers.py::rms_norm).  On this rank's slice
// x [rows, w] of rows h = w * d2 wide, each piece is a mode of the
// whole-row kernels below, with their layout and their order of sums:
//   forward partial   rmsnorm_kernel, kSumSquares: ss[r] = sum_j x_j^2;
//   forward apply     rmsnorm_kernel, kApply: rstd[r] = rsqrt(ss[r] / h +
//                     eps) (ss all-reduced: the whole row's), y = x rstd
//                     gamma;
//   backward partial  rmsnorm_bwd_kernel, kDot: dot[r] = sum_j dy_j gamma_j
//                     x_j, and the slice's dgamma = sum over rows of dy x
//                     rstd (the whole-row backward's fixed-order sum);
//   backward apply    rmsnorm_bwd_kernel, kDx: dx = rstd (gamma dy - x
//                     rstd^2 dot / h) (dot all-reduced).
// rstd comes from the forward: recomputing it would take another
// all-reduce.  At llama3-8b's training rows at d2 = 2 (2048 rows, 2048 wide
// a slice) a launch moves 8-24 MB, a few microseconds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxWidth = 4096;
constexpr int kMaxThreads = 256;

// what rmsnorm_kernel does with a row: the whole-row norm; the split norm's
// forward partial (its sum of squares only); the split norm's apply (the
// all-reduced sum read in place of the row's own)
enum class Mode { kNorm, kSumSquares, kApply };

struct Args {
  const bf16* x;
  const float* gamma;  // [groups, width]
  const bf16* gate;    // null: no gate
  bf16* out;           // [tokens * groups, width] contiguous
  long long x_stride, gate_stride;  // elements between tokens
  int tokens, groups, width;
  float eps;
  float* ss;    // kSumSquares: written; kApply: read, [tokens * groups]
  float* rstd;  // kApply: written, [tokens * groups]
  float full;   // kApply: the whole row's width
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
template <int T, int N, bool GATE, Mode M>
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
  if constexpr (M != Mode::kSumSquares) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int v = sub + i * T;
      const bool ok = valid && v < nv;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      gv[i][0] = ok ? gr[2 * v] : zero;
      gv[i][1] = ok ? gr[2 * v + 1] : zero;
    }
  }

  float inv = 0.0f;
  if constexpr (M == Mode::kApply) {  // the all-reduced sum: no barrier
    if (!valid) return;
    inv = rsqrtf(a.ss[row] / a.full + a.eps);
    if (sub == 0) a.rstd[row] = inv;
  } else {
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
    if constexpr (M == Mode::kSumSquares) {
      if (valid && sub == 0) a.ss[row] = ss;
      return;
    }
    inv = rsqrtf(ss / a.width + a.eps);
  }

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

template <int T, int N, Mode M>
cudaError_t launch(const Args& a, int rows_per_block, cudaStream_t stream) {
  // whole warps only: the shuffles name all 32 lanes
  if (rows_per_block < 1 || rows_per_block * T > kMaxThreads ||
      rows_per_block * T % 32)
    return cudaErrorInvalidValue;
  const long long rows = (long long)a.tokens * a.groups;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned threads = rows_per_block * T;
  if (M == Mode::kNorm && a.gate)
    rmsnorm_kernel<T, N, true, Mode::kNorm>
        <<<(unsigned)blocks, threads, 0, stream>>>(a);
  else
    rmsnorm_kernel<T, N, false, M><<<(unsigned)blocks, threads, 0, stream>>>(
        a);
  return cudaGetLastError();
}

// the checks of a launch, then launch<T, N, M> for the variants of
// ops.RMSNORM_VARIANTS
template <Mode M>
int launch_rows(const Args& a, int T, int N, int rows_per_block,
                void* stream) {
  if (a.tokens < 0 || a.groups < 1 || a.width < 8 || a.width % 8 ||
      a.width > kMaxWidth || T * N * 8 < a.width ||
      (M == Mode::kApply && a.full < a.width))
    return cudaErrorInvalidValue;
  if (a.tokens == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = rows_per_block;
  switch (T * 100 + N) {
    case 801: return launch<8, 1, M>(a, r, st);
    case 3204: return launch<32, 4, M>(a, r, st);
    case 12804: return launch<128, 4, M>(a, r, st);
    default: return cudaErrorInvalidValue;
  }
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
  Args a{static_cast<const bf16*>(x), static_cast<const float*>(gamma),
         static_cast<const bf16*>(gate), static_cast<bf16*>(out),
         x_stride, gate_stride, tokens, groups, width, eps, nullptr, nullptr,
         0.0f};
  return launch_rows<Mode::kNorm>(a, T, N, rows_per_block, stream);
}

// ---------------------------------------------------------------------------
// Backward, for training: the gradient of the block norm (groups = 1) with
// respect to x and gamma.  The Pallas kernel has none (JAX differentiates
// the plain jnp norm); this is the gradient of the function above:
//   xhat = x * rstd,  rstd = rsqrt(mean(x^2) + eps),
//   dx = rstd * (gamma * dy - xhat * mean(xhat * gamma * dy)),
//   dgamma = sum over rows of dy * xhat.
// rstd is recomputed from x (one more read of a row the kernel reads
// anyway).  Bound by bytes: x and dy read once, dx written once.  The
// design:
//   - a row goes to 4 warps (a quarter each, 16-byte loads) and a block
//     takes 3 rows at a time, each row's 4 warps on their own named
//     barrier: a row's two sums are shuffles and one exchange among its 4
//     warps, with no block-wide barrier per row (3 rows, not 4: at 4 the
//     512 threads' 128 registers spill; 3 measured as fast);
//   - each warp loads its quarter of the next row while it computes this
//     one, so loads stay in flight; gamma is read once per block into
//     shared memory;
//   - dgamma: each warp keeps its columns' sum over its rows in registers;
//     at the end the block sums its 3 row slots in slot order into one
//     partial row, and a second kernel spread over the columns (32 a
//     block: 128 blocks at 4096) sums the blocks' partial rows in a fixed
//     order, so dgamma is deterministic (no float atomics).
// ---------------------------------------------------------------------------
namespace {

constexpr int kRowWarps = 4;      // warps of a row
constexpr int kRowSlots = 3;      // rows of a block at a time
constexpr int kBwdThreads = kRowWarps * kRowSlots * 32;
constexpr int kSumCols = 32;      // dgamma columns of a block
constexpr int kSumGroups = 32;    // its threads' groups of partial rows

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// what rmsnorm_bwd_kernel does with a row: the whole-row backward; the
// split norm's backward partial (its dot and dgamma, from the forward's
// rstd); the split norm's backward apply (dx from rstd and the all-reduced
// dot, no dgamma)
enum class Bwd { kWhole, kDot, kDx };

// NV 16-byte vectors a lane: width <= 4 warps * 32 lanes * NV * 8.  kDot
// and kDx read rstd [rows]; kDot writes dots [rows], kDx reads them; full
// is the whole row's width (kWhole: width)
template <int NV, Bwd B>
__global__ void __launch_bounds__(kBwdThreads, 1)
    rmsnorm_bwd_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ gamma,
                       const bf16* __restrict__ dy, bf16* __restrict__ dx,
                       float* __restrict__ partial, int rows, int width,
                       float eps, const float* __restrict__ rstd,
                       float* __restrict__ dots, float full) {
  extern __shared__ float4 bwd_smem[];
  float* gs = reinterpret_cast<float*>(bwd_smem);  // gamma [width]
  float* slot_dg = gs + width;  // [kRowSlots][width], at the end
  __shared__ float red[2][kRowSlots][kRowWarps][2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = warp / kRowWarps, quarter = warp % kRowWarps;
  const int nvec = width / 8;
  auto vec = [&](int i) { return (quarter * NV + i) * 32 + lane; };
  auto load = [&](long long row, uint4* xo, uint4* dout) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * width);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + row * width);
#pragma unroll
    for (int i = 0; i < NV; ++i) {  // read once: streaming loads
      const bool ok = vec(i) < nvec;
      xo[i] = ok ? __ldcs(xr + vec(i)) : make_uint4(0, 0, 0, 0);
      dout[i] = ok ? __ldcs(dr + vec(i)) : make_uint4(0, 0, 0, 0);
    }
  };
  float dg[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) dg[i][k] = 0.0f;

  const float inv_w =
      1.0f / (B == Bwd::kWhole ? static_cast<float>(width) : full);
  const long long stride = (long long)gridDim.x * kRowSlots;
  long long row = (long long)blockIdx.x * kRowSlots + slot;
  uint4 xv[NV], dv[NV];
  if (row < rows) load(row, xv, dv);  // in flight while gamma arrives
  for (int c = 4 * tid; c < width; c += 4 * kBwdThreads)
    *reinterpret_cast<float4*>(gs + c) =
        *reinterpret_cast<const float4*>(gamma + c);
  __syncthreads();
  for (int parity = 0; row < rows; row += stride, parity ^= 1) {
    uint4 xn[NV], dn[NV];  // unused past the last row
    if (row + stride < rows) load(row + stride, xn, dn);
    float ss = 0.0f, dot = 0.0f;
    if constexpr (B != Bwd::kDx) {  // the row's sums
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (vec(i) >= nvec) continue;
        const float4 g0 = *reinterpret_cast<const float4*>(gs + 8 * vec(i));
        const float4 g1 =
            *reinterpret_cast<const float4*>(gs + 8 * vec(i) + 4);
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const unsigned xw[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
        const unsigned dw[4] = {dv[i].x, dv[i].y, dv[i].z, dv[i].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 xf = unpack(xw[k]), df = unpack(dw[k]);
          if (B == Bwd::kWhole) ss += xf.x * xf.x + xf.y * xf.y;
          dot += xf.x * g[2 * k] * df.x + xf.y * g[2 * k + 1] * df.y;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        if (B == Bwd::kWhole) ss += __shfl_xor_sync(0xffffffffu, ss, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      // the row's 4 warps exchange their sums (by row parity, so that the
      // next row's writes never meet this row's reads), added in warp order
      if (lane == 0) {
        red[parity][slot][quarter][0] = ss;
        red[parity][slot][quarter][1] = dot;
      }
      bar_sync(1 + slot, kRowWarps * 32);
      ss = dot = 0.0f;
#pragma unroll
      for (int q = 0; q < kRowWarps; ++q) {
        ss += red[parity][slot][q][0];
        dot += red[parity][slot][q][1];
      }
    }
    if constexpr (B == Bwd::kDot)
      if (quarter == 0 && lane == 0) dots[row] = dot;
    if constexpr (B == Bwd::kDx) dot = dots[row];
    const float r = B == Bwd::kWhole ? rsqrtf(ss * inv_w + eps) : rstd[row];
    const float m = r * r * r * dot * inv_w;  // rstd * mean(xhat*gamma*dy)
    uint4* out = reinterpret_cast<uint4*>(dx + row * width);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (vec(i) >= nvec) continue;
      const float4 g0 = *reinterpret_cast<const float4*>(gs + 8 * vec(i));
      const float4 g1 =
          *reinterpret_cast<const float4*>(gs + 8 * vec(i) + 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const unsigned xw[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
      const unsigned dw[4] = {dv[i].x, dv[i].y, dv[i].z, dv[i].w};
      unsigned o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 xf = unpack(xw[k]), df = unpack(dw[k]);
        o[k] = pack(r * g[2 * k] * df.x - xf.x * m,
                    r * g[2 * k + 1] * df.y - xf.y * m);
        dg[i][2 * k] += df.x * xf.x * r;
        dg[i][2 * k + 1] += df.y * xf.y * r;
      }
      if (B != Bwd::kDot) out[vec(i)] = make_uint4(o[0], o[1], o[2], o[3]);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xv[i] = xn[i];
      dv[i] = dn[i];
    }
  }
  if constexpr (B != Bwd::kDx) {
    // the block's partial dgamma row: its row slots' sums added in slot
    // order
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (vec(i) >= nvec) continue;
      float4* d =
          reinterpret_cast<float4*>(slot_dg + slot * width + 8 * vec(i));
      d[0] = make_float4(dg[i][0], dg[i][1], dg[i][2], dg[i][3]);
      d[1] = make_float4(dg[i][4], dg[i][5], dg[i][6], dg[i][7]);
    }
    __syncthreads();
    for (int c = tid; c < width; c += kBwdThreads) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kRowSlots; ++k) s += slot_dg[k * width + c];
      partial[(size_t)blockIdx.x * width + c] = s;
    }
  }
}

// dgamma[c] = the blocks' partial rows summed in a fixed order: thread
// group k of a block sums partial rows k, k + 32, ... of its 32 columns,
// then the groups' sums are added in group order.
__global__ void __launch_bounds__(kSumCols * kSumGroups)
    rmsnorm_dgamma_kernel(const float* __restrict__ partial,
                          float* __restrict__ dgamma, int blocks, int width) {
  __shared__ float sums[kSumGroups][kSumCols];
  const int lane = threadIdx.x % kSumCols, grp = threadIdx.x / kSumCols;
  const int c = blockIdx.x * kSumCols + lane;
  float s = 0.0f;
  if (c < width)
    for (int b = grp; b < blocks; b += kSumGroups)
      s += partial[(size_t)b * width + c];
  sums[grp][lane] = s;
  __syncthreads();
  if (grp != 0 || c >= width) return;
  float t = 0.0f;
#pragma unroll
  for (int k = 0; k < kSumGroups; ++k) t += sums[k][lane];
  dgamma[c] = t;
}

struct BwdArgs {
  const bf16* x;
  const float* gamma;  // [width]
  const bf16* dy;
  bf16* dx;            // kDot: null
  float* partial;      // [blocks, width] scratch; kDx: null
  float* dgamma;       // [width]; kDx: null
  const float* rstd;   // kDot, kDx: [rows]
  float* dot;          // kDot: written; kDx: read, [rows]
  int rows, width;
  float eps, full;
};

template <int NV, Bwd B>
cudaError_t launch_bwd(const BwdArgs& a, int blocks, cudaStream_t st) {
  // gamma and (but for kDx) the row slots' dgamma rows
  constexpr int kRows = 1 + (B == Bwd::kDx ? 0 : kRowSlots);
  const int smem = kRows * a.width * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {  // room for the widest row
    cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<NV, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRows * kMaxWidth * (int)sizeof(float));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  rmsnorm_bwd_kernel<NV, B><<<blocks, kBwdThreads, smem, st>>>(
      a.x, a.gamma, a.dy, a.dx, a.partial, a.rows, a.width, a.eps, a.rstd,
      a.dot, a.full);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || B == Bwd::kDx) return e;
  rmsnorm_dgamma_kernel<<<(a.width + kSumCols - 1) / kSumCols,
                          kSumCols * kSumGroups, 0, st>>>(
      a.partial, a.dgamma, blocks, a.width);
  return cudaGetLastError();
}

// the checks of a backward launch, then launch_bwd<NV, B> for the row's
// width: NV vectors a lane
template <Bwd B>
int launch_rows_bwd(const BwdArgs& a, int blocks, void* stream) {
  if (a.rows < 1 || a.width < 8 || a.width % 8 || a.width > kMaxWidth ||
      blocks < 1 || a.full < a.width)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = (a.width / 8 + 127) / 128;
  if (nv <= 1) return launch_bwd<1, B>(a, blocks, st);
  if (nv <= 2) return launch_bwd<2, B>(a, blocks, st);
  return launch_bwd<4, B>(a, blocks, st);
}

// ---------------------------------------------------------------------------
// Backward of the Mamba2 grouped, gated norm (groups > 1 or a gate): rows of
// `width` <= 64 values, one per (token, group), each scaled by its group's
// gamma row; with a gate z the forward is out = n * silu(z), n = x * rstd *
// gamma[g].  With dn = dy * silu(z) (dy without a gate):
//   dx = rstd * (gamma * dn - xhat * mean(xhat * gamma * dn)),
//   dz = dy * n * silu'(z),  silu'(z) = sig(z) (1 + z (1 - sig(z))),
//   dgamma[g] = sum over tokens of dn * xhat.
// Bound by bytes like the block norm's backward: x, dy and z read once, dx
// and dz written once, at the training shape (2048 tokens x 112 heads of
// 64) 147 MB.  The design is token-major:
//   - a block takes a share of the tokens (ops.group_rmsnorm_bwd_plan,
//     plain Python: a contiguous run of them) and reads each token's whole
//     row, groups * width bf16 (14 KB at the training shape), contiguous;
//     the gate through its own token stride;
//   - the row is groups * 8 slots of 8 values (16-byte loads), a group's
//     width / 8 slots live and the rest idle (none at width 64); thread j
//     owns slots j, j + T, ... (K of them, T a multiple of 32), the same in
//     every row, so a group's 8 slots are 8 neighbouring lanes of one warp;
//   - a group's two sums (sum x^2 and sum x gamma dn) are shuffles among
//     its 8 lanes: no shared-memory exchange and no barrier per row;
//   - a thread loads all its slots of a row at once, then takes them one
//     by one (sums, shuffles, outputs), so few values stay live and two
//     blocks of 224 threads fit an SM at the training shape;
//   - each thread keeps its slots' dgamma sums over the block's tokens in
//     registers and writes them once as the block's partial row; gamma is
//     read once per block into shared memory;
//   - rmsnorm_dgamma_kernel sums the shares' partial rows in share order:
//     deterministic.
// ---------------------------------------------------------------------------

constexpr int kGrpLanes = 8;     // slots of a group: 8 vectors of 8 values
constexpr int kGrpWidth = kGrpLanes * 8;
constexpr int kGrpMaxThreads = 256;
constexpr int kGrpMaxSlots = 8 * kGrpMaxThreads;  // 8 slots a thread at most

struct GroupArgs {
  const bf16* x;       // [tokens, groups * width], x_stride apart
  const float* gamma;  // [groups, width]
  const bf16* dy;      // as x
  const bf16* gate;    // null: no gate; gate_stride apart
  bf16* dx;            // [tokens, groups * width] contiguous
  bf16* dgate;         // as dx, or null
  float* partial;      // [shares, groups, width]
  long long x_stride, gate_stride;
  int tokens, groups, width;
  float eps;
};

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 p = unpack(w[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                    pack(f[6], f[7]));
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// K slots a thread, blockDim.x threads (a multiple of 32)
template <int K, bool GATE>
__global__ void __launch_bounds__(kGrpMaxThreads)
    group_rmsnorm_bwd_kernel(const GroupArgs a) {
  extern __shared__ __align__(16) float gs[];  // gamma [groups * width]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int w = a.width, cols = a.groups * w;
  for (int c = 4 * tid; c < cols; c += 4 * nt)
    *reinterpret_cast<float4*>(gs + c) =
        *reinterpret_cast<const float4*>(a.gamma + c);
  int col[K];  // the first column of each slot; -1: idle
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = tid + k * nt, lane = q % kGrpLanes;
    col[k] = q < a.groups * kGrpLanes && 8 * lane < w
                 ? (q / kGrpLanes) * w + 8 * lane
                 : -1;
  }
  float dg[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) dg[k][i] = 0.0f;
  __syncthreads();  // gamma is in

  const float inv_w = 1.0f / static_cast<float>(w);
  const long long first = (long long)blockIdx.x * a.tokens / gridDim.x;
  const long long last = (long long)(blockIdx.x + 1) * a.tokens / gridDim.x;
  const long long row_out = cols;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (long long tok = first; tok < last; ++tok) {
    uint4 xr[K], dr[K], zr[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool on = col[k] >= 0;
      xr[k] = on ? *reinterpret_cast<const uint4*>(a.x + tok * a.x_stride +
                                                   col[k])
                 : zero;
      dr[k] = on ? *reinterpret_cast<const uint4*>(a.dy + tok * a.x_stride +
                                                   col[k])
                 : zero;
      if (GATE)
        zr[k] = on ? *reinterpret_cast<const uint4*>(
                         a.gate + tok * a.gate_stride + col[k])
                   : zero;
    }
    // slot by slot (all K slots' loads are in flight): a group's two sums
    // over its 8 lanes (idle lanes add zeros), then its outputs
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float xv[8], dv[8], zv[8];
      unpack8(xr[k], xv);
      unpack8(dr[k], dv);
      if (GATE) unpack8(zr[k], zv);
      const float* gm = gs + max(col[k], 0);
      float ss = 0.0f, dot = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dn = GATE ? dv[i] * zv[i] * sigmoid(zv[i]) : dv[i];
        ss += xv[i] * xv[i];
        dot += xv[i] * gm[i] * dn;
      }
#pragma unroll
      for (int o = 1; o < kGrpLanes; o *= 2) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (col[k] < 0) continue;
      const float r = rsqrtf(ss * inv_w + a.eps);
      const float m = r * r * r * dot * inv_w;  // rstd * mean(xhat*gamma*dn)
      float out[8], sg[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sg[i] = GATE ? sigmoid(zv[i]) : 1.0f;
        const float dn = GATE ? dv[i] * zv[i] * sg[i] : dv[i];
        out[i] = r * gm[i] * dn - xv[i] * m;
        dg[k][i] += dn * xv[i] * r;
      }
      *reinterpret_cast<uint4*>(a.dx + tok * row_out + col[k]) = pack8(out);
      if (GATE) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          out[i] = dv[i] * xv[i] * r * gm[i] * sg[i] *
                   (1.0f + zv[i] * (1.0f - sg[i]));
        *reinterpret_cast<uint4*>(a.dgate + tok * row_out + col[k]) =
            pack8(out);
      }
    }
  }
  // the block's partial dgamma row: each column is one thread's
  float* prow = a.partial + (size_t)blockIdx.x * cols;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (col[k] < 0) continue;
    float4* d = reinterpret_cast<float4*>(prow + col[k]);
    d[0] = make_float4(dg[k][0], dg[k][1], dg[k][2], dg[k][3]);
    d[1] = make_float4(dg[k][4], dg[k][5], dg[k][6], dg[k][7]);
  }
}

template <int K>
cudaError_t launch_group_bwd(const GroupArgs& a, int threads, int shares,
                             cudaStream_t st) {
  const int smem = a.groups * a.width * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {  // room for the widest row
    cudaError_t e = cudaFuncSetAttribute(
        group_rmsnorm_bwd_kernel<K, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGrpMaxSlots * 8 * (int)sizeof(float));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(group_rmsnorm_bwd_kernel<K, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGrpMaxSlots * 8 * (int)sizeof(float));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  if (a.gate)
    group_rmsnorm_bwd_kernel<K, true><<<shares, threads, smem, st>>>(a);
  else
    group_rmsnorm_bwd_kernel<K, false><<<shares, threads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx [rows, width] contiguous bf16 (16-byte-aligned bases), gamma and
// dgamma [width] fp32 (16-byte aligned), partial [blocks, width] fp32
// scratch; width a multiple of 8 up to 4096, blocks >= 1 (ops.rmsnorm_backward
// sizes the grid: 3 rows a block at a time).  Two launches: the rows (each block also writing its
// partial dgamma row), then the block-ordered sum of the partial rows.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_rmsnorm_bwd_bf16(const void* x, const void* gamma,
                                      const void* dy, void* dx, void* partial,
                                      void* dgamma, int rows, int width,
                                      float eps, int blocks, void* stream) {
  BwdArgs a{static_cast<const bf16*>(x), static_cast<const float*>(gamma),
            static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
            static_cast<float*>(partial), static_cast<float*>(dgamma),
            nullptr, nullptr, rows, width, eps, static_cast<float>(width)};
  return launch_rows_bwd<Bwd::kWhole>(a, blocks, stream);
}

// The grouped, gated norm: x and dy rows of groups * width bf16, x_stride
// apart; gate (or null) gate_stride apart; gamma and dgamma [groups, width]
// fp32; dx and dgate (null without a gate) [tokens, groups * width]
// contiguous bf16; width a multiple of 8 up to 64; every pointer 16-byte
// aligned, the strides multiples of 8.  The plan (ops.group_rmsnorm_bwd_plan):
// shares blocks of threads threads (a multiple of 32, at most 256), each
// thread vectors (1, 2, 4 or 8) slots, threads * vectors >= groups * 8;
// partial [shares, groups, width] fp32 scratch.  Two launches: the rows
// (each block also writing its partial dgamma row), then the share-ordered
// sum of the partial rows.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int repro_group_rmsnorm_bwd_bf16(
    const void* x, const void* gamma, const void* dy, const void* gate,
    void* dx, void* dgate, void* partial, void* dgamma, long long x_stride,
    long long gate_stride, int tokens, int groups, int width, float eps,
    int threads, int vectors, int shares, void* stream) {
  if (tokens < 1 || groups < 1 || width < 8 || width % 8 ||
      width > kGrpWidth || shares < 1 || threads < 32 || threads % 32 ||
      threads > kGrpMaxThreads || threads * vectors < groups * kGrpLanes ||
      (gate != nullptr) != (dgate != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GroupArgs a{static_cast<const bf16*>(x), static_cast<const float*>(gamma),
              static_cast<const bf16*>(dy), static_cast<const bf16*>(gate),
              static_cast<bf16*>(dx), static_cast<bf16*>(dgate),
              static_cast<float*>(partial), x_stride, gate_stride, tokens,
              groups, width, eps};
  cudaError_t e;
  switch (vectors) {
    case 1: e = launch_group_bwd<1>(a, threads, shares, st); break;
    case 2: e = launch_group_bwd<2>(a, threads, shares, st); break;
    case 4: e = launch_group_bwd<4>(a, threads, shares, st); break;
    case 8: e = launch_group_bwd<8>(a, threads, shares, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const int cols = groups * width;
  rmsnorm_dgamma_kernel<<<(cols + kSumCols - 1) / kSumCols,
                          kSumCols * kSumGroups, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dgamma), shares,
      cols);
  return cudaGetLastError();
}

// The four launches of the split norm, each a mode of the kernels above.
// x and dy [rows, width] contiguous bf16, gamma [width] fp32, the per-row
// ss, rstd and dot fp32 [rows], every pointer 16-byte aligned; width (this
// rank's slice) a multiple of 8 up to 4096, full the whole row's width.
// The forward pieces take ops.rmsnorm_plan's T threads a row of N vectors
// and rows_per_block rows a block, as the whole-row forward; the backward
// pieces take blocks blocks (ops sizes them as the whole-row backward's
// grid), the partial also partial [blocks, width] fp32 scratch.  Each
// returns the cudaError_t of its launches (0 on success).
extern "C" int repro_rmsnorm_ss_bf16(const void* x, void* ss, int rows,
                                     int width, int T, int N,
                                     int rows_per_block, void* stream) {
  Args a{static_cast<const bf16*>(x), nullptr, nullptr, nullptr, width, 0,
         rows, 1, width, 0.0f, static_cast<float*>(ss), nullptr, 0.0f};
  return launch_rows<Mode::kSumSquares>(a, T, N, rows_per_block, stream);
}

extern "C" int repro_rmsnorm_apply_bf16(const void* x, const void* gamma,
                                        const void* ss, void* out, void* rstd,
                                        int rows, int width, float full,
                                        float eps, int T, int N,
                                        int rows_per_block, void* stream) {
  Args a{static_cast<const bf16*>(x), static_cast<const float*>(gamma),
         nullptr, static_cast<bf16*>(out), width, 0, rows, 1, width, eps,
         const_cast<float*>(static_cast<const float*>(ss)),
         static_cast<float*>(rstd), full};
  return launch_rows<Mode::kApply>(a, T, N, rows_per_block, stream);
}

extern "C" int repro_rmsnorm_bwd_partial_bf16(
    const void* x, const void* gamma, const void* dy, const void* rstd,
    void* dot, void* partial, void* dgamma, int rows, int width, int blocks,
    void* stream) {
  BwdArgs a{static_cast<const bf16*>(x), static_cast<const float*>(gamma),
            static_cast<const bf16*>(dy), nullptr,
            static_cast<float*>(partial), static_cast<float*>(dgamma),
            static_cast<const float*>(rstd), static_cast<float*>(dot), rows,
            width, 0.0f, static_cast<float>(width)};
  return launch_rows_bwd<Bwd::kDot>(a, blocks, stream);
}

extern "C" int repro_rmsnorm_bwd_apply_bf16(const void* x, const void* gamma,
                                            const void* dy, const void* rstd,
                                            const void* dot, void* dx,
                                            int rows, int width, float full,
                                            int blocks, void* stream) {
  BwdArgs a{static_cast<const bf16*>(x), static_cast<const float*>(gamma),
            static_cast<const bf16*>(dy), static_cast<bf16*>(dx), nullptr,
            nullptr, static_cast<const float*>(rstd),
            const_cast<float*>(static_cast<const float*>(dot)), rows, width,
            0.0f, full};
  return launch_rows_bwd<Bwd::kDx>(a, blocks, stream);
}
