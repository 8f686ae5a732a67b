// The derivative of the matmul epilogue's activation, dz = dy * act'(z),
// for bf16 dy and pre-activation z [M, N], in fp32, cast back to bf16, for
// sm_90a, bound through a plain C interface.
//
// Replaces: no pallas_call of its own.  src/repro/kernels/matmul.py's
// fused epilogue (_epilogue, line 47; pallas_call at line 102) applies
// gelu-tanh or silu inside the GEMM, and the reference's training step
// differentiates it with XLA.  The port's matmul kernel writes the
// pre-activation z beside its output under autograd (matmul.cu), and this
// kernel takes the activation's derivative at z in the backward, before
// the two GEMMs of the matmul's backward read dz.  Its plain version is
// kernels/ref.py::epilogue_bwd, whose formulas it computes.
//
// What bounds it on the H100: 6 bytes an element (dy and z read, dz
// written) against some thirty operations, so the 3.35 TB/s of device
// memory; at gpt-m2's up projection (2048 x 16384) 201 MB, 0.060 ms.  The
// element's arithmetic must hide under its bytes: with tanhf and every
// product rounded on its own it took some forty instructions an element.
// The design: tanh (gelu) and the sigmoid (silu) by ex2 and rcp, the
// products contracted into FMAs (about a dozen operations an element);
// one 16-byte load of each operand a thread, over a grid that covers the
// tensor once (a block a contiguous run of 2048 elements, no stride
// loop); the scalar elements past the vectors (or every element where a
// base is not 16-byte aligned) one a thread.  Measured on the card, two,
// four or eight loads an operand in flight per thread, and a grid sized
// by the blocks an SM holds with a stride loop, were each slower.  The
// result differs from the plain version by rounding: within one bf16 ulp
// of it.  Where the plain version's own fp32 rounding decides the value
// (gelu below z = -3.5, where 1 + tanh and 1 - tanh^2 cancel to a few
// ulps of fp32, and outside the ranges the fast forms cover) an element
// takes the plain version's arithmetic (act_grad_exact), a branch few
// elements take.  The activation is a template argument.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

enum Activation { kGelu = 1, kSilu = 2 };

constexpr int kThreads = 256;

// act'(z): kernels/ref.py::epilogue_bwd's fp32 formulas, each product and
// sum rounded on its own (no contraction into FMAs), in the plain
// version's order, so that the two differ only where tanhf or expf does
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

template <int ACT>
__device__ __noinline__ float act_grad_exact(float z) {
  if constexpr (ACT == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    const float k = 0.044715f, k3 = static_cast<float>(3 * 0.044715);
    const float th = tanhf(mul(c, add(z, mul(k, mul(mul(z, z), z)))));
    const float d1 = mul(0.5f, add(1.0f, th));
    const float d2 = mul(mul(mul(mul(0.5f, z), add(1.0f, -mul(th, th))), c),
                         add(1.0f, mul(mul(k3, z), z)));
    return add(d1, d2);
  } else {
    const float sg = 1.0f / (1.0f + expf(-z));
    return mul(sg, add(1.0f, mul(z, add(1.0f, -sg))));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kC = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kK = 0.044715f;
// gelu'(z) by these forms for z in [kGeluLo, kGeluHi], silu'(z) for
// |z| <= kSiluHi; beyond, act_grad_exact (where the plain version rounds
// 1 + tanh to a few ulps, or where z^2 or e^-z leaves fp32's range)
constexpr float kGeluLo = -3.5f, kGeluHi = 16.0f, kSiluHi = 80.0f;

// act'(z) by ex2 and rcp.  gelu: with u = c (z + k z^3) and r = 1 / (1 +
// e^(2u)), tanh u = 1 - 2r, so act' = (1 - r) (1 + 2 c z r (1 + 3 k
// z^2)).  silu: with s = 1 / (1 + e^-z), act' = s (1 + z (1 - s)), 1 - s
// taken as e^-z s where s is near 1.
template <int ACT>
__device__ __forceinline__ float act_grad(float z) {
  if constexpr (ACT == kGelu) {
    if (!(z >= kGeluLo && z <= kGeluHi)) return act_grad_exact<ACT>(z);
    const float z2 = z * z;
    const float e = ex2(z * fmaf(2.0f * kC * kK * kLog2e, z2,
                                 2.0f * kC * kLog2e));  // e^(2u)
    const float r = rcp(1.0f + e);
    return (1.0f - r) * fmaf(2.0f * kC * z * r, fmaf(3.0f * kK, z2, 1.0f),
                             1.0f);
  } else {
    if (!(fabsf(z) <= kSiluHi)) return act_grad_exact<ACT>(z);
    const float e = ex2(-kLog2e * z);  // e^-z
    const float sg = rcp(1.0f + e);
    const float om = z > 0.0f ? e * sg : 1.0f - sg;
    return sg * fmaf(z, om, 1.0f);
  }
}

// two packed bf16 of dz from two of dy and two of z
template <int ACT>
__device__ __forceinline__ uint32_t pair(uint32_t dy, uint32_t z) {
  const float2 g = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&dy));
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&z));
  __nv_bfloat162 out =
      __floats2bfloat162_rn(g.x * act_grad<ACT>(x.x), g.y * act_grad<ACT>(x.y));
  return *reinterpret_cast<uint32_t*>(&out);
}

template <int ACT>
__device__ __forceinline__ uint4 eight(const uint4& g, const uint4& x) {
  return make_uint4(pair<ACT>(g.x, x.x), pair<ACT>(g.y, x.y),
                    pair<ACT>(g.z, x.z), pair<ACT>(g.w, x.w));
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
    act_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ z,
                   bf16* __restrict__ dz, long long n, long long n8) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n8)
    reinterpret_cast<uint4*>(dz)[i] =
        eight<ACT>(__ldg(reinterpret_cast<const uint4*>(dy) + i),
                   __ldg(reinterpret_cast<const uint4*>(z) + i));
  const long long j = 8 * n8 + i;  // the scalar elements
  if (j < n)
    dz[j] = __float2bfloat16(__bfloat162float(dy[j]) *
                             act_grad<ACT>(__bfloat162float(z[j])));
}

template <int ACT>
cudaError_t launch(const bf16* dy, const bf16* z, bf16* dz, long long n,
                   long long n8, cudaStream_t stream) {
  const long long work = n8 > n - 8 * n8 ? n8 : n - 8 * n8;
  const long long blocks = (work + kThreads - 1) / kThreads;
  act_bwd_kernel<ACT><<<(unsigned)blocks, kThreads, 0, stream>>>(dy, z, dz,
                                                                n, n8);
  return cudaGetLastError();
}

}  // namespace

// dy, z, dz: n bf16 elements each, contiguous.  act: 1 gelu-tanh, 2 silu.
// vec: 1 when all three bases are 16-byte aligned (the 8-element vector
// path), 0 takes every element on the scalar path.  sms: the card's
// streaming multiprocessors (unused: the grid covers the tensor once).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_act_bwd_bf16(const void* dy, const void* z, void* dz,
                                  long long n, int act, int vec, int sms,
                                  void* stream) {
  if (n <= 0 || sms <= 0) return cudaErrorInvalidValue;
  const long long n8 = vec ? n / 8 : 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const bf16*>(dy);
  auto x = static_cast<const bf16*>(z);
  auto out = static_cast<bf16*>(dz);
  if (act == kGelu) return launch<kGelu>(g, x, out, n, n8, st);
  if (act == kSilu) return launch<kSilu>(g, x, out, n, n8, st);
  return cudaErrorInvalidValue;
}
