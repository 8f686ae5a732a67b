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
// kernels/ref.py::epilogue_bwd, whose arithmetic it repeats.
//
// What bounds it on the H100: 6 bytes an element (dy and z read, dz
// written) against about 30 flops, so the 3.35 TB/s of device memory; at
// gpt-m2's up projection (2048 x 16384) 201 MB, 0.060 ms.  The design: 16-
// byte vector loads and stores of 8 elements a thread, grid-stride over a
// grid that fills every SM, and a scalar tail for the last n % 8 elements
// (or for all of them where a base is not 16-byte aligned).  The
// activation is a template argument.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

enum Activation { kGelu = 1, kSilu = 2 };

constexpr int kThreads = 256;
// blocks per SM of the grid-stride loop: 8 x 256 threads fill an SM
constexpr int kBlocksPerSm = 8;

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
__device__ __forceinline__ float act_grad(float z) {
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
__global__ void __launch_bounds__(kThreads)
    act_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ z,
                   bf16* __restrict__ dz, long long n, long long n8) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < n8; i += stride) {
    const uint4 g = __ldg(reinterpret_cast<const uint4*>(dy) + i);
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(z) + i);
    reinterpret_cast<uint4*>(dz)[i] =
        make_uint4(pair<ACT>(g.x, x.x), pair<ACT>(g.y, x.y),
                   pair<ACT>(g.z, x.z), pair<ACT>(g.w, x.w));
  }
  for (long long i = 8 * n8 + first; i < n; i += stride)
    dz[i] = __float2bfloat16(__bfloat162float(dy[i]) *
                             act_grad<ACT>(__bfloat162float(z[i])));
}

}  // namespace

// dy, z, dz: n bf16 elements each, contiguous.  act: 1 gelu-tanh, 2 silu.
// vec: 1 when all three bases are 16-byte aligned (the 8-element vector
// path), 0 takes every element on the scalar path.  sms: the card's
// streaming multiprocessors (the grid fills them).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_act_bwd_bf16(const void* dy, const void* z, void* dz,
                                  long long n, int act, int vec, int sms,
                                  void* stream) {
  if (n <= 0 || sms <= 0) return cudaErrorInvalidValue;
  const long long n8 = vec ? n / 8 : 0;
  const long long work = n8 > 0 ? n8 : n - 8 * n8;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (long long)kBlocksPerSm * sms) blocks = kBlocksPerSm * sms;
  auto st = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const bf16*>(dy);
  auto x = static_cast<const bf16*>(z);
  auto out = static_cast<bf16*>(dz);
  if (act == kGelu) {
    act_bwd_kernel<kGelu><<<(int)blocks, kThreads, 0, st>>>(g, x, out, n, n8);
  } else if (act == kSilu) {
    act_bwd_kernel<kSilu><<<(int)blocks, kThreads, 0, st>>>(g, x, out, n, n8);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
