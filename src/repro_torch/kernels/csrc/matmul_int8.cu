// The matmul kernel's int8 `scale` mode (the TPU kernel's `has_scale`):
// c[M,N] = act(float(a[M,K] @ b[K,N]) * scale + bias[N]), a and b int8
// row-major, the products accumulated over K in int32 (exact) on the int8
// tensor cores (mma.sync m16n8k32 s8.s8.s32), then per element, in the TPU
// kernel's order: the f32 dequant scale FIRST, then + bias (bf16, read as
// f32), then gelu-tanh or silu, cast to bf16 or written as f32.
//
// A block computes a BM x 128 tile (BM 64 or 128) with 8 warps, 2 (M) x 4
// (N), each a (BM/2) x 32 tile of m16n8 products, over K steps of 64.  a's
// rows are K-major as the MMA's A operand wants them.  b is row-major
// [K, N], and the MMA wants its columns K-major (ldmatrix.trans moves only
// 16-bit elements): each thread reads a 4 (k) x 4 (n) block of b as four
// 32-bit words, transposes it in registers with byte permutes and stores
// four words of 4 consecutive k, so that shared memory holds b^T [128][64].
// The next K step's global loads are issued into registers before this
// step's products, and stored after them.  Rows of shared memory are
// padded to 80 bytes (20 words), so the fragment loads of a warp's eight
// row groups fall in distinct banks.
//
// Takes K % 16 == 0 and N % 4 == 0 with 16-byte aligned a and 4-byte
// aligned b (the wrapper checks); rows beyond M, and K or N beyond a tile,
// read as zeros.  Its own library (`matmul_int8`): the bf16 kernel's
// instances are not rebuilt with it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128, kBK = 64, kThreads = 256;
constexpr int kRow = kBK + 16;  // bytes per shared-memory row (20 words)
enum { kNone = 0, kGelu = 1, kSilu = 2 };

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  if (act == kSilu) return x / (1.0f + expf(-x));
  return x;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Global loads of one K step: a's tile is BM rows of 64 bytes (4 uint4 a
// row), b's tile 64 x 128 bytes as 4 x 4 blocks (512 of them).
template <int BM>
struct Stage {
  static constexpr int kA = BM * kBK / 16 / kThreads;   // uint4 a thread
  static constexpr int kB = kBK * kBN / 16 / kThreads;  // 4x4 blocks a thread
  uint4 a[kA];
  uint32_t b[kB][4];
};

template <int BM>
__device__ __forceinline__ void load(Stage<BM>& st, const int8_t* a,
                                     const int8_t* b, int M, int N, int K,
                                     int m0, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < Stage<BM>::kA; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kBK / 16), c = (idx % (kBK / 16)) * 16;
    const int m = m0 + r, k = k0 + c;
    st.a[i] = (m < M && k < K)
                  ? *reinterpret_cast<const uint4*>(a + (size_t)m * K + k)
                  : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < Stage<BM>::kB; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int kb = idx / (kBN / 4), nb = idx % (kBN / 4);
    const int n = n0 + nb * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + kb * 4 + j;
      st.b[i][j] = (k < K && n < N)
                       ? *reinterpret_cast<const uint32_t*>(
                             b + (size_t)k * N + n)
                       : 0u;
    }
  }
}

template <int BM>
__device__ __forceinline__ void store(const Stage<BM>& st, int8_t* as,
                                      int8_t* bs) {
#pragma unroll
  for (int i = 0; i < Stage<BM>::kA; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kBK / 16), c = (idx % (kBK / 16)) * 16;
    uint32_t* dst = reinterpret_cast<uint32_t*>(as + r * kRow + c);
    dst[0] = st.a[i].x;
    dst[1] = st.a[i].y;
    dst[2] = st.a[i].z;
    dst[3] = st.a[i].w;
  }
#pragma unroll
  for (int i = 0; i < Stage<BM>::kB; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int kb = idx / (kBN / 4), nb = idx % (kBN / 4);
    // rows j = k offset, bytes c = n offset; out word c holds byte c of
    // every row, k ascending
    const uint32_t r0 = st.b[i][0], r1 = st.b[i][1], r2 = st.b[i][2],
                   r3 = st.b[i][3];
    const uint32_t t01lo = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
    const uint32_t t23lo = __byte_perm(r2, r3, 0x5140);
    const uint32_t t01hi = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
    const uint32_t t23hi = __byte_perm(r2, r3, 0x7362);
    const uint32_t w0 = __byte_perm(t01lo, t23lo, 0x5410);
    const uint32_t w1 = __byte_perm(t01lo, t23lo, 0x7632);
    const uint32_t w2 = __byte_perm(t01hi, t23hi, 0x5410);
    const uint32_t w3 = __byte_perm(t01hi, t23hi, 0x7632);
    int8_t* col = bs + (nb * 4) * kRow + kb * 4;
    *reinterpret_cast<uint32_t*>(col) = w0;
    *reinterpret_cast<uint32_t*>(col + kRow) = w1;
    *reinterpret_cast<uint32_t*>(col + 2 * kRow) = w2;
    *reinterpret_cast<uint32_t*>(col + 3 * kRow) = w3;
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
    matmul_int8_kernel(const int8_t* __restrict__ a,
                       const int8_t* __restrict__ b,
                       const __nv_bfloat16* bias,
                       void* c, int M, int N, int K, float scale, int act,
                       int out_f32) {
  constexpr int WM = BM / 2;   // rows of a warp's tile
  constexpr int TM = WM / 16;  // m16 tiles of a warp
  __shared__ __align__(16) int8_t as[BM * kRow];
  __shared__ __align__(16) int8_t bs[kBN * kRow];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * 32;
  const int g = lane / 4, t = lane % 4;

  int acc[TM][4][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Stage<BM> st;
  load<BM>(st, a, b, M, N, K, m0, n0, 0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    store<BM>(st, as, bs);
    __syncthreads();
    if (k0 + kBK < K) load<BM>(st, a, b, M, N, K, m0, n0, k0 + kBK);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[TM][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int8_t* p = as + (wm + i * 16 + g) * kRow + ks + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (wn + j * 8 + g) * kRow + ks + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }

  // epilogue: rows g and g + 8 of each m16 tile, columns 2t and 2t + 1
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        const int n = n0 + wn + j * 8 + 2 * t;
        if (m >= M || n >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // _rn: no fused multiply-add, the plain version's two roundings
          float x = __fmul_rn((float)acc[i][j][2 * h + e], scale);
          if (bias != nullptr)
            x = __fadd_rn(x, __bfloat162float(bias[n + e]));
          v[e] = activate(x, act);
        }
        if (out_f32) {
          float* o = static_cast<float*>(c) + (size_t)m * N + n;
          o[0] = v[0];
          o[1] = v[1];
        } else {
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(c) + (size_t)m * N + n);
          *o = __floats2bfloat162_rn(v[0], v[1]);
        }
      }
}

}  // namespace

// a [M,K] and b [K,N] int8 row-major; bias [N] bf16 or null; c [M,N]
// row-major, bf16 (out_f32 0) or f32 (out_f32 1).  act: 0 none, 1
// gelu-tanh, 2 silu.  bm: the tile's rows, 64 or 128.
extern "C" int repro_matmul_int8(const void* a, const void* b,
                                 const void* bias, void* c, int M, int N,
                                 int K, float scale, int act, int out_f32,
                                 int bm, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 4) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int8_t*>(a);
  auto pb = static_cast<const int8_t*>(b);
  auto pbias = static_cast<const __nv_bfloat16*>(bias);
  const dim3 grid((N + kBN - 1) / kBN, (M + bm - 1) / bm);
  if (bm == 64) {
    matmul_int8_kernel<64><<<grid, kThreads, 0, st>>>(pa, pb, pbias, c, M, N,
                                                      K, scale, act, out_f32);
  } else if (bm == 128) {
    matmul_int8_kernel<128><<<grid, kThreads, 0, st>>>(pa, pb, pbias, c, M,
                                                       N, K, scale, act,
                                                       out_f32);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
