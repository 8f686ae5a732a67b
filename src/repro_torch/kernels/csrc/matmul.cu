// Tiled bf16 GEMM with an fp32 accumulator and a fused bias/activation
// epilogue, for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces: src/repro/kernels/matmul.py::matmul (body _mm_kernel, epilogue
// _epilogue, pallas_call at line 102), bf16 mode.  C[M,N] = A[M,K] @ B[K,N],
// then per element, in the TPU kernel's order: + bias[N], then gelu-tanh or
// silu, cast to bf16.  The int8 `scale` mode of the TPU kernel is not here.
//
// What bounds it on the H100: on the serving path M is either a prefill
// chunk (64 rows) or the decode slots (4 rows), and K*N is a weight matrix
// of 16-470 MB.  At M=4 the GEMM does ~4 flops per weight byte, far below the
// ~295 flop/byte ridge, so it is bound by the bytes of B; at M=64 it is
// still below the ridge.  So the design is about streaming B:
//   - B tiles go global->shared with 16-byte cp.async in a 3-stage ring, so
//     two tiles are in flight while the tensor cores work on the third;
//   - two tile shapes: 16x64 tiles when M <= 16 (decode) so that a weight
//     matrix is cut into many blocks and the card has enough loads in flight,
//     64x128 tiles otherwise;
//   - the tensor cores are reached through WMMA 16x16x16 bf16 fragments with
//     fp32 accumulators (wgmma/TMA are later work);
//   - B may be stored transposed ([N,K], e.g. a tied embedding used as the
//     head): the tile is then loaded K-contiguous and read as a col_major
//     fragment, so no transposed copy is made;
//   - ragged M, N and K are masked in the loads (zero fill) and the stores:
//     there is no host padding.  The 16-byte path needs K % 8 == 0 and
//     (for row-major B) N % 8 == 0 with 16-byte-aligned bases; otherwise the
//     same kernel loads element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kPad = 8;  // bf16 elements of row padding in shared tiles

enum Activation { kNone = 0, kGelu = 1, kSilu = 2 };

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Load a ROWS x COLS tile whose columns are contiguous in global memory
// (leading dimension ld) from (r0, c0) of an R x C matrix into shared memory
// with row stride lds.  Out-of-range elements read as zero.
template <int ROWS, int COLS, int NT, bool VEC>
__device__ __forceinline__ void load_tile(bf16* s, int lds, const bf16* g,
                                          int ld, int r0, int c0, int R,
                                          int C, int tid) {
  if constexpr (VEC) {
    constexpr int kChunks = ROWS * COLS / 8;
#pragma unroll
    for (int idx = tid; idx < kChunks; idx += NT) {
      int r = idx / (COLS / 8);
      int c = (idx % (COLS / 8)) * 8;
      int gr = r0 + r, gc = c0 + c;
      bool p = gr < R && gc < C;  // C % 8 == 0 on this path
      const bf16* src = p ? g + (size_t)gr * ld + gc : g;
      cp_async16(s + r * lds + c, src, p);
    }
  } else {
    for (int idx = tid; idx < ROWS * COLS; idx += NT) {
      int r = idx / COLS, c = idx % COLS;
      int gr = r0 + r, gc = c0 + c;
      s[r * lds + c] = (gr < R && gc < C) ? g[(size_t)gr * ld + gc]
                                          : __float2bfloat16(0.0f);
    }
  }
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  if (act == kSilu) return x / (1.0f + expf(-x));
  return x;
}

template <int BM, int BN, int BK, bool BT>
struct TileGeometry {
  static constexpr int kLdA = BK + kPad;
  static constexpr int kLdB = BT ? BK + kPad : BN + kPad;
  static constexpr int kABytes = BM * kLdA * 2;
  static constexpr int kBBytes = (BT ? BN * kLdB : BK * kLdB) * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
};

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          bool BT, bool VEC>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    mm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
              const bf16* __restrict__ bias, bf16* __restrict__ C, int M,
              int N, int K, int act) {
  using G = TileGeometry<BM, BN, BK, BT>;
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  static_assert(G::kABytes % 128 == 0 && G::kBBytes % 128 == 0,
                "shared tiles must keep 128-byte alignment");

  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem + STAGES * G::kStageBytes);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  auto a_tile = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * G::kStageBytes);
  };
  auto b_tile = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * G::kStageBytes + G::kABytes);
  };
  auto load_stage = [&](int s, int kt) {
    int k0 = kt * BK;
    load_tile<BM, BK, NT, VEC>(a_tile(s), G::kLdA, A, K, m0, k0, M, K, tid);
    if constexpr (BT) {
      load_tile<BN, BK, NT, VEC>(b_tile(s), G::kLdB, B, K, n0, k0, N, K, tid);
    } else {
      load_tile<BK, BN, NT, VEC>(b_tile(s), G::kLdB, B, N, k0, n0, K, N, tid);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  using BLayout = typename std::conditional<BT, wmma::col_major,
                                            wmma::row_major>::type;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage refilled here was read in iteration kt-1, which every
    // thread has finished: they all passed the barrier above
    int nxt = kt + STAGES - 1;
    if (nxt < KT) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const bf16* As = a_tile(kt % STAGES);
    const bf16* Bs = b_tile(kt % STAGES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * G::kLdA + kk,
                               G::kLdA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const bf16* p = BT ? Bs + (wn * WN + j * 16) * G::kLdB + kk
                           : Bs + kk * G::kLdB + wn * WN + j * 16;
        wmma::load_matrix_sync(fb[j], p, G::kLdB);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: each warp stages one 16x16 fragment at a time in its own
  // scratch, then applies bias and activation and stores the in-range part
  float* ws = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(ws, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      int rb = m0 + wm * WM + i * 16, cb = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        int r = rb + e / 16, c = cb + e % 16;
        if (r < M && c < N) {
          float v = ws[e];
          if (bias != nullptr) v += __bfloat162float(bias[c]);
          C[(size_t)r * N + c] = __float2bfloat16(activate(v, act));
        }
      }
      __syncwarp();
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          bool BT, bool VEC>
cudaError_t launch(const bf16* a, const bf16* b, const bf16* bias, bf16* c,
                   int M, int N, int K, int act, cudaStream_t stream) {
  using G = TileGeometry<BM, BN, BK, BT>;
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int kSmem = STAGES * G::kStageBytes + (NT / 32) * 256 * 4;
  auto kernel = mm_kernel<BM, BN, BK, WARPS_M, WARPS_N, STAGES, BT, VEC>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, NT, kSmem, stream>>>(a, b, bias, c, M, N, K, act);
  return cudaGetLastError();
}

template <bool BT, bool VEC>
cudaError_t dispatch(const bf16* a, const bf16* b, const bf16* bias, bf16* c,
                     int M, int N, int K, int act, cudaStream_t stream) {
  if (M <= 16)
    return launch<16, 64, 64, 1, 4, 3, BT, VEC>(a, b, bias, c, M, N, K, act,
                                                stream);
  return launch<64, 128, 32, 2, 4, 3, BT, VEC>(a, b, bias, c, M, N, K, act,
                                               stream);
}

}  // namespace

// a [M,K] row-major; b [K,N] row-major, or (b_trans) stored [N,K] row-major;
// bias [N] or null; c [M,N] row-major.  act: 0 none, 1 gelu-tanh, 2 silu.
// vec: 1 when the 16-byte load path applies (see the header note).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_matmul_bf16(const void* a, const void* b,
                                 const void* bias, void* c, int M, int N,
                                 int K, int b_trans, int act, int vec,
                                 void* stream) {
  auto A = static_cast<const bf16*>(a);
  auto B = static_cast<const bf16*>(b);
  auto bs = static_cast<const bf16*>(bias);
  auto Cp = static_cast<bf16*>(c);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (b_trans) {
    return vec ? dispatch<true, true>(A, B, bs, Cp, M, N, K, act, st)
               : dispatch<true, false>(A, B, bs, Cp, M, N, K, act, st);
  }
  return vec ? dispatch<false, true>(A, B, bs, Cp, M, N, K, act, st)
             : dispatch<false, false>(A, B, bs, Cp, M, N, K, act, st);
}
