// Online-softmax attention over per-row offsets and lengths, bf16 in/out,
// for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel, pallas_call at line 102) and its GQA wrapper in
// src/repro/kernels/ops.py.  It computes the mask of
// src/repro/models/layers.py::attention_core, which the TPU kernel covers
// only for q_offset = 0 and kv_len = sk:
//   qpos = q_offset[b] + i;  key j is visible when  j < kv_len[b],
//   j <= qpos (causal),  j > qpos - window (window > 0).
// Scores are q.k / sqrt(d), optionally softcap * tanh(s / softcap); the
// running max, sum and accumulator are fp32.  A row with no visible key
// writes zeros.
//
// What bounds it on the H100: on the serving path the work per call is
// small (a 64-row prefill chunk or one decode row per slot against at most
// a few hundred cached keys), so the bytes of K and V bound it, far from the
// tensor cores.  The design keeps those bytes to one read:
//   - one block per (q tile of 16 rows, q head, batch row); the block walks
//     the key tiles in a loop (the TPU's sequential grid axis becomes this
//     loop) and skips tiles the mask hides entirely (beyond kv_len, past the
//     causal diagonal, before the window);
//   - GQA reads kv head h / (hq / hkv) directly: no repeated K/V is formed;
//   - K and V tiles of 64 keys are staged in shared memory (K rows padded
//     so that threads reading different keys hit different banks), scores
//     and probabilities never leave shared memory;
//   - the products are fp32 FMA on CUDA cores.  Tensor-core (mma) versions
//     and a kernel that reads K/V pages through the page table are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;   // query rows per block
constexpr int kBKV = 64;  // keys per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                 const bf16* __restrict__ V, bf16* __restrict__ O,
                 const int* __restrict__ q_offset,
                 const int* __restrict__ kv_len, int sq, int skv, int hq,
                 int hkv, int causal, int window, float softcap,
                 float scale) {
  constexpr int kLdK = D + 2;              // padded K rows (bank spread)
  // PV product: thread t owns column t % D of rows t / D + i * kGroups.
  // D need not divide kThreads: at D = 112 one group of 112 threads covers
  // every column and the last 16 threads sit the PV product out.
  constexpr int kGroups = kThreads / D;
  constexpr int kRowsPerThread = kBQ / kGroups;
  static_assert(kGroups >= 1 && kBQ % kGroups == 0, "PV row mapping");
  constexpr int kScoresPerThread = kBQ * kBKV / kThreads;

  __shared__ float Qs[kBQ][D];
  __shared__ __align__(16) bf16 Ks[kBKV * kLdK];
  __shared__ __align__(16) bf16 Vs[kBKV * D];
  __shared__ float Ss[kBQ][kBKV + 1];
  __shared__ float row_m[kBQ], row_l[kBQ], row_alpha[kBQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int qoff = q_offset[b];
  const int klen = min(kv_len[b], skv);

  const size_t q_row = (size_t)hq * D;
  const size_t kv_row = (size_t)hkv * D;
  const bf16* Qb = Q + (size_t)b * sq * q_row + (size_t)h * D;
  const bf16* Kb = K + (size_t)b * skv * kv_row + (size_t)kvh * D;
  const bf16* Vb = V + (size_t)b * skv * kv_row + (size_t)kvh * D;
  bf16* Ob = O + (size_t)b * sq * q_row + (size_t)h * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    int r = e / D, c = e % D;
    Qs[r][c] = (q0 + r < sq)
                   ? __bfloat162float(Qb[(size_t)(q0 + r) * q_row + c]) * scale
                   : 0.0f;
  }
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.0f;
  }

  // key range any row of this tile can see
  const int q_last = qoff + min(sq, q0 + kBQ) - 1;
  int k_end = klen;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, qoff + q0 - window + 1) / kBKV * kBKV;

  const int pv_col = tid % D;
  const int pv_group = tid / D;
  const bool pv_active = pv_group < kGroups;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;

  const int s_col = tid % kBKV;              // key of this thread's scores
  const int s_row0 = tid / kBKV;             // first of its query rows
  constexpr int kRowStep = kThreads / kBKV;  // stride between its rows

  for (int k0 = k_begin; k0 < k_end; k0 += kBKV) {
    __syncthreads();  // the previous tile's PV product is done with Vs, Ss
    for (int e = tid; e < kBKV * D / 2; e += kThreads) {
      int r = e / (D / 2), c = (e % (D / 2)) * 2;
      __nv_bfloat162 kv2, vv2;
      if (k0 + r < skv) {
        kv2 = *reinterpret_cast<const __nv_bfloat162*>(
            Kb + (size_t)(k0 + r) * kv_row + c);
        vv2 = *reinterpret_cast<const __nv_bfloat162*>(
            Vb + (size_t)(k0 + r) * kv_row + c);
      } else {
        kv2 = __floats2bfloat162_rn(0.0f, 0.0f);
        vv2 = kv2;
      }
      *reinterpret_cast<__nv_bfloat162*>(Ks + r * kLdK + c) = kv2;
      *reinterpret_cast<__nv_bfloat162*>(Vs + r * D + c) = vv2;
    }
    __syncthreads();

    // scores: this thread owns key s_col for kScoresPerThread query rows
    float s[kScoresPerThread];
#pragma unroll
    for (int i = 0; i < kScoresPerThread; ++i) s[i] = 0.0f;
    const bf16* krow = Ks + s_col * kLdK;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float kv = __bfloat162float(krow[c]);
#pragma unroll
      for (int i = 0; i < kScoresPerThread; ++i)
        s[i] += Qs[s_row0 + i * kRowStep][c] * kv;
    }
    const int kpos = k0 + s_col;
#pragma unroll
    for (int i = 0; i < kScoresPerThread; ++i) {
      int r = s_row0 + i * kRowStep;
      int qpos = qoff + q0 + r;
      bool ok = (q0 + r < sq) && kpos < klen;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      float v = s[i];
      if (softcap > 0.0f) v = softcap * tanhf(v / softcap);
      Ss[r][s_col] = ok ? v : -INFINITY;
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w+4, ...
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float a = Ss[r][lane], c = Ss[r][lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_old = row_m[r];
      float m_new = fmaxf(m_old, mx);
      float pa = 0.0f, pc = 0.0f, alpha = 1.0f;
      if (m_new != -INFINITY) {  // some key of this row is visible so far
        pa = (a == -INFINITY) ? 0.0f : expf(a - m_new);
        pc = (c == -INFINITY) ? 0.0f : expf(c - m_new);
        alpha = expf(m_old - m_new);  // 0 when m_old is -inf
      }
      Ss[r][lane] = pa;
      Ss[r][lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
        row_alpha[r] = alpha;
      }
    }
    __syncthreads();

    // PV: this thread owns output column pv_col of rows pv_group + i*kGroups
    if (pv_active) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] *= row_alpha[pv_group + i * kGroups];
      for (int j = 0; j < kBKV; ++j) {
        float v = __bfloat162float(Vs[j * D + pv_col]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i] += Ss[pv_group + i * kGroups][j] * v;
      }
    }
  }
  __syncthreads();
  if (!pv_active) return;

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    int r = pv_group + i * kGroups;
    if (q0 + r < sq) {
      float l = row_l[r];
      float out = l > 0.0f ? acc[i] / l : 0.0f;
      Ob[(size_t)(q0 + r) * q_row + pv_col] = __float2bfloat16(out);
    }
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   const int* q_offset, const int* kv_len, int b, int sq,
                   int skv, int hq, int hkv, int causal, int window,
                   float softcap, cudaStream_t stream) {
  dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, k, v, o, q_offset, kv_len, sq, skv, hq, hkv, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// q/o [b, sq, hq, d], k/v [b, skv, hkv, d], all contiguous bf16;
// q_offset/kv_len [b] int32 on the device.  d is 64, 112 or 128;
// hq % hkv == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* q_offset, const void* kv_len, int b, int sq, int skv, int hq,
    int hkv, int d, int causal, int window, float softcap, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o),
                    static_cast<const int*>(q_offset),
                    static_cast<const int*>(kv_len), b, sq, skv, hq, hkv,
                    causal, window, softcap,
                    static_cast<cudaStream_t>(stream));
  };
  if (d == 128) return args(launch<128>);
  if (d == 112) return args(launch<112>);
  if (d == 64) return args(launch<64>);
  return cudaErrorInvalidValue;
}
