// The backward of the flash attention (flash_attention.cu) for training, on
// Hopper tensor cores (mma.sync m16n8k16, ldmatrix), bound through a plain C
// interface: dQ, dK and dV from dO, the forward's output O and its per-row
// log-sum-exp; bf16 in and out, fp32 accumulators.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel, pallas_call at line 102).  The
// Pallas kernel has no backward: JAX differentiates the plain jnp
// attention of src/repro/models/layers.py::attention_core, whose mask this
// kernel takes as the forward does:
//   qpos = q_offset[b] + i;  key j is visible when  j < kv_len[b],
//   j <= qpos (causal),  j > qpos - window (window > 0);
// scores x = softcap * tanh(s / softcap) of s = q.k / sqrt(d) (or s).
// It is FA2's backward, with the probabilities recomputed from the saved
// log-sum-exp L of each row:
//   P = exp(x - L),  D = rowsum(dO o O),  dV = P^T dO,  dP = dO V^T,
//   dX = P o (dP - D),  dS = dX o (1 - tanh^2) (softcap),
//   dQ = dS K / sqrt(d),  dK = dS^T Q / sqrt(d).
// For GQA the rows are (q row x q head of the group), heads innermost, as
// in the forward, so dK and dV of a kv head sum over its group's q heads.
//
// What bounds it on the H100: operations (5 products of [rows x keys x d]
// over the visible half of the causal square; at llama3-8b's s = 2048 about
// 86 GFLOP a layer against some 50 MB).  The design keeps every product on
// bf16 tensor cores with fp32 accumulators (P and dS rounded to bf16 as
// operands, as FA2 does) and sums without float atomics, so the result is
// deterministic:
//   1. delta: D per row, one warp a row;
//   2. dK/dV: one block of 4 warps per (64-key tile, kv head, batch row),
//      each warp 16 keys; it walks the 64-row tiles that can see its keys
//      (Q and dO double-buffered by cp.async), computes S^T = K Q^T and
//      dP^T = V dO^T, P^T and dS^T in registers, and accumulates
//      dV += P^T dO and dK += dS^T Q in registers;
//   3. dQ: one block of 4 warps per (64-row tile, kv head, batch row), each
//      warp 16 rows; it walks the 64-key tiles its rows can see (K and V
//      double-buffered), computes S = Q K^T and dP = dO V^T, then dS, and
//      accumulates dQ += dS K.
// So S and dP are computed twice (7 products instead of 5), the price of
// summing dQ without atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;  // 4 warps of 16 rows (or keys)
constexpr int kBR = 64;        // rows (q row x q head) per tile
constexpr int kBK = 64;        // keys per tile

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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

struct Args {
  const bf16* Q;      // [b, sq, hq, d]
  const bf16* K;      // [b, skv, hkv, d]
  const bf16* V;
  const bf16* O;      // [b, sq, hq, d]
  const bf16* dO;
  const float* lse;   // [b, hq, sq]
  const int* q_offset;
  const int* kv_len;
  bf16* dQ;
  bf16* dK;
  bf16* dV;
  float* delta;       // [b, hq, sq] scratch: rowsum(dO o O)
  int sq, skv, hq, hkv, causal, window;
  float softcap, scale;
};

template <int D>
struct Smem {
  static constexpr int kLd = D + 8;  // padded rows: conflict-free ldmatrix
  static constexpr int kTile = 64 * kLd;
  // 2 resident tiles and 2 x 2 streamed tiles of bf16, then 2 x 2 x 64
  // floats (the streamed rows' L and D)
  static constexpr int kBytes = 6 * kTile * 2 + 4 * 64 * 4;
};

// One (batch row, kv head)'s bookkeeping: row r of the GQA rows is q
// position r / grp of q head kvh * grp + r % grp.
struct Rows {
  int b, kvh, grp, rows, qoff, klen;

  __device__ size_t q_ptr(const Args& a, int r, int D) const {
    return ((size_t)(b * a.sq + r / grp) * a.hq + kvh * grp + r % grp) * D;
  }
  __device__ size_t l_idx(const Args& a, int r) const {
    return ((size_t)b * a.hq + kvh * grp + r % grp) * a.sq + r / grp;
  }
  __device__ bool visible(const Args& a, int r, int key) const {
    if (r >= rows || key >= klen) return false;
    const int qpos = qoff + r / grp;
    if (a.causal && key > qpos) return false;
    if (a.window > 0 && key <= qpos - a.window) return false;
    return true;
  }
};

// dst[64][kLd] <- 64 rows of [.., D] at src + row_ptr(r), by cp.async
// (rows from n_valid on are zero-filled)
template <int D, typename RowPtr>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          RowPtr row_ptr, int n_valid) {
  constexpr int kLd = Smem<D>::kLd;
  for (int idx = threadIdx.x; idx < 64 * D / 8; idx += kThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const bool p = r < n_valid;
    cp_async16(dst + r * kLd + c, src + (p ? row_ptr(r) + c : 0), p);
  }
}

// acc[16 x 64] += A[16 x D] . B[64 x D]^T: A the warp's 16 rows of tile
// As, B all 64 rows of tile Bs (both [64][kLd]).
template <int D>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const bf16* As,
                                        const bf16* Bs, int warp, int lane) {
  constexpr int kLd = Smem<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned fa[4];
    ldsm_x4(fa, As + (warp * 16 + lane % 16) * kLd + kk * 16 +
                    (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      unsigned fb[4];
      ldsm_x4(fb, Bs + (j * 8 + lane % 8 + (lane / 16) * 8) * kLd +
                      kk * 16 + ((lane / 8) % 2) * 8);
      mma16816(acc[j], fa, fb);
      mma16816(acc[j + 1], fa, fb + 2);
    }
  }
}

// acc[16 x D] += P[16 x 64] . B[64 x D]: P the warp's accumulator
// fragments of a [16 x 64] product (rounded to bf16 as the A operand, as
// the forward rounds its probabilities), B the tile Bs ([64][kLd]).
template <int D>
__device__ __forceinline__ void mma_pb(float (*acc)[4], const float (*p)[4],
                                       const bf16* Bs, int lane) {
  constexpr int kLd = Smem<D>::kLd, kDN = D / 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                      pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                      pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                      pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < kDN; n += 2) {
      unsigned fb[4];
      ldsm_x4_trans(fb, Bs + (kk * 16 + lane % 16) * kLd + n * 8 +
                            (lane / 16) * 8);
      mma16816(acc[n], pa, fb);
      mma16816(acc[n + 1], pa, fb + 2);
    }
  }
}

// From a score s (q.k) and dp (dO.v): s <- P = exp(x - L), dp <- dS =
// P (dp - D) dsoft; both 0 where the key is not visible.
__device__ __forceinline__ void probs(float& s, float& dp, bool visible,
                                      float L, float Dv, const Args& a) {
  if (!visible) {
    s = 0.0f;
    dp = 0.0f;
    return;
  }
  float x = s * a.scale, dsoft = 1.0f;
  if (a.softcap > 0.0f) {
    const float th = tanhf(x / a.softcap);
    x = a.softcap * th;
    dsoft = 1.0f - th * th;
  }
  const float p = expf(x - L);
  s = p;
  dp = p * (dp - Dv) * dsoft;
}

template <int D>
__global__ void __launch_bounds__(256) delta_kernel(const Args a, int total) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= total) return;  // row = (b * sq + i) * hq + h
  const bf16* o = a.O + (size_t)row * D;
  const bf16* d = a.dO + (size_t)row * D;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32)
    s += __bfloat162float(o[c]) * __bfloat162float(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % a.hq, bi = row / a.hq;
    const int b = bi / a.sq, i = bi % a.sq;
    a.delta[((size_t)b * a.hq + h) * a.sq + i] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using S = Smem<D>;
  constexpr int kDN = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + S::kTile;
  bf16* Qs = Vs + S::kTile;         // 2 buffers
  bf16* dOs = Qs + 2 * S::kTile;    // 2 buffers
  float* Ls = reinterpret_cast<float*>(dOs + 2 * S::kTile);  // 2 x 64
  float* Ds = Ls + 2 * 64;                                    // 2 x 64

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  const int grp = a.hq / a.hkv;
  const Rows R{b, kvh, grp, a.sq * grp, a.q_offset[b],
               max(0, min(a.kv_len[b], a.skv))};
  const size_t kv_row = (size_t)a.hkv * D;
  const bf16* Kb = a.K + (size_t)b * a.skv * kv_row + (size_t)kvh * D;
  const bf16* Vb = a.V + (size_t)b * a.skv * kv_row + (size_t)kvh * D;
  auto key_ptr = [&](int r) { return (size_t)(k0 + r) * kv_row; };
  const int n_keys = min(kBK, a.skv - k0);
  load_tile<D>(Ks, Kb, key_ptr, n_keys);
  load_tile<D>(Vs, Vb, key_ptr, n_keys);
  cp_async_commit();

  // q positions that can see a key of [k0, k0 + kBK)
  int i_lo = 0, i_hi = a.sq - 1;
  if (a.causal) i_lo = max(0, k0 - R.qoff);
  if (a.window > 0) i_hi = min(i_hi, k0 + kBK - 2 + a.window - R.qoff);
  if (k0 >= R.klen) i_hi = -1;
  const int r_first = i_lo * grp / kBR * kBR, r_end = (i_hi + 1) * grp;
  const int n_tiles = r_end > r_first ? (r_end - r_first + kBR - 1) / kBR : 0;

  auto load_rows = [&](int buf, int r0) {
    auto row_ptr = [&](int r) { return R.q_ptr(a, r0 + r, D); };
    const int n_valid = min(kBR, R.rows - r0);
    load_tile<D>(Qs + buf * S::kTile, a.Q, row_ptr, n_valid);
    load_tile<D>(dOs + buf * S::kTile, a.dO, row_ptr, n_valid);
  };

  float dk[kDN][4], dv[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  if (n_tiles > 0) {
    load_rows(0, r_first);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = r_first + it * kBR, buf = it & 1;
    if (it + 1 < n_tiles) {
      load_rows((it + 1) & 1, r0 + kBR);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    for (int r = tid; r < kBR; r += kThreads) {
      const bool ok = r0 + r < R.rows;
      Ls[buf * 64 + r] = ok ? a.lse[R.l_idx(a, r0 + r)] : 0.0f;
      Ds[buf * 64 + r] = ok ? a.delta[R.l_idx(a, r0 + r)] : 0.0f;
    }
    __syncthreads();
    const bf16* qt = Qs + buf * S::kTile;
    const bf16* dot = dOs + buf * S::kTile;
    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    mma_abt<D>(s, Ks, qt, warp, lane);
    mma_abt<D>(dp, Vs, dot, warp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + warp * 16 + g + (e / 2) * 8;
        const int c = j * 8 + 2 * t + (e % 2);
        probs(s[j][e], dp[j][e], R.visible(a, r0 + c, key),
              Ls[buf * 64 + c], Ds[buf * 64 + c], a);
      }
    // dV += P^T dO, dK += dS^T Q
    mma_pb<D>(dv, s, dot, lane);
    mma_pb<D>(dk, dp, qt, lane);
    __syncthreads();  // every warp is done with this buffer before reuse
  }
  cp_async_wait<0>();  // the K/V tiles, where no row tile ran

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + h * 8;
    if (key >= a.skv) continue;
    const size_t off = ((size_t)(b * a.skv + key) * a.hkv + kvh) * D;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(a.dK + off + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dk[n][h * 2] * a.scale,
                                dk[n][h * 2 + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(a.dV + off + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[n][h * 2], dv[n][h * 2 + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using S = Smem<D>;
  constexpr int kDN = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + S::kTile;
  bf16* Ks = dOs + S::kTile;        // 2 buffers
  bf16* Vs = Ks + 2 * S::kTile;     // 2 buffers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kBR, kvh = blockIdx.y, b = blockIdx.z;
  const int grp = a.hq / a.hkv;
  const Rows R{b, kvh, grp, a.sq * grp, a.q_offset[b],
               max(0, min(a.kv_len[b], a.skv))};
  const size_t kv_row = (size_t)a.hkv * D;
  const bf16* Kb = a.K + (size_t)b * a.skv * kv_row + (size_t)kvh * D;
  const bf16* Vb = a.V + (size_t)b * a.skv * kv_row + (size_t)kvh * D;

  auto row_ptr = [&](int r) { return R.q_ptr(a, r0 + r, D); };
  const int n_valid = min(kBR, R.rows - r0);
  load_tile<D>(Qs, a.Q, row_ptr, n_valid);
  load_tile<D>(dOs, a.dO, row_ptr, n_valid);
  cp_async_commit();

  // this thread's two rows (g and g + 8 of its warp): L and D
  float Lr[2], Dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + g + h * 8;
    const bool ok = r < R.rows;
    Lr[h] = ok ? a.lse[R.l_idx(a, r)] : 0.0f;
    Dr[h] = ok ? a.delta[R.l_idx(a, r)] : 0.0f;
  }

  // keys any row of the tile can see (as the forward cuts them)
  const int qfirst = r0 / grp, qlast = (min(R.rows, r0 + kBR) - 1) / grp;
  int k_end = R.klen;
  if (a.causal) k_end = min(k_end, R.qoff + qlast + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, R.qoff + qfirst - a.window + 1);
  const int lo = k_begin / kBK * kBK;
  const int n_tiles = k_end > lo ? (k_end - lo + kBK - 1) / kBK : 0;

  auto load_keys = [&](int buf, int k0) {
    auto key_ptr = [&](int r) { return (size_t)(k0 + r) * kv_row; };
    const int n_keys = min(kBK, a.skv - k0);
    load_tile<D>(Ks + buf * S::kTile, Kb, key_ptr, n_keys);
    load_tile<D>(Vs + buf * S::kTile, Vb, key_ptr, n_keys);
  };

  float dq[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  const bool active = r0 + warp * 16 < R.rows;  // a warp of padding idles

  if (n_tiles > 0) {
    load_keys(0, lo);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * kBK, buf = it & 1;
    if (it + 1 < n_tiles) {
      load_keys((it + 1) & 1, k0 + kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = Ks + buf * S::kTile;
    const bf16* vt = Vs + buf * S::kTile;
    if (active) {
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      mma_abt<D>(s, Qs, kt, warp, lane);
      mma_abt<D>(dp, dOs, vt, warp, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int row = r0 + warp * 16 + g + h * 8;
          const int key = k0 + j * 8 + 2 * t + (e % 2);
          probs(s[j][e], dp[j][e], R.visible(a, row, key), Lr[h], Dr[h], a);
        }
      mma_pb<D>(dq, dp, kt, lane);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with this buffer before reuse
  }
  cp_async_wait<0>();  // the Q/dO tiles, where no key tile ran
  if (!active) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + h * 8;
    if (row >= R.rows) continue;
    bf16* out = a.dQ + R.q_ptr(a, row, D);
#pragma unroll
    for (int n = 0; n < kDN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dq[n][h * 2] * a.scale,
                                dq[n][h * 2 + 1] * a.scale);
  }
}

template <int D>
cudaError_t launch(const Args& a, int b, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::kBytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int total = b * a.sq * a.hq;
  delta_kernel<D><<<(total + 7) / 8, 256, 0, st>>>(a, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<D><<<dim3((a.skv + kBK - 1) / kBK, a.hkv, b), kThreads,
                   Smem<D>::kBytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = a.sq * (a.hq / a.hkv);
  dq_kernel<D><<<dim3((rows + kBR - 1) / kBR, a.hkv, b), kThreads,
                 Smem<D>::kBytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q/o/do/dq [b, sq, hq, d], k/v/dk/dv [b, skv, hkv, d], contiguous bf16 with
// 16-byte-aligned bases; lse [b, hq, sq] fp32 from the forward
// (flash_attention.cu); delta the same shape, fp32 scratch; q_offset/kv_len
// [b] int32 on the device.  d is 64, 112 or 128; hq % hkv == 0.  Three
// launches: delta, dK/dV, dQ.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_offset,
    const void* kv_len, void* dq, void* dk, void* dv, void* delta, int b,
    int sq, int skv, int hq, int hkv, int d, int causal, int window,
    float softcap, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
         static_cast<const bf16*>(v),     static_cast<const bf16*>(o),
         static_cast<const bf16*>(dout),  static_cast<const float*>(lse),
         static_cast<const int*>(q_offset), static_cast<const int*>(kv_len),
         static_cast<bf16*>(dq),          static_cast<bf16*>(dk),
         static_cast<bf16*>(dv),          static_cast<float*>(delta),
         sq, skv, hq, hkv, causal, window, softcap,
         1.0f / sqrtf(static_cast<float>(d))};
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 128) return launch<128>(a, b, st);
  if (d == 112) return launch<112>(a, b, st);
  if (d == 64) return launch<64>(a, b, st);
  return cudaErrorInvalidValue;
}
