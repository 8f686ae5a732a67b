// The backward of the flash attention (flash_attention.cu) for training, on
// Hopper's warpgroup tensor cores (wgmma) fed by TMA, bound through a plain
// C interface: dQ, dK and dV from dO, the forward's output O and its per-row
// log-sum-exp; bf16 in and out, fp32 accumulators, for sm_90a.
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
//
// What bounds it on the H100: operations (5 products of [rows x keys x d]
// over the visible half of the causal square; at llama3-8b's s = 2048 about
// 86 GFLOP a layer against some 50 MB).  The design:
//   - rows are tiles of 64 q positions of one q head, keys tiles of 64 of
//     one kv head; every tile arrives by TMA (4D maps over [b, s, heads,
//     d], 128-byte swizzled, out-of-range rows, keys and the columns of a
//     head dim of 112 padded to 128 read as zeros), and every product runs
//     on wgmma with fp32 accumulators: S^T = K Q^T and dP^T = V dO^T from
//     shared memory, dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//     bf16 register operands (rounded as FA2 rounds them);
//   - 1. ld: each row's log-sum-exp (times log2 e, +inf where the row
//     sees no key, so that its probabilities are exactly 0) and D, laid
//     out per (q head, position) so that a row tile's 64 values are one
//     256-byte bulk copy;
//   - 2. dK/dV: one warpgroup a block and two blocks an SM, each holding
//     its key tile's K and V in shared memory and streaming Q, dO, L and D
//     row tile by row tile through a two-stage TMA ring (one thread issues
//     the next stage while the warpgroup computes this one; the other
//     block on the SM fills the tensor cores while this one computes P and
//     dS).  The causal square is unbalanced (at s = 2048 key tile 0 sees
//     128 row tiles and key tile 31 sees 4), so the host's plan
//     (ops.attention_bwd_plan) cuts each key tile's row tiles into items
//     of nearly equal length, longest first; persistent blocks take items
//     from a ticket counter.  The items of a key tile write fp32 partial
//     dK/dV tiles, and the last to arrive sums them in item order (an int
//     counter per key tile, reset by it): no float atomics, so the sum
//     does not depend on which block came last;
//   - 3. dQ: one warpgroup a block per (row tile, q head, batch row),
//     longest row tiles first, streaming K and V key tile by key tile, so
//     dQ is summed in key order without atomics.  S and dP are computed
//     again there: 7 products instead of 5, the price of a deterministic
//     dQ.
// Warp specialisation (a producer warp, setmaxnreg) is not used: at one
// warpgroup a block the accumulators (dK and dV, 64 x 128 fp32 each) fit
// the 255 registers a thread without it (246, no spills), and the second
// block on the SM overlaps the first's elementwise work with its
// products.  Two warpgroups sharing one stream of row tiles measured
// slower on the H100: waiting on the same stages, they ran in lock step
// and left the tensor cores idle together.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;      // one warpgroup
constexpr int kAtom = 64 * 128;    // a 64-row x 64-column bf16 swizzle atom
constexpr int kLdBytes = 2 * 64 * 4;  // a row tile's L and D
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// D[64x64] (fp32, 32 registers a thread) = A[64x16] B[16x64] (+ D where
// accumulate): A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x64] (fp32, 32 registers a thread) += A[64x16] B[16x64]: A
// from registers (four bf16 pairs a thread, mma.sync's A layout per warp),
// B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const unsigned* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x128] (fp32, 64 registers a thread) += A[64x16] B[16x128]: A
// from registers (four bf16 pairs a thread, mma.sync's A layout per warp),
// B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float* d, const unsigned* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are pending
// (groups complete in commit order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of these registers across
// this point (an asynchronous product writes them)
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | (uint64_t)1 << 62;
}
// K-major operand (a [64 x D] tile read along D, D/64 atoms): k step kk
// of 16 columns is 32 bytes into atom kk / 4
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile,
                                           int kk) {
  return smem_desc(tile + (kk >> 2) * kAtom + (kk & 3) * 32, 16, 1024);
}
// MN-major B (a [64 x D] tile read along its 64 rows, N = D across the
// atoms): k step kk of 16 rows is 2048 bytes down every atom
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile,
                                            int kk) {
  return smem_desc(tile + kk * 2048, kAtom, 1024);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait for the phase of `parity` to complete.  A wait that never ends (a
// copy that was never issued) traps, so a fault ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1 << 26)) __trap();
  }
}
// a 64 x 64 box of a 4D map [batch, seq, heads, d] at (col, head, row, b)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int col, int head, int row, int b,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row), "r"(b)
      : "memory");
}
// contiguous bytes (a multiple of 16, 16-byte aligned) to shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Args {
  CUtensorMap tq, tdo, tk, tv;  // TMA maps of Q, dO, K, V
  const bf16* O;      // [b, sq, hq, d]
  const bf16* dO;
  const float* lse;   // [b, hq, sq]
  const int* q_offset;
  const int* kv_len;
  bf16* dQ;           // [b, sq, hq, d]
  bf16* dK;           // [b, skv, hkv, d]
  bf16* dV;
  float* ld;          // [2, b, hq, rows]: log2(e) * L (+inf: no key), D
  const int* items;   // [n_items, 8] (ops.attention_bwd_plan)
  float* parts;       // [slots, 2, 64 * DP] partial dK, dV (fragment order)
  int* counters;      // [0] ticket, [1] blocks done, [2 + bh * KT + kt]
  int b, sq, skv, hq, hkv, d, causal, window, n_items, rows;
  float softcap, scale, scale_log2;  // scale_log2 = log2(e) / sqrt(d)
};

// The scores' visibility (the forward's mask) and whether a whole 64 x 64
// (keys x positions) tile is visible, so that its mask can be skipped.
struct Mask {
  int qoff, klen, causal, window;
  __device__ bool visible(int key, int pos) const {
    if (key >= klen) return false;
    if (causal && key > pos + qoff) return false;
    if (window > 0 && key <= pos + qoff - window) return false;
    return true;
  }
  __device__ bool whole(int k0, int p0) const {
    return k0 + 64 <= klen && (!causal || k0 + 63 <= p0 + qoff) &&
           (window <= 0 || p0 + 63 + qoff - k0 < window);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A score s = q.k -> P o dsoft (dsoft = 1 - tanh^2 with a softcap, else
// 1), the factor of dS = P o dsoft o (dP - D); *p <- P.  L2 is log2(e) * L,
// +inf for a row that sees no key (P = 0).
template <bool CAP>
__device__ __forceinline__ float prob(float s, float L2, float* p,
                                      const Args& a) {
  if constexpr (!CAP) {
    *p = ex2(fmaf(s, a.scale_log2, -L2));
    return *p;
  }
  const float th = tanhf(s * a.scale / a.softcap);
  *p = ex2(fmaf(a.softcap * th, kLog2e, -L2));
  return *p * (1.0f - th * th);
}

template <int A>
struct Smem {
  // two resident tiles, then two stages of two streamed tiles, each A
  // atoms; then the stages' L and D; 1 KB to align the atoms to 1024
  static constexpr int kBytes = 6 * A * kAtom + 2 * kLdBytes + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// 1. L and D per (batch row, q head, position), positions padded to whole
// tiles (padding: L = +inf, D = 0).  16 lanes a row, 16 bytes each.
__global__ void __launch_bounds__(256) ld_kernel(const Args a) {
  const long long row = (long long)blockIdx.x * 16 + threadIdx.x / 16;
  const int lane = threadIdx.x % 16;
  const long long total = (long long)a.b * a.hq * a.rows;
  const bool live = row < total;
  const int pos = live ? (int)(row % a.rows) : 0;
  const long long bh = live ? row / a.rows : 0;  // b * hq + h
  const int h = (int)(bh % a.hq), b = (int)(bh / a.hq);
  float dot = 0.0f;
  if (live && pos < a.sq && lane * 8 < a.d) {
    const size_t off = ((size_t)(b * a.sq + pos) * a.hq + h) * a.d + lane * 8;
    const uint4 o = *reinterpret_cast<const uint4*>(a.O + off);
    const uint4 g = *reinterpret_cast<const uint4*>(a.dO + off);
    const unsigned ow[4] = {o.x, o.y, o.z, o.w}, gw[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 of = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&ow[k]));
      const float2 gf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&gw[k]));
      dot += of.x * gf.x + of.y * gf.y;
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (!live || lane != 0) return;
  float L2 = INFINITY, D = 0.0f;
  if (pos < a.sq) {
    const float L = a.lse[bh * a.sq + pos];
    L2 = L == -INFINITY ? INFINITY : L * kLog2e;
    D = dot;
  }
  a.ld[row] = L2;
  a.ld[total + row] = D;
}

// The row tiles [v0, v1) of one (batch row, kv head) that see a key of key
// tile kt: row tile t is positions [64 (t / grp), +64) of q head
// kvh * grp + t % grp (ops.bwd_visible_tiles).
__device__ __forceinline__ void visible_tiles(const Mask& m, int kt, int sq,
                                              int grp, int& v0, int& v1) {
  const int k0 = 64 * kt, k1 = min(64 * kt + 63, m.klen - 1);
  int p_lo = 0, p_hi = sq - 1;
  if (m.causal) p_lo = max(p_lo, k0 - m.qoff);
  if (m.window > 0) p_hi = min(p_hi, k1 + m.window - 1 - m.qoff);
  if (k0 > k1 || p_lo > p_hi) {
    v0 = v1 = 0;
    return;
  }
  v0 = p_lo / 64 * grp;
  v1 = (p_hi / 64 + 1) * grp;
}

// Store a 64 x DP fp32 accumulator tile (keys x head dim) times `mul` as
// bf16 rows key0 + r of dst (row stride `ld` elements), rows below `n_rows`
// and columns below `d`.
template <int DP>
__device__ __forceinline__ void store_rows(const float* acc, float mul,
                                           bf16* dst, size_t ld, int n_rows,
                                           int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + h * 8;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * t4;
      if (c >= d) continue;
      *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul,
                                acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

template <int A>
__device__ __forceinline__ void mma_rs(float* d, const unsigned* a,
                                       uint64_t db) {
  if constexpr (A == 2)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

// 2. dK/dV over the plan's items (see the note at the top).  CAP: a
// softcap is applied.
template <int A, bool CAP>
__global__ void __launch_bounds__(kThreads, 2)
    dkdv_kernel(const __grid_constant__ Args a) {
  constexpr int DP = 64 * A;    // the head dim, padded
  constexpr int NACC = DP / 2;  // a thread's share of a 64 x DP fp32 tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_bar, full[2];
  __shared__ int s_item, s_last;
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + A * kAtom;
  unsigned char* stage0 = Vs + A * kAtom;  // stage s: Q, then dO
  float* lds = reinterpret_cast<float*>(stage0 + 4 * A * kAtom);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int grp = a.hq / a.hkv, KT = (a.skv + 63) / 64;
  const int R = a.rows / 64 * grp;
  const size_t ld_d = (size_t)a.b * a.hq * a.rows;  // D after all the L
  if (tid == 0) {
    mbar_init(&kv_bar, 1);
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int kv_uses = 0, loads = 0, uses = 0;

  for (;;) {
    // every thread is done with the last item (its tiles and s_item)
    __syncthreads();
    if (tid == 0) s_item = atomicAdd(a.counters, 1);
    __syncthreads();
    const int it = s_item;
    if (it >= a.n_items) break;
    const int4 rec = *reinterpret_cast<const int4*>(a.items + 8 * it);
    const int4 rec2 = *reinterpret_cast<const int4*>(a.items + 8 * it + 4);
    const int bh = rec.x, kt = rec.y, part = rec2.x, parts = rec2.y;
    const int slot0 = rec2.z;
    const int b = bh / a.hkv, kvh = bh % a.hkv;
    const Mask m{a.q_offset[b], max(0, min(a.kv_len[b], a.skv)), a.causal,
                 a.window};
    int v0, v1;
    visible_tiles(m, kt, a.sq, grp, v0, v1);
    const int lo = max(v0, part == 0 ? 0 : rec.z);
    const int n = min(v1, part == parts - 1 ? R : rec.w) - lo;

    // stage s <- row tile t's Q, dO, L and D
    auto issue_rows = [&](int t, int s) {
      const int pt = t / grp, h = kvh * grp + t % grp;
      unsigned char* q = stage0 + s * 2 * A * kAtom;
      mbar_expect_tx(&full[s], 2 * A * kAtom + kLdBytes);
#pragma unroll
      for (int c = 0; c < A; ++c) {
        tma_load_4d(q + c * kAtom, &a.tq, 64 * c, h, 64 * pt, b, &full[s]);
        tma_load_4d(q + (A + c) * kAtom, &a.tdo, 64 * c, h, 64 * pt, b,
                    &full[s]);
      }
      const float* src = a.ld + ((size_t)(b * a.hq + h) * a.rows + 64 * pt);
      bulk_load(lds + s * 128, src, 256, &full[s]);
      bulk_load(lds + s * 128 + 64, src + ld_d, 256, &full[s]);
    };

    float dk[NACC], dv[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) dk[i] = dv[i] = 0.0f;
    if (n > 0) {
      if (tid == 0) {
        mbar_expect_tx(&kv_bar, 2 * A * kAtom);
#pragma unroll
        for (int c = 0; c < A; ++c) {
          tma_load_4d(Ks + c * kAtom, &a.tk, 64 * c, kvh, 64 * kt, b, &kv_bar);
          tma_load_4d(Vs + c * kAtom, &a.tv, 64 * c, kvh, 64 * kt, b, &kv_bar);
        }
        issue_rows(lo, loads % 2);
      }
      ++loads;
      __syncwarp();
      mbar_wait(&kv_bar, kv_uses++ & 1);
    }
    // Per step: S^T and dP^T issued together; P^T computed while dP^T
    // runs; dV += P^T dO issued; dS^T computed while it runs; dK += dS^T Q.
    // (Leaving dV and dK in flight into the next step needs their operand
    // registers beside the new S^T and dP^T, and spills.)
    for (int i = 0; i < n; ++i) {
      const int s = uses % 2;
      mbar_wait(&full[s], (uses / 2) & 1);
      ++uses;
      const unsigned char* Qt = stage0 + s * 2 * A * kAtom;
      const unsigned char* dOt = Qt + A * kAtom;
      const float* Lt = lds + s * 128;
      const int t = lo + i, p0 = t / grp * 64;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 positions
      float st[32], dpt[32];
      fence_regs<32>(st);
      fence_regs<32>(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * A; ++kk)
        wgmma_ss_n64(st, desc_k(Ks, kk), desc_k(Qt, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4 * A; ++kk)
        wgmma_ss_n64(dpt, desc_k(Vs, kk), desc_k(dOt, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();  // S^T
      fence_regs<32>(st);
      // every thread's products on the other stage are done: refill it
      __syncthreads();
      if (i + 1 < n) {
        if (tid == 0) issue_rows(lo + i + 1, loads % 2);
        ++loads;
      }
      __syncwarp();

      // P^T as bf16 A operands (pair (j, h): key row warp * 16 + g + 8 h,
      // positions 8 j + 2 t4 and + 1); st keeps P o dsoft for dS
      const bool whole = m.whole(64 * kt, p0);
      unsigned pa[16], dsa[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t4;
        const float2 L2 = *reinterpret_cast<const float2*>(Lt + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i0 = 4 * j + 2 * h;
          float p[2];
          st[i0] = prob<CAP>(st[i0], L2.x, &p[0], a);
          st[i0 + 1] = prob<CAP>(st[i0 + 1], L2.y, &p[1], a);
          if (!whole) {
            const int key = 64 * kt + warp * 16 + g + 8 * h;
            if (!m.visible(key, p0 + c)) st[i0] = p[0] = 0.0f;
            if (!m.visible(key, p0 + c + 1)) st[i0 + 1] = p[1] = 0.0f;
          }
          pa[2 * j + h] = pack_bf16(p[0], p[1]);
        }
      }
      // dV += P^T dO: k steps of 16 positions
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<A>(dv, pa + 4 * kk, desc_mn(dOt, kk));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T
      fence_regs<32>(dpt);

      // dS^T = P o dsoft o (dP - D) (0 where P is)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 D = *reinterpret_cast<const float2*>(Lt + 64 + 8 * j +
                                                          2 * t4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i0 = 4 * j + 2 * h;
          dsa[2 * j + h] = pack_bf16(st[i0] * (dpt[i0] - D.x),
                                     st[i0 + 1] * (dpt[i0 + 1] - D.y));
        }
      }
      // dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<A>(dk, dsa + 4 * kk, desc_mn(Qt, kk));
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs<NACC>(dk);
    fence_regs<NACC>(dv);

    const size_t kv_ld = (size_t)a.hkv * a.d;
    bf16* dk_out = a.dK + ((size_t)b * a.skv + 64 * kt) * kv_ld + kvh * a.d;
    bf16* dv_out = a.dV + ((size_t)b * a.skv + 64 * kt) * kv_ld + kvh * a.d;
    const int n_keys = min(64, a.skv - 64 * kt);
    if (parts == 1) {
      store_rows<DP>(dk, a.scale, dk_out, kv_ld, n_keys, a.d);
      store_rows<DP>(dv, 1.0f, dv_out, kv_ld, n_keys, a.d);
      continue;
    }
    // a key tile of several items: the partial out, then the last item to
    // arrive sums the partials in item order
    {
      float* p = a.parts + (size_t)(slot0 + part) * 2 * 64 * DP + tid;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        p[i * kThreads] = dk[i];
        p[(NACC + i) * kThreads] = dv[i];
      }
    }
    __threadfence();
    __syncthreads();
    int* arrivals = a.counters + 2 + bh * KT + kt;
    if (tid == 0) {
      const int prev = atomicAdd(arrivals, 1);
      s_last = prev == parts - 1;
      if (s_last) *arrivals = 0;  // clean for the next launch
    }
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sum[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) sum[i] = 0.0f;
      for (int q = 0; q < parts; ++q) {
        const float* p = a.parts + (size_t)(slot0 + q) * 2 * 64 * DP +
                         half * NACC * kThreads + tid;
#pragma unroll
        for (int i = 0; i < NACC; ++i) sum[i] += __ldcg(p + i * kThreads);
      }
      store_rows<DP>(sum, half == 0 ? a.scale : 1.0f,
                     half == 0 ? dk_out : dv_out, kv_ld, n_keys, a.d);
    }
  }
  // the last block out resets the ticket for the next launch
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.counters + 1, 1) == (int)gridDim.x - 1) {
      a.counters[0] = 0;
      a.counters[1] = 0;
    }
  }
}

// 3. dQ: one block per (row tile, q head, batch row), the row tiles of the
// last positions (which see the most keys) first.
template <int A, bool CAP>
__global__ void __launch_bounds__(kThreads, 2)
    dq_kernel(const __grid_constant__ Args a) {
  constexpr int DP = 64 * A;
  constexpr int NACC = DP / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_bar, full[2];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + A * kAtom;
  unsigned char* stage0 = dOs + A * kAtom;  // stage s: K, then V

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int PT = a.rows / 64, BH = a.b * a.hq;
  const int pt = PT - 1 - (int)(blockIdx.x / BH);
  const int b = (int)(blockIdx.x % BH) / a.hq, h = (int)(blockIdx.x % BH) % a.hq;
  const int kvh = h / (a.hq / a.hkv), p0 = 64 * pt;
  const Mask m{a.q_offset[b], max(0, min(a.kv_len[b], a.skv)), a.causal,
               a.window};
  // the key tiles any row of the tile can see
  int k_end = m.klen, k_begin = 0;
  if (m.causal) k_end = min(k_end, min(p0 + 63, a.sq - 1) + m.qoff + 1);
  if (m.window > 0) k_begin = max(0, p0 + m.qoff - m.window + 1);
  const int kt0 = k_begin / 64;
  const int n = k_end > 64 * kt0 ? (k_end - 64 * kt0 + 63) / 64 : 0;

  // this thread's rows warp * 16 + g + 8 h: L and D
  float L2[2], D[2];
  const size_t row0 = (size_t)(b * a.hq + h) * a.rows + p0;
  const size_t ld_d = (size_t)a.b * a.hq * a.rows;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    L2[hh] = a.ld[row0 + warp * 16 + g + 8 * hh];
    D[hh] = a.ld[ld_d + row0 + warp * 16 + g + 8 * hh];
  }

  if (tid == 0) {
    mbar_init(&q_bar, 1);
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage s <- key tile kt's K and V
  auto issue_keys = [&](int kt, int s) {
    unsigned char* k = stage0 + s * 2 * A * kAtom;
    mbar_expect_tx(&full[s], 2 * A * kAtom);
#pragma unroll
    for (int c = 0; c < A; ++c) {
      tma_load_4d(k + c * kAtom, &a.tk, 64 * c, kvh, 64 * kt, b, &full[s]);
      tma_load_4d(k + (A + c) * kAtom, &a.tv, 64 * c, kvh, 64 * kt, b,
                  &full[s]);
    }
  };

  float dq[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dq[i] = 0.0f;
  if (n > 0) {
    if (tid == 0) {
      mbar_expect_tx(&q_bar, 2 * A * kAtom);
#pragma unroll
      for (int c = 0; c < A; ++c) {
        tma_load_4d(Qs + c * kAtom, &a.tq, 64 * c, h, p0, b, &q_bar);
        tma_load_4d(dOs + c * kAtom, &a.tdo, 64 * c, h, p0, b, &q_bar);
      }
      issue_keys(kt0, 0);
    }
    __syncwarp();
    mbar_wait(&q_bar, 0);
  }
  // Per step: S and dP issued together; P computed while dP runs; dQ +=
  // dS K left running into the next step, whose first wait retires it.
  for (int i = 0; i < n; ++i) {
    const int s = i % 2, kt = kt0 + i;
    mbar_wait(&full[s], (i / 2) & 1);
    const unsigned char* Kt = stage0 + s * 2 * A * kAtom;
    const unsigned char* Vt = Kt + A * kAtom;

    // S = Q K^T and dP = dO V^T: 64 positions x 64 keys
    float sc[32], dp[32];
    fence_regs<32>(sc);
    fence_regs<32>(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * A; ++kk)
      wgmma_ss_n64(sc, desc_k(Qs, kk), desc_k(Kt, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * A; ++kk)
      wgmma_ss_n64(dp, desc_k(dOs, kk), desc_k(Vt, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();  // S, and the last step's dQ
    fence_regs<32>(sc);
    // every thread's products on the other stage are done: refill it
    __syncthreads();
    if (tid == 0 && i + 1 < n) issue_keys(kt + 1, (i + 1) % 2);
    __syncwarp();

    // P o dsoft (pair (j, hh): position row warp * 16 + g + 8 hh, keys
    // 8 j + 2 t4 and + 1), 0 where the key is not visible
    const bool whole = m.whole(64 * kt, p0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i0 = 4 * j + 2 * hh;
        float p;
        sc[i0] = prob<CAP>(sc[i0], L2[hh], &p, a);
        sc[i0 + 1] = prob<CAP>(sc[i0 + 1], L2[hh], &p, a);
        if (!whole) {
          const int pos = p0 + warp * 16 + g + 8 * hh;
          const int key = 64 * kt + 8 * j + 2 * t4;
          if (!m.visible(key, pos)) sc[i0] = 0.0f;
          if (!m.visible(key + 1, pos)) sc[i0 + 1] = 0.0f;
        }
      }
    }
    wgmma_wait<0>();  // dP
    fence_regs<32>(dp);
    unsigned dsa[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i0 = 4 * j + 2 * hh;
        dsa[2 * j + hh] = pack_bf16(sc[i0] * (dp[i0] - D[hh]),
                                    sc[i0 + 1] * (dp[i0 + 1] - D[hh]));
      }

    // dQ += dS K: k steps of 16 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<A>(dq, dsa + 4 * kk, desc_mn(Kt, kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<NACC>(dq);

  const size_t q_ld = (size_t)a.hq * a.d;
  store_rows<DP>(dq, a.scale,
                 a.dQ + ((size_t)b * a.sq + p0) * q_ld + (size_t)h * a.d, q_ld,
                 a.sq - p0, a.d);
}

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (so
// the library needs no link to libcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// map of a contiguous bf16 [batch, seq, heads, d] in boxes of 64 columns of
// one head at 64 consecutive positions, 128-byte swizzled as wgmma reads
// them; out-of-range positions and columns read as zeros
bool tensor_map(CUtensorMap* map, const void* base, int batch, int seq,
                int heads, int d) {
  auto fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                           (cuuint64_t)seq * heads * d * 2};
  cuuint32_t box[4] = {64, 1, 64, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            d > 64 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                   : CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int A, bool CAP>
cudaError_t launch(const Args& a, int blocks, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<A, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<A>::kBytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(dq_kernel<A, CAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<A>::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long rows = (long long)a.b * a.hq * a.rows;
  ld_kernel<<<(unsigned)((rows + 15) / 16), 256, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<A, CAP><<<blocks, kThreads, Smem<A>::kBytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_kernel<A, CAP><<<a.b * a.hq * (a.rows / 64), kThreads, Smem<A>::kBytes,
                      st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q/o/do/dq [b, sq, hq, d], k/v/dk/dv [b, skv, hkv, d], contiguous bf16 with
// 16-byte-aligned bases; lse [b, hq, sq] fp32 from the forward
// (flash_attention.cu); q_offset/kv_len [b] int32 on the device.  d is 64,
// 112 or 128; hq % hkv == 0.  Scratch: ld fp32 [2, b, hq, rows] (rows = sq
// rounded up to 64), parts fp32 [slots, 2, 64, 64 or 128] and counters
// int32 [2 + b * hkv * key tiles], zero between launches (each launch
// leaves them zero); items int32 [n_items, 8] and blocks from
// ops.attention_bwd_plan.  Three launches: ld, dK/dV, dQ.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_offset,
    const void* kv_len, void* dq, void* dk, void* dv, void* ld,
    const void* items, void* parts, void* counters, int b, int sq, int skv,
    int hq, int hkv, int d, int causal, int window, float softcap,
    int n_items, int blocks, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      n_items <= 0 || blocks <= 0)
    return cudaErrorInvalidValue;
  if (d != 64 && d != 112 && d != 128) return cudaErrorInvalidValue;
  Args a{};
  if (!tensor_map(&a.tq, q, b, sq, hq, d) ||
      !tensor_map(&a.tdo, dout, b, sq, hq, d) ||
      !tensor_map(&a.tk, k, b, skv, hkv, d) ||
      !tensor_map(&a.tv, v, b, skv, hkv, d))
    return cudaErrorInvalidValue;
  a.O = static_cast<const bf16*>(o);
  a.dO = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.q_offset = static_cast<const int*>(q_offset);
  a.kv_len = static_cast<const int*>(kv_len);
  a.dQ = static_cast<bf16*>(dq);
  a.dK = static_cast<bf16*>(dk);
  a.dV = static_cast<bf16*>(dv);
  a.ld = static_cast<float*>(ld);
  a.items = static_cast<const int*>(items);
  a.parts = static_cast<float*>(parts);
  a.counters = static_cast<int*>(counters);
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.hkv = hkv;
  a.d = d;
  a.causal = causal;
  a.window = window;
  a.n_items = n_items;
  a.rows = (sq + 63) / 64 * 64;
  a.softcap = softcap;
  a.scale = 1.0f / sqrtf(static_cast<float>(d));
  a.scale_log2 = a.scale * kLog2e;
  auto st = static_cast<cudaStream_t>(stream);
  if (softcap > 0.0f)
    return d == 64 ? launch<1, true>(a, blocks, st)
                   : launch<2, true>(a, blocks, st);
  return d == 64 ? launch<1, false>(a, blocks, st)
                 : launch<2, false>(a, blocks, st);
}
