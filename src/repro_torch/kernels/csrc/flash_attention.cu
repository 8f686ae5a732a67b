// Online-softmax attention over per-row offsets and lengths on Hopper tensor
// cores (mma.sync m16n8k16, ldmatrix), with split-KV (flash-decoding) and
// the combine in the same launch; bf16 in/out, for sm_90a, bound through a
// plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel, pallas_call at line 102) and its GQA wrapper in
// src/repro/kernels/ops.py.  It computes the mask of
// src/repro/models/layers.py::attention_core, which the TPU kernel covers
// only for q_offset = 0 and kv_len = sk:
//   qpos = q_offset[b] + i;  key j is visible when  j < kv_len[b],
//   j <= qpos (causal),  j > qpos - window (window > 0).
// Scores are q.k / sqrt(d), optionally softcap * tanh(s / softcap); the
// running max, sum and accumulator are fp32, and the probabilities are
// rounded to bf16 for the PV product (as FA2 does).  A row with no visible
// key writes zeros.
//
// What bounds it on the H100: a serving call moves a few MB (a 64-row
// prefill chunk, or one row per slot, against a few hundred cached keys), so
// its bound is a microsecond or two of K/V bytes, and what it must beat is
// latency: idle rows, repeated K/V reads, serial loads.  The design:
//   - one block per (row tile, KV split, kv head, batch row); the rows of a
//     tile are (q row x q head of the GQA group), heads innermost, so the 4
//     q heads of a llama3-8b group share each read of a K/V tile and a
//     decode tick's rows are not spread over 16-row tiles of one head;
//   - S = Q K^T and O += P V on mma.sync bf16 tensor cores with fp32
//     accumulators; Q, K and V fragments come from shared memory by
//     ldmatrix (V with .trans), rows padded by 16 bytes against bank
//     conflicts; a warp whose 16 rows are all padding skips the products;
//   - K/V tiles of 64 keys are double-buffered with cp.async, so the next
//     tile loads while the tensor cores work on this one; tiles that the
//     mask hides from every row of the tile are never loaded;
//   - split-KV when (row tiles x kv heads x batch) blocks would leave most
//     SMs idle and each split's key tiles pay for the merge, as for a decode
//     tick (ops.attention_plan, plain Python): split s takes a fixed range
//     of key tiles and writes its normalised partial O (fp32) and its
//     log-sum-exp to a workspace the wrapper allocates; the last block of
//     the row tile to arrive (an int counter, reset by that block) merges
//     the splits in split order.  A split that sees no key has lse = -inf
//     and weight 0; a row all of whose splits see no key gives zeros.
// At d = 256 (gemma2-2b) a warp's O accumulator is 128 fp32 a thread and
// the smem 169 KB (Q and two K/V buffers of 64 rows of 264): Q's fragments
// are read from shared memory at each 16-wide k step, never held, and the
// merge of the splits sums at most 16 float4 a thread at a time (32 would
// take 128 registers more).
// For training, the wrapper also passes an fp32 [b, hq, sq] buffer for each
// row's log-sum-exp of its scaled (and softcapped) scores, which the
// backward (flash_attention_bwd.cu) reads to recompute the probabilities;
// at serving the pointer is null and nothing more is written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kBR = 64;        // rows (q row x q head) per tile
constexpr int kBKV = 64;       // keys per K/V tile
constexpr int kMaxSplits = 32;

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
  const bf16* Q;
  const bf16* K;
  const bf16* V;
  bf16* O;
  float* lse;     // [b, hq, sq] log-sum-exp of each row, or null
  const int* q_offset;
  const int* kv_len;
  float* ws_o;    // [tiles, splits, kBR, D] normalised partial O
  float* ws_lse;  // [tiles, splits, kBR] log-sum-exp (-inf: no key)
  int* counters;  // [tiles] arrivals, zero between launches
  int sq, skv, hq, hkv, causal, window;
  float softcap, scale;
  int row_tiles, splits, tiles_per_split;
};

template <int D>
struct Smem {
  static constexpr int kLd = D + 8;  // padded rows: conflict-free ldmatrix
  static constexpr int kQ = kBR * kLd;
  static constexpr int kKV = kBKV * kLd;
  static constexpr int kBytes = (kQ + 4 * kKV) * 2;  // Q, 2 x (K, V)
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const Args args) {
  using S = Smem<D>;
  constexpr int kLd = S::kLd;
  constexpr int kDN = D / 8;  // n8 blocks of the output
  static_assert(D % 16 == 0 && kDN % 2 == 0, "head dim in 16-wide k steps");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + S::kQ;          // 2 buffers of kKV
  bf16* Vs = Ks + 2 * S::kKV;     // 2 buffers of kKV
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = blockIdx.x / args.splits, sp = blockIdx.x % args.splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int hq = args.hq, hkv = args.hkv, sq = args.sq, skv = args.skv;
  const int grp = hq / hkv;
  const int rows = sq * grp;
  const int r0 = rt * kBR;
  const int qoff = args.q_offset[b];
  const int klen = max(0, min(args.kv_len[b], skv));

  // keys any row of this tile can see, cut to this split's key tiles
  const int qrow_first = r0 / grp;
  const int qrow_last = (min(rows, r0 + kBR) - 1) / grp;
  int k_end = klen;
  if (args.causal) k_end = min(k_end, qoff + qrow_last + 1);
  int k_begin = 0;
  if (args.window > 0) k_begin = max(0, qoff + qrow_first - args.window + 1);
  const int s_begin = sp * args.tiles_per_split * kBKV;
  const int hi = min(k_end, min(skv, s_begin + args.tiles_per_split * kBKV));
  const int lo = max(k_begin, s_begin) / kBKV * kBKV;
  const int n_tiles = hi > lo ? (hi - lo + kBKV - 1) / kBKV : 0;

  const size_t q_row = (size_t)hq * D, kv_row = (size_t)hkv * D;
  const bf16* Kb = args.K + (size_t)b * skv * kv_row + (size_t)kvh * D;
  const bf16* Vb = args.V + (size_t)b * skv * kv_row + (size_t)kvh * D;
  // tile row r -> q row (r0 + r) / grp, q head kvh * grp + (r0 + r) % grp
  auto q_ptr = [&](int row) {
    return (size_t)(b * sq + row / grp) * q_row +
           (size_t)(kvh * grp + row % grp) * D;
  };
  // the same row's place in the [b, hq, sq] log-sum-exp
  auto lse_idx = [&](int row) {
    return ((size_t)b * hq + kvh * grp + row % grp) * sq + row / grp;
  };

  auto load_kv = [&](int buf, int k0) {
    bf16* kd = Ks + buf * S::kKV;
    bf16* vd = Vs + buf * S::kKV;
    for (int idx = tid; idx < kBKV * D / 8; idx += kThreads) {
      int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      int key = k0 + r;
      bool p = key < hi;  // beyond: zero-filled, and masked below
      size_t off = p ? (size_t)key * kv_row + c : 0;
      cp_async16(kd + r * kLd + c, Kb + off, p);
      cp_async16(vd + r * kLd + c, Vb + off, p);
    }
  };

  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  const bool active = r0 + warp * 16 < rows;  // a warp of padding rows idles

  if (n_tiles > 0) {
    for (int idx = tid; idx < kBR * D / 8; idx += kThreads) {
      int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      bool p = r0 + r < rows;
      cp_async16(Qs + r * kLd + c, args.Q + (p ? q_ptr(r0 + r) + c : 0), p);
    }
    load_kv(0, lo);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv((it + 1) & 1, lo + (it + 1) * kBKV);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = lo + it * kBKV;
    const bf16* kt = Ks + (it & 1) * S::kKV;
    const bf16* vt = Vs + (it & 1) * S::kKV;
    if (active) {
      // S = Q K^T for this warp's 16 rows and the tile's 64 keys
      float s[kBKV / 8][4];
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned qa[4];
        ldsm_x4(qa, Qs + (warp * 16 + lane % 16) * kLd + kk * 16 +
                        (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < kBKV / 8; j += 2) {
          unsigned kb[4];
          ldsm_x4(kb, kt + (j * 8 + lane % 8 + (lane / 16) * 8) * kLd +
                          kk * 16 + ((lane / 8) % 2) * 8);
          mma16816(s[j], qa, kb);
          mma16816(s[j + 1], qa, kb + 2);
        }
      }
      // scale, softcap, mask; online softmax per row (h: rows g and g + 8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + warp * 16 + g + h * 8;
        const int qpos = qoff + row / grp;
        const bool rvalid = row < rows;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int kpos = k0 + j * 8 + 2 * t + e;
            float x = s[j][h * 2 + e] * args.scale;
            if (args.softcap > 0.0f) x = args.softcap * tanhf(x / args.softcap);
            bool ok = rvalid && kpos < hi;
            if (args.causal) ok = ok && kpos <= qpos;
            if (args.window > 0) ok = ok && kpos > qpos - args.window;
            x = ok ? x : -INFINITY;
            s[j][h * 2 + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx);
        float alpha = 1.0f, sum = 0.0f;
        if (m_new != -INFINITY) {  // some key of this row is visible so far
          alpha = expf(m_run[h] - m_new);  // 0 when m_run is -inf
#pragma unroll
          for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = s[j][h * 2 + e];
              float p = x == -INFINITY ? 0.0f : expf(x - m_new);
              s[j][h * 2 + e] = p;
              sum += p;
            }
        } else {
#pragma unroll
          for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) s[j][h * 2 + e] = 0.0f;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        m_run[h] = m_new;
        l_run[h] = l_run[h] * alpha + sum;
#pragma unroll
        for (int n = 0; n < kDN; ++n) {
          o[n][h * 2] *= alpha;
          o[n][h * 2 + 1] *= alpha;
        }
      }
      // O += P V, P rounded to bf16 as the A operand
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < kDN; n += 2) {
          unsigned vb[4];
          ldsm_x4_trans(vb, vt + (kk * 16 + lane % 16) * kLd + n * 8 +
                                (lane / 16) * 8);
          mma16816(o[n], pa, vb);
          mma16816(o[n + 1], pa, vb + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before reuse
  }

  const int tile = (b * hkv + kvh) * args.row_tiles + rt;
  if (args.splits == 1) {
    if (!active) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + warp * 16 + g + h * 8;
      if (row >= rows) continue;
      const float inv = l_run[h] > 0.0f ? 1.0f / l_run[h] : 0.0f;
      if (args.lse != nullptr && t == 0)
        args.lse[lse_idx(row)] =
            l_run[h] > 0.0f ? m_run[h] + logf(l_run[h]) : -INFINITY;
      bf16* out = args.O + q_ptr(row);
#pragma unroll
      for (int n = 0; n < kDN; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[n][h * 2] * inv, o[n][h * 2 + 1] * inv);
    }
    return;
  }

  // split-KV: this split's normalised partial and its log-sum-exp
  const size_t part = (size_t)tile * args.splits + sp;
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + h * 8;
      if (r0 + r >= rows) continue;
      const float l = l_run[h];
      const float inv = l > 0.0f ? 1.0f / l : 0.0f;
      float* po = args.ws_o + (part * kBR + r) * D;
#pragma unroll
      for (int n = 0; n < kDN; ++n)
        *reinterpret_cast<float2*>(po + n * 8 + 2 * t) =
            make_float2(o[n][h * 2] * inv, o[n][h * 2 + 1] * inv);
      if (t == 0)
        args.ws_lse[part * kBR + r] = l > 0.0f ? m_run[h] + logf(l) : -INFINITY;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int prev = atomicAdd(args.counters + tile, 1);
    s_last = prev == args.splits - 1;
    if (s_last) args.counters[tile] = 0;  // clean for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block merges the splits in split order; the K buffers are free
  // for the weights: [splits][kBR] per row, [kBR] 1/sum, [splits] live flag
  float* w = reinterpret_cast<float*>(Ks);
  const int splits = args.splits;
  float* inv_den = w + splits * kBR;
  int* live = reinterpret_cast<int*>(inv_den + kBR);
  const float* lse = args.ws_lse + (size_t)tile * splits * kBR;
  for (int z = tid; z < splits; z += kThreads) live[z] = 0;
  // every split's log-sum-exps in one pass of parallel loads
  for (int e = tid; e < splits * kBR; e += kThreads) w[e] = __ldcg(lse + e);
  __syncthreads();
  for (int r = tid; r < kBR; r += kThreads) {
    if (r0 + r >= rows) continue;
    float L = -INFINITY;
    for (int z = 0; z < splits; ++z) L = fmaxf(L, w[z * kBR + r]);
    float den = 0.0f;
    for (int z = 0; z < splits; ++z) {
      float x = w[z * kBR + r];
      float wz = (L == -INFINITY || x == -INFINITY) ? 0.0f : expf(x - L);
      w[z * kBR + r] = wz;
      den += wz;
      if (wz != 0.0f) live[z] = 1;
    }
    inv_den[r] = den > 0.0f ? 1.0f / den : 0.0f;
    if (args.lse != nullptr)
      args.lse[lse_idx(r0 + r)] = den > 0.0f ? L + logf(den) : -INFINITY;
  }
  __syncthreads();
  // each thread owns kPer float4 of the tile; per split, all its loads are
  // in flight together (a split with no key for any row is skipped)
  constexpr int kVec = kBR * D / 4;
  constexpr int kPer = (kVec + kThreads - 1) / kThreads;
  constexpr int kChunk = kPer < 16 ? kPer : 16;  // float4 sums held at once
  const float* po = args.ws_o + (size_t)tile * splits * kBR * D;
#pragma unroll
  for (int i0 = 0; i0 < kPer; i0 += kChunk) {
    float4 acc[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int z = 0; z < splits; ++z) {
      if (!live[z]) continue;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int e = tid + (i0 + i) * kThreads;
        const int r = e / (D / 4), c = (e % (D / 4)) * 4;
        if (e >= kVec || r0 + r >= rows) continue;
        const float wz = w[z * kBR + r];
        if (wz == 0.0f) continue;  // this row saw no key in split z
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            po + ((size_t)z * kBR + r) * D + c));
        acc[i].x += wz * v.x;
        acc[i].y += wz * v.y;
        acc[i].z += wz * v.z;
        acc[i].w += wz * v.w;
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int e = tid + (i0 + i) * kThreads;
      const int r = e / (D / 4), c = (e % (D / 4)) * 4;
      if (e >= kVec || r0 + r >= rows) continue;
      const float inv = inv_den[r];
      __nv_bfloat162* out =
          reinterpret_cast<__nv_bfloat162*>(args.O + q_ptr(r0 + r) + c);
      out[0] = __floats2bfloat162_rn(acc[i].x * inv, acc[i].y * inv);
      out[1] = __floats2bfloat162_rn(acc[i].z * inv, acc[i].w * inv);
    }
  }
}


// ---------------------------------------------------------------------------
// The decode instance (head dim 256; a tile of at most kDR = 16 rows, one
// m16 fragment: every gemma2-2b decode tick, sq 1 x a GQA group of 2).
// In flash_kernel such a tile leaves three of the four warps idle and one
// warp runs the whole chain, 14 of its 16 rows padding.  Here the four
// warps split each 64-key tile into quarters of 16 keys: each runs its own
// online softmax (m, l, O) over its keys for the tile's rows, 32 products
// for S and 32 for PV a tile, and at the end of the split the block merges
// the four (m, l, O) through the freed K/V buffers; the splits then merge
// across blocks as in flash_kernel, but over 16-row partials.  Q is staged
// as its 16 rows; K/V tiles are double-buffered as in flash_kernel (one
// stage where a split holds one tile measured no faster: a decode tick's
// blocks are fewer than the SMs).  The softmax works in the log2 domain
// (p = 2^(s c - m c), c = log2(e) / sqrt(d), or log2(e) after a softcap
// whose tanh is 1 - 2 / (1 + 2^(2 y log2 e)): two MUFU operations where
// tanhf takes some twenty instructions).
constexpr int kDR = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kQuarter = kBKV / kWarps;  // keys of a tile per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// tanh(y) from y2 = 2 y log2(e)
__device__ __forceinline__ float tanh_ex2(float y2) {
  return fmaf(-2.0f, rcp(1.0f + ex2(y2)), 1.0f);
}

template <int D>
struct DecodeSmem {
  static constexpr int kLd = D + 8;   // bf16 rows, as Smem's
  static constexpr int kOLd = D + 8;  // fp32 rows of the warps' O: a half
                                      // warp's float2 stores hit 32 banks
  static constexpr int kQ = kDR * kLd;
  static constexpr int kKV = kBKV * kLd;
  static constexpr int kKVBytes = 4 * kKV * 2;  // 2 x (K, V)
  static constexpr int kOBytes = kWarps * kDR * kOLd * 4;
  static constexpr int kBytes =
      kQ * 2 + (kKVBytes > kOBytes ? kKVBytes : kOBytes);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const Args args) {
  using S = DecodeSmem<D>;
  constexpr int kLd = S::kLd, kOLd = S::kOLd;
  constexpr int kDN = D / 8;                    // n8 blocks of the output
  constexpr int kVec = kDR * D / 4;             // float4 of a tile's O
  constexpr int kPer = kVec / kThreads;         // ... a thread
  static_assert(kVec % kThreads == 0 && kQuarter == 16, "decode tiling");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + S::kQ;       // 2 buffers of kKV
  bf16* Vs = Ks + 2 * S::kKV;  // 2 buffers of kKV
  float* Ow = reinterpret_cast<float*>(Ks);  // after the walk: [warp][row]
  __shared__ float s_m[kWarps][kDR], s_l[kWarps][kDR];
  __shared__ float s_inv[kDR], s_lse[kDR];
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int hq = args.hq, hkv = args.hkv, sq = args.sq, skv = args.skv;
  const int grp = hq / hkv;
  const int rows = sq * grp;
  const int qoff = args.q_offset[b];
  const int klen = max(0, min(args.kv_len[b], skv));

  // keys any row can see, cut to this split's key tiles
  int k_end = klen;
  if (args.causal) k_end = min(k_end, qoff + (rows - 1) / grp + 1);
  int k_begin = 0;
  if (args.window > 0) k_begin = max(0, qoff - args.window + 1);
  const int s_begin = sp * args.tiles_per_split * kBKV;
  const int hi = min(k_end, min(skv, s_begin + args.tiles_per_split * kBKV));
  const int lo = max(k_begin, s_begin) / kBKV * kBKV;
  const int n_tiles = hi > lo ? (hi - lo + kBKV - 1) / kBKV : 0;

  const size_t q_row = (size_t)hq * D, kv_row = (size_t)hkv * D;
  const bf16* Kb = args.K + (size_t)b * skv * kv_row + (size_t)kvh * D;
  const bf16* Vb = args.V + (size_t)b * skv * kv_row + (size_t)kvh * D;
  auto q_ptr = [&](int row) {
    return (size_t)(b * sq + row / grp) * q_row +
           (size_t)(kvh * grp + row % grp) * D;
  };
  auto lse_idx = [&](int row) {
    return ((size_t)b * hq + kvh * grp + row % grp) * sq + row / grp;
  };
  const int tile = b * hkv + kvh;
  const size_t part = (size_t)tile * args.splits + sp;

  auto load_kv = [&](int buf, int k0) {
    bf16* kd = Ks + buf * S::kKV;
    bf16* vd = Vs + buf * S::kKV;
    for (int idx = tid; idx < kBKV * D / 8; idx += kThreads) {
      int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      int key = k0 + r;
      bool p = key < hi;  // beyond: zero-filled, and masked below
      size_t off = p ? (size_t)key * kv_row + c : 0;
      cp_async16(kd + r * kLd + c, Kb + off, p);
      cp_async16(vd + r * kLd + c, Vb + off, p);
    }
  };

  if (n_tiles == 0) {  // no key of this split is visible to any row
    if (args.splits == 1) {
      for (int e = tid; e < rows * (D / 8); e += kThreads)
        *reinterpret_cast<uint4*>(args.O + q_ptr(e / (D / 8)) +
                                  (e % (D / 8)) * 8) = make_uint4(0, 0, 0, 0);
      if (args.lse != nullptr && tid < rows)
        args.lse[lse_idx(tid)] = -INFINITY;
      return;
    }
    if (tid < kDR) args.ws_lse[part * kDR + tid] = -INFINITY;
  } else {
    for (int idx = tid; idx < kDR * D / 8; idx += kThreads) {
      int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      bool p = r < rows;
      cp_async16(Qs + r * kLd + c, args.Q + (p ? q_ptr(r) + c : 0), p);
    }
    load_kv(0, lo);
    cp_async_commit();

    const bool cap = args.softcap > 0.0f;
    const float c = cap ? kLog2e : args.scale * kLog2e;
    const float cap2 = cap ? 2.0f * kLog2e * args.scale / args.softcap : 0.0f;
    float o[kDN][4];
#pragma unroll
    for (int n = 0; n < kDN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it & 1;
      if (it + 1 < n_tiles) {
        load_kv((it + 1) & 1, lo + (it + 1) * kBKV);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int kw = lo + it * kBKV + warp * kQuarter;  // this warp's keys
      const bf16* kt = Ks + buf * S::kKV + warp * kQuarter * kLd;
      const bf16* vt = Vs + buf * S::kKV + warp * kQuarter * kLd;
      if (kw < hi && kw + kQuarter > k_begin) {
        // S = Q K^T, 16 rows x 16 keys: two accumulators per n8 block,
        // even and odd k steps, so four chains of eight products
        float s[2][4], s2[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          unsigned qa[4], kb[4];
          ldsm_x4(qa, Qs + (lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
          ldsm_x4(kb, kt + (lane % 8 + (lane / 16) * 8) * kLd + kk * 16 +
                          ((lane / 8) % 2) * 8);
          if (kk % 2) {
            mma16816(s2[0], qa, kb);
            mma16816(s2[1], qa, kb + 2);
          } else {
            mma16816(s[0], qa, kb);
            mma16816(s[1], qa, kb + 2);
          }
        }
        // softcap, mask, online softmax in the log2 domain per row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = g + h * 8;
          const int qpos = qoff + row / grp;
          const bool rvalid = row < rows;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = kw + j * 8 + 2 * t + e;
              float x = s[j][h * 2 + e] + s2[j][h * 2 + e];
              if (cap) x = args.softcap * tanh_ex2(x * cap2);
              bool ok = rvalid && kpos < hi;
              if (args.causal) ok = ok && kpos <= qpos;
              if (args.window > 0) ok = ok && kpos > qpos - args.window;
              x = ok ? x : -INFINITY;
              s[j][h * 2 + e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[h], mx);
          float alpha = 1.0f, sum = 0.0f;
          if (m_new != -INFINITY) {
            const float mc = m_new * c;
            alpha = ex2(m_run[h] * c - mc);  // 0 when m_run is -inf
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float p = ex2(fmaf(s[j][h * 2 + e], c, -mc));
                s[j][h * 2 + e] = p;
                sum += p;
              }
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) s[j][h * 2 + e] = 0.0f;
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          m_run[h] = m_new;
          l_run[h] = l_run[h] * alpha + sum;
#pragma unroll
          for (int n = 0; n < kDN; ++n) {
            o[n][h * 2] *= alpha;
            o[n][h * 2 + 1] *= alpha;
          }
        }
        // O += P V over this warp's 16 keys, P rounded to bf16
        const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int n = 0; n < kDN; n += 2) {
          unsigned vb[4];
          ldsm_x4_trans(vb, vt + (lane % 16) * kLd + n * 8 + (lane / 16) * 8);
          mma16816(o[n], pa, vb);
          mma16816(o[n + 1], pa, vb + 2);
        }
      }
      __syncthreads();  // every warp is done with this buffer before reuse
    }

    // the block's merge of its four warps: each row's max over the warps,
    // each warp's O scaled by 2^((m_w - M) c) into the freed K/V buffers
    if (t == 0) {
      s_m[warp][g] = m_run[0];
      s_m[warp][g + 8] = m_run[1];
      s_l[warp][g] = l_run[0];
      s_l[warp][g + 8] = l_run[1];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + h * 8;
      float M = s_m[0][row];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) M = fmaxf(M, s_m[w][row]);
      const float f =
          m_run[h] == -INFINITY ? 0.0f : ex2((m_run[h] - M) * c);
      float* dst = Ow + (warp * kDR + row) * kOLd + 2 * t;
#pragma unroll
      for (int n = 0; n < kDN; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(o[n][h * 2] * f, o[n][h * 2 + 1] * f);
    }
    if (tid < kDR) {
      float M = s_m[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) M = fmaxf(M, s_m[w][tid]);
      float L = 0.0f;
      if (M != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if (s_m[w][tid] != -INFINITY)
            L += ex2((s_m[w][tid] - M) * c) * s_l[w][tid];
      }
      s_inv[tid] = L > 0.0f ? 1.0f / L : 0.0f;
      s_lse[tid] = L > 0.0f ? (M * c + log2f(L)) * kLn2 : -INFINITY;
    }
    __syncthreads();
    // each thread sums kPer float4 of the tile over the warps
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (D / 4), col = (e % (D / 4)) * 4;
      if (r >= rows) continue;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 v =
            *reinterpret_cast<const float4*>(Ow + (w * kDR + r) * kOLd + col);
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
      const float inv = s_inv[r];
      if (args.splits == 1) {
        __nv_bfloat162* out =
            reinterpret_cast<__nv_bfloat162*>(args.O + q_ptr(r) + col);
        out[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
        out[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
      } else {
        *reinterpret_cast<float4*>(args.ws_o + (part * kDR + r) * D + col) =
            make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
      }
    }
    if (args.splits == 1) {
      if (args.lse != nullptr && tid < rows)
        args.lse[lse_idx(tid)] = s_lse[tid];
      return;
    }
    if (tid < kDR) args.ws_lse[part * kDR + tid] = s_lse[tid];
  }

  // split-KV: the last block of the tile to arrive merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int prev = atomicAdd(args.counters + tile, 1);
    s_last = prev == args.splits - 1;
    if (s_last) args.counters[tile] = 0;  // clean for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // weights [splits][kDR], [kDR] 1/sum and [splits] live flags in the
  // freed K/V buffers
  const int splits = args.splits;
  float* w = reinterpret_cast<float*>(Ks);
  float* inv_den = w + splits * kDR;
  int* live = reinterpret_cast<int*>(inv_den + kDR);
  const float* lse = args.ws_lse + (size_t)tile * splits * kDR;
  for (int z = tid; z < splits; z += kThreads) live[z] = 0;
  for (int e = tid; e < splits * kDR; e += kThreads) w[e] = __ldcg(lse + e);
  __syncthreads();
  if (tid < rows) {
    const int r = tid;
    float L = -INFINITY;
    for (int z = 0; z < splits; ++z) L = fmaxf(L, w[z * kDR + r]);
    float den = 0.0f;
    for (int z = 0; z < splits; ++z) {
      float x = w[z * kDR + r];
      float wz = (L == -INFINITY || x == -INFINITY) ? 0.0f : expf(x - L);
      w[z * kDR + r] = wz;
      den += wz;
      if (wz != 0.0f) live[z] = 1;
    }
    inv_den[r] = den > 0.0f ? 1.0f / den : 0.0f;
    if (args.lse != nullptr)
      args.lse[lse_idx(r)] = den > 0.0f ? L + logf(den) : -INFINITY;
  }
  __syncthreads();
  const float* po = args.ws_o + (size_t)tile * splits * kDR * D;
  float4 acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int z = 0; z < splits; ++z) {
    if (!live[z]) continue;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (D / 4), col = (e % (D / 4)) * 4;
      if (r >= rows) continue;
      const float wz = w[z * kDR + r];
      if (wz == 0.0f) continue;  // this row saw no key in split z
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          po + ((size_t)z * kDR + r) * D + col));
      acc[i].x += wz * v.x;
      acc[i].y += wz * v.y;
      acc[i].z += wz * v.z;
      acc[i].w += wz * v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / (D / 4), col = (e % (D / 4)) * 4;
    if (r >= rows) continue;
    const float inv = inv_den[r];
    __nv_bfloat162* out =
        reinterpret_cast<__nv_bfloat162*>(args.O + q_ptr(r) + col);
    out[0] = __floats2bfloat162_rn(acc[i].x * inv, acc[i].y * inv);
    out[1] = __floats2bfloat162_rn(acc[i].z * inv, acc[i].w * inv);
  }
}

template <int D>
cudaError_t launch(const Args& args, int b, cudaStream_t stream) {
  auto kernel = flash_kernel<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(args.row_tiles * args.splits, args.hkv, b);
  kernel<<<grid, kThreads, Smem<D>::kBytes, stream>>>(args);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_decode(const Args& args, int b, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DecodeSmem<D>::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(args.splits, args.hkv, b);
  kernel<<<grid, kThreads, DecodeSmem<D>::kBytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// q/o [b, sq, hq, d], k/v [b, skv, hkv, d], all contiguous bf16 with
// 16-byte-aligned bases; q_offset/kv_len [b] int32 on the device; lse null
// or fp32 [b, hq, sq].  d is 64, 112, 128 or 256; hq % hkv == 0.
// row_tiles, splits and tiles_per_split come from ops.attention_plan; with
// splits > 1, ws_o holds tiles * splits * 64 * d floats, ws_lse tiles *
// splits * 64 floats and counters tiles zeroed ints (tiles = b * hkv *
// row_tiles).  At d = 256 a tile of at most 16 rows (sq * hq / hkv <= 16,
// one row tile) takes flash_decode_kernel, else flash_kernel.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_offset, const void* kv_len, void* ws_o, void* ws_lse,
    void* counters, int b, int sq, int skv, int hq, int hkv, int d,
    int causal, int window, float softcap, int row_tiles, int splits,
    int tiles_per_split, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  if (row_tiles * kBR < sq * (hq / hkv) || splits < 1 ||
      splits > kMaxSplits || tiles_per_split < 1 ||
      splits * tiles_per_split * kBKV < skv)
    return cudaErrorInvalidValue;
  if (splits > 1 && (ws_o == nullptr || ws_lse == nullptr ||
                     counters == nullptr))
    return cudaErrorInvalidValue;
  Args args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o),
            static_cast<float*>(lse), static_cast<const int*>(q_offset),
            static_cast<const int*>(kv_len),
            static_cast<float*>(ws_o), static_cast<float*>(ws_lse),
            static_cast<int*>(counters), sq, skv, hq, hkv, causal, window,
            softcap, 1.0f / sqrtf(static_cast<float>(d)), row_tiles, splits,
            tiles_per_split};
  auto st = static_cast<cudaStream_t>(stream);
  // ops.decode_instance: a tile of at most 16 rows at head dim 256
  if (d == 256 && sq * (hq / hkv) <= kDR && row_tiles == 1)
    return launch_decode<256>(args, b, st);
  if (d == 256) return launch<256>(args, b, st);
  if (d == 128) return launch<128>(args, b, st);
  if (d == 112) return launch<112>(args, b, st);
  if (d == 64) return launch<64>(args, b, st);
  return cudaErrorInvalidValue;
}
