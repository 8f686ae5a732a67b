// bf16 GEMM on Hopper tensor cores, TMA-fed, with an fp32 accumulator and a
// fused bias/activation epilogue, for sm_90a, bound through a plain C
// interface.  Three tile variants: two stream-K ones for serving and a
// warp-specialized, persistent one for training.
//
// Replaces: src/repro/kernels/matmul.py::matmul (body _mm_kernel, epilogue
// _epilogue, pallas_call at line 102), bf16 mode.  C[M,N] = A[M,K] @ B[K,N],
// then per element, in the TPU kernel's order: + bias[N], then gelu-tanh or
// silu, cast to bf16.  The int8 `scale` mode of the TPU kernel is not here.
// Under autograd a fused activation also writes its pre-activation
// Z[M,N] (after the bias, before the activation, cast to bf16: what the
// same launch without the activation writes to C, bit for bit), which
// the activation's derivative (act_bwd.cu) reads in the backward.
//
// What bounds it on the H100, and the design:
//
// Serving (variants 0 and 1).  M is a prefill chunk (64 rows) or the decode
// slots (4 rows), and K*N is a weight matrix of 1.7 MB to 1 GB.  That is
// 4-64 flops per byte of B, below the ~295 flop/byte ridge, so the bytes of
// B bound every serving shape, and the card's 3.35 TB/s is reached only
// with B streaming into all 132 SMs:
//   - stream-K: a plan (ops.matmul_plan, plain Python) picks the tile
//     variant and the number of blocks P (132 or 264); the (tile, K step)
//     units, tile-major, are cut into P equal runs, so every SM streams the
//     same share of B whatever the tile count (N = 240 gives 4 tiles, the
//     lm_head 2004), with no second wave;
//   - a tile that one block covers whole is finished by it; the blocks that
//     share a tile write fp32 partials to a workspace the wrapper allocates,
//     and the last of them to arrive (an int counter per tile, reset by that
//     block) sums them in block order and applies bias and activation once.
//     One launch, no float atomics: the result does not depend on which
//     block came last;
//   - A and B tiles come by TMA (one thread, one mbarrier per stage) into
//     128-byte-swizzled shared tiles, BK = 64, in a 4-6 stage ring that runs
//     on across tile edges; out-of-range rows and columns arrive as zeros;
//   - 16x64 tiles on mma.sync m16n8k16 (M <= 16, or a B small enough to stay
//     in L2 while several row tiles read it), read from the swizzled tiles by
//     ldmatrix free of bank conflicts; and 64x128 tiles on wgmma m64n128k16
//     (one warpgroup, operands straight from the swizzled tiles) for a
//     prefill chunk.
//
// Training (variant 2).  M is a step's tokens (2048), or a weight's K for
// wgrad; every product runs at 600-1400 flops a byte, so the tensor cores'
// 989 TFLOP/s bound it, and a tile must keep them busy through its K loop
// and between tiles:
//   - 128x256 output tiles, BK = 64: two consumer warpgroups of 64 rows run
//     wgmma m64n256k16 on the same B stage (128 fp32 accumulators a thread),
//     and one producer thread issues every TMA load; setmaxnreg gives the
//     producer warpgroup's registers to the consumers;
//   - a 4-stage ring of 48 KB stages with a full and an empty mbarrier each:
//     a consumer waits for its stage, issues its products, commits them and
//     waits only for the previous K step's group (wgmma.wait_group 1), then
//     releases that stage; no __syncthreads in the main loop;
//   - persistent: one block an SM takes tiles p, p + 132, ... in lock step,
//     in a grouped order (16 row tiles a group, column-major inside it) so
//     that a wave's tiles share their A and B stripes in L2, and the
//     producer loads the next tile while the consumers store this one.  A
//     last wave that would leave more than half the SMs idle (fewer tiles
//     than SMs included) is cut into stream-K runs over all blocks, summed
//     as above;
//   - A is K-major, or MN-major (wgrad's a^T, read straight from the
//     row-major activation by TMA with wgmma's transpose bit): no copy;
//   - the epilogue's activation is a template argument, so the unrolled
//     loop a tile runs holds one activation's code (128 inlined copies of
//     both overflowed the instruction cache once a tile).
//
// The pre-activation output Z (all three variants) is a template flag
// too, asked for only by the up projection's forward under autograd (A
// K-major, B MN-major).  Its five instances are compiled apart: built with
// -DREPRO_MATMUL_ZOUT this file holds only them, behind the C entry
// repro_matmul_z_bf16, and without it only the eleven instances that write
// no Z, behind repro_matmul_bf16.  The two libraries build in parallel,
// and the instances without Z compile exactly as before Z existed.
//
// B may be stored transposed ([N,K], a tied embedding used as the head, or
// dgrad's b^T): it is then K-major like A, and no transposed copy is made.
// Ragged M, N and K need no host padding.  TMA needs 16-byte-aligned bases
// and rows (K % 8 == 0 for a K-major operand, M % 8 or N % 8 == 0 for an
// MN-major one); otherwise variants 0 and 1 store the tiles element by
// element (the "scalar" path), and the wrapper sends such a launch of
// variant 2 to variant 1 (with A transposed by a copy: no model width
// needs it).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

enum Activation { kNone = 0, kGelu = 1, kSilu = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D[16x8] += A[16x16] (row) * B[16x8] (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D[64x128] (fp32, the warpgroup's 64 registers a thread) += A[64x16] B[16x128]
// from shared-memory descriptors; TRANS_B 1: B is MN-major (row-major [K,N])
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// order this thread's generic-proxy stores to shared memory before the
// async proxy's reads of it (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | (uint64_t)1 << 62;
}

// TMA: one thread copies a 2D box from global to shared memory, and the
// bytes land on an mbarrier; out-of-range elements of the box read as zero.
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
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Byte offset of 16-byte chunk c of 128-byte row r of a 128B-swizzled
// atom: rows 128 bytes apart, chunk index XOR (row % 8), the layout TMA's
// SWIZZLE_128B writes and wgmma reads.  A tile of ROWS rows and COLS
// columns (contiguous in global memory) is COLS / 64 such atoms, atom a at
// byte a * ROWS * 128.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}
template <int ROWS>
__device__ __forceinline__ int swz_at(int r, int col) {
  return (col >> 6) * ROWS * 128 + swz(r, (col >> 3) & 7) + (col & 7) * 2;
}

// The scalar variant's load: the same swizzled tile, element by element.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void store_tile(unsigned char* s, const bf16* g,
                                           int ld, int r0, int c0, int R,
                                           int C, int tid) {
  for (int idx = tid; idx < ROWS * COLS; idx += NT) {
    int r = idx / COLS, col = idx % COLS;
    int gr = r0 + r, gc = c0 + col;
    *reinterpret_cast<bf16*>(s + swz_at<ROWS>(r, col)) =
        (gr < R && gc < C) ? g[(size_t)gr * ld + gc] : __float2bfloat16(0.0f);
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

struct Args {
  CUtensorMap tma_a, tma_b;  // the TMA maps of A and B (16-byte path)
  const bf16* A;
  const bf16* B;
  const bf16* bias;
  bf16* C;
  float* ws;      // [2 * gridDim.x, BM*BN] fp32 partial tiles
  int* counters;  // [tiles] arrivals, zero between launches
  int M, N, K, act;
  int whole;  // variant 2: tiles finished whole, before the stream-K ones
  // the pre-activation, or null (last, so that the other fields keep the
  // offsets the kernels without it were compiled against)
  bf16* Z;
};

// WG: one warpgroup runs wgmma m64n128k16 (4 warps of 16 rows x 128
// columns); otherwise WARPS_M x WARPS_N warps run mma.sync.
template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool WG>
struct Config {
  static constexpr int BK = 64;  // one 128-byte swizzle atom of K
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kWM = BM / WARPS_M, kWN = BN / WARPS_N;
  static constexpr int kFM = kWM / 16, kFN = kWN / 8;
  static constexpr int kPairs = kFM * kFN * 2;  // float2 accumulators
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kBBytes = BK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // swizzle atoms need 1024-byte alignment: spare 1 KB to align the ring
  static constexpr int kSmem = STAGES * kStageBytes + 1024;
  // contributors whose partials the merging block loads at once
  static constexpr int kUnroll = kPairs <= 4 ? 16 : 2;
  static_assert(kFM >= 1 && kFN % 2 == 0, "warp tile: 16-row, 16-col steps");
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0,
                "stages keep the swizzle atoms 1024-byte aligned");
  static_assert(BN % 64 == 0, "B tiles are whole 64-column atoms");
  static_assert(kPairs * 2 * kThreads == BM * BN, "partial tile layout");
  static_assert(!WG || (BM == 64 && BN == 128 && WARPS_M == 4 &&
                        WARPS_N == 1),
                "the wgmma variant is one warpgroup on 64x128 tiles");
};

// Block p takes units [p*W/P, (p+1)*W/P) of the W (tile, K step) units,
// tile-major, through one ring that runs on across tile edges.  A tile that
// the block covers whole it finishes; for a shared tile it writes its
// partial (slot 0 for the tile its run starts in, 1 for the one it ends
// in), and the last of the tile's blocks to arrive sums the partials in
// block order and applies the epilogue.  ZOUT: the epilogue also writes
// the pre-activation Z (a template flag, so that the instances without it
// compile as they did before it existed).
template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          int MIN_BLOCKS, bool BT, bool VEC, bool WG, bool ZOUT>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32, MIN_BLOCKS)
    mm_kernel(const __grid_constant__ Args args) {
  using G = Config<BM, BN, WARPS_M, WARPS_N, STAGES, WG>;
  constexpr int BK = G::BK, NT = G::kThreads;
  constexpr int FM = G::kFM, FN = G::kFN, PAIRS = G::kPairs;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int s_last;
  __shared__ __align__(8) uint64_t full[STAGES];  // TMA arrivals per stage
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int M = args.M, N = args.N, K = args.K;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;
  const int tiles_n = (N + BN - 1) / BN;
  const int KT = (K + BK - 1) / BK;
  const long long W = (long long)tiles_n * ((M + BM - 1) / BM) * KT;
  const long long P = gridDim.x;
  auto run_start = [&](long long q) { return q * W / P; };
  auto owner = [&](long long u) { return (int)(((u + 1) * P - 1) / W); };
  const long long u0 = run_start(blockIdx.x);
  const int n_units = (int)(run_start(blockIdx.x + 1) - u0);
  const int first_tile = (int)(u0 / KT);
  // the unit the next load fetches and the unit being computed, as
  // (tile, K step), stepped without divisions
  int ld_tile = first_tile, ld_kt = (int)(u0 % KT);
  int tile = ld_tile, kt = ld_kt;

  // stage s <- the A and B tiles of the next unit
  int ld_m0 = (ld_tile / tiles_n) * BM, ld_n0 = (ld_tile % tiles_n) * BN;
  auto load_unit = [&](int s) {
    const int m0 = ld_m0, n0 = ld_n0, k0 = ld_kt * BK;
    if (++ld_kt == KT) {
      ld_kt = 0;
      ++ld_tile;
      ld_m0 = (ld_tile / tiles_n) * BM;
      ld_n0 = (ld_tile % tiles_n) * BN;
    }
    unsigned char* sa = smem + s * G::kStageBytes;
    unsigned char* sb = sa + G::kABytes;
    if constexpr (VEC) {
      if (tid == 0) {
        mbar_expect_tx(&full[s], G::kStageBytes);
        tma_load_2d(sa, &args.tma_a, k0, m0, &full[s]);
        if constexpr (BT) {  // one box of BN rows of [N,K]: K-major
          tma_load_2d(sb, &args.tma_b, k0, n0, &full[s]);
        } else {  // a box per 64-column atom of [K,N]: MN-major
#pragma unroll
          for (int a = 0; a < BN / 64; ++a)
            tma_load_2d(sb + a * BK * 128, &args.tma_b, n0 + a * 64, k0,
                        &full[s]);
        }
      }
    } else {
      store_tile<BM, BK, NT>(sa, args.A, K, m0, k0, M, K, tid);
      if constexpr (BT) {
        store_tile<BN, BK, NT>(sb, args.B, K, n0, k0, N, K, tid);
      } else {
        store_tile<BK, BN, NT>(sb, args.B, N, k0, n0, K, N, tid);
      }
    }
  };

  float acc[FM][FN][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  };
  zero_acc();

  if constexpr (VEC) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int s = 0; s < STAGES - 1 && s < n_units; ++s) load_unit(s);

  for (int it = 0; it < n_units; ++it) {
    if constexpr (VEC) mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    if constexpr (WG && !VEC) fence_proxy_async();
    __syncthreads();
    // the stage refilled here was read in iteration it-1, which every
    // thread has finished (wgmma reads included: each iteration waits for
    // its own): they all passed the barrier above
    const int nxt = it + STAGES - 1;
    if (nxt < n_units) load_unit(nxt % STAGES);

    const unsigned char* As = smem + (it % STAGES) * G::kStageBytes;
    const unsigned char* Bs = As + G::kABytes;
    if constexpr (WG) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major operands advance 32 bytes inside their swizzle atom; the
        // MN-major B advances two 8-row groups of 1024 bytes
        uint64_t da = smem_desc(As + kk * 32, 16, 1024);
        uint64_t db = BT ? smem_desc(Bs + kk * 32, 16, 1024)
                         : smem_desc(Bs + kk * 2048, BK * 128, 1024);
        wgmma_m64n128k16<BT ? 0 : 1>(&acc[0][0][0], da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned af[FM][4], bfr[FN][2];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          ldsm_x4(af[i], As + swz(wm * G::kWM + i * 16 + lane % 16,
                                  2 * kk + lane / 16));
#pragma unroll
        for (int j = 0; j < FN; j += 2) {
          unsigned r[4];
          const int n = wn * G::kWN + j * 8 + (lane / 16) * 8;
          if constexpr (BT) {  // rows are n, chunks are k
            ldsm_x4(r, Bs + swz(n + lane % 8, 2 * kk + (lane / 8) % 2));
          } else {  // rows are k, 64-column atoms of n, read transposed
            ldsm_x4_trans(r, Bs + (n >> 6) * BK * 128 +
                                 swz(kk * 16 + lane % 16, (n >> 3) & 7));
          }
          bfr[j][0] = r[0];
          bfr[j][1] = r[1];
          bfr[j + 1][0] = r[2];
          bfr[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) mma16816(acc[i][j], af[i], bfr[j]);
      }
    }

    // the end of this block's part of a tile: finish it or hand it on
    if (kt != KT - 1 && it != n_units - 1) {
      ++kt;
      continue;
    }
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    const bool whole = kt == KT - 1 && it >= kt;  // began at K step 0 here
    const int done_tile = tile;
    kt = 0;
    ++tile;
    // pair p = (i, j, h): row m0 + wm*WM + i*16 + g + 8h, cols 2t, 2t+1
    auto row_of = [&](int i, int h) {
      return m0 + wm * G::kWM + i * 16 + g + h * 8;
    };
    if (!whole) {
      // a shared tile: partial out (rows < M only), float2 pair p of
      // thread t at [p * NT + t] of the slot
      const int slot = 2 * blockIdx.x + (done_tile == first_tile ? 0 : 1);
      float2* part = reinterpret_cast<float2*>(args.ws) +
                     (size_t)slot * (PAIRS * NT);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row_of(i, h) < M)
              part[((i * FN + j) * 2 + h) * NT + tid] =
                  make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      __threadfence();
      __syncthreads();
      const int q0 = owner((long long)done_tile * KT);
      const int q1 = owner((long long)(done_tile + 1) * KT - 1);
      if (tid == 0) {
        int prev = atomicAdd(args.counters + done_tile, 1);
        s_last = prev == q1 - q0;
        if (s_last) args.counters[done_tile] = 0;  // clean for the next launch
      }
      __syncthreads();
      if (!s_last) {
        zero_acc();
        continue;
      }
      __threadfence();
      // the last block sums the partials in block order, kUnroll blocks'
      // loads in flight at a time
      float2 sum[PAIRS];
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) sum[p] = make_float2(0.0f, 0.0f);
      for (int q = q0; q <= q1; q += G::kUnroll) {
        float2 v[G::kUnroll][PAIRS];
#pragma unroll
        for (int x = 0; x < G::kUnroll; ++x) {
          const int qq = q + x;
          if (qq > q1) continue;
          const int slot = 2 * qq + (done_tile == run_start(qq) / KT ? 0 : 1);
          const float2* src = reinterpret_cast<const float2*>(args.ws) +
                              (size_t)slot * (PAIRS * NT) + tid;
#pragma unroll
          for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int p = (i * FN + j) * 2 + h;
                v[x][p] = row_of(i, h) < M ? __ldcg(src + p * NT)
                                           : make_float2(0.0f, 0.0f);
              }
        }
#pragma unroll
        for (int x = 0; x < G::kUnroll; ++x) {
          if (q + x > q1) continue;
#pragma unroll
          for (int p = 0; p < PAIRS; ++p) {
            sum[p].x += v[x][p].x;
            sum[p].y += v[x][p].y;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = (i * FN + j) * 2 + h;
            acc[i][j][2 * h] = sum[p].x;
            acc[i][j][2 * h + 1] = sum[p].y;
          }
    }

    // epilogue, once per output element: bias, (the pre-activation out,)
    // then activation
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int r = row_of(i, h);
          if (r >= M) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int c = n0 + wn * G::kWN + j * 8 + 2 * t + e;
            if (c >= N) continue;
            float v = acc[i][j][h * 2 + e];
            if (args.bias != nullptr) v += __bfloat162float(args.bias[c]);
            if constexpr (ZOUT)
              args.Z[(size_t)r * N + c] = __float2bfloat16(v);
            args.C[(size_t)r * N + c] =
                __float2bfloat16(activate(v, args.act));
          }
        }
    zero_acc();
  }
}

// ---------------------------------------------------------------------------
// Variant 2, the training regime: 128x256 output tiles, warp-specialized,
// persistent.  A block is three warpgroups: warpgroup 0 is the producer
// (one thread issues every TMA load; it gives up registers with setmaxnreg),
// warpgroups 1 and 2 are consumers that each run wgmma m64n256k16 on 64 rows
// of the tile, both reading the same B stage.  The two sides meet at a ring
// of kStages stages with a full and an empty mbarrier each, and nothing else
// in the main loop synchronises them.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// mbar_wait that traps after about 2^26 polls, so that a fault in the
// protocol ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, int parity) {
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
// keep the compiler from moving reads or writes of these registers across
// this point (an asynchronous product writes them)
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the two consumer warpgroups only (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// D[64x256] (fp32, the consumer warpgroup's 128 registers a thread) (+)=
// A[64x16] B[16x256] from shared-memory descriptors.  TA: A is MN-major
// (wgrad's a^T, read from the row-major activation); TB: B is MN-major
// (row-major [K,N]); scale_d 0 starts the sum (D = A B).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

struct Ws {
  static constexpr int BM = 128, BN = 256, BK = 64;
  static constexpr int kStages = 4;
  static constexpr int kThreads = 384;  // producer + two consumer warpgroups
  static constexpr int kABytes = BM * BK * 2;  // 16 KB
  static constexpr int kBBytes = BN * BK * 2;  // 32 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;
  static constexpr int kAcc = BN / 2;  // fp32 accumulators a consumer thread
  // row tiles of a group in the tile order: a wave of 132 tiles covers 16
  // row tiles x ~8 column tiles, so it reads about as many bytes of A as
  // of B, and each stripe is shared by the tiles of the wave that need it
  static constexpr int kGroupM = 16;
  // empty-barrier arrivals per stage: lane 0 of each consumer warp
  static constexpr int kReleases = 8;
};

// Output tile t's origin in the grouped order: groups of kGroupM row tiles,
// column-major inside a group, so that neighbouring tiles share B columns.
__device__ __forceinline__ void ws_tile_origin(int t, int tiles_m, int tiles_n,
                                               int& m0, int& n0) {
  const int per_group = Ws::kGroupM * tiles_n;
  const int g = t / per_group, first = g * Ws::kGroupM;
  const int rows = min(tiles_m - first, Ws::kGroupM);
  const int r = t - g * per_group;
  m0 = (first + r % rows) * Ws::BM;
  n0 = (r / rows) * Ws::BN;
}

// A block's items, in the order the producer loads them and the consumers
// compute them: first the tiles it finishes whole (tiles p, p + P, ... below
// `whole`), then its run of the stream-K units of the other tiles
// ((tile, K step) pairs, tile-major, cut into P equal runs), cut at tile
// edges.  An item is (tile, first K step, end K step).
struct WsWalk {
  int P, whole, KT, tile, u, end;
  __device__ WsWalk(int p, int P_, int whole_, int tiles, int KT_)
      : P(P_), whole(whole_), KT(KT_), tile(p) {
    const int W = (tiles - whole) * KT;  // W * P < 2^31: launch_ws checks
    u = W * p / P;
    end = W * (p + 1) / P;
  }
  __device__ bool next(int& t, int& k0, int& k1) {
    if (tile < whole) {
      t = tile;
      k0 = 0;
      k1 = KT;
      tile += P;
      return true;
    }
    if (u >= end) return false;
    t = whole + u / KT;
    k0 = u % KT;
    k1 = min(KT, k0 + (end - u));
    u += k1 - k0;
    return true;
  }
};

// A 4x4 transpose of packed bf16 pairs across the 4 lanes of a quad
// (lanes 4g .. 4g + 3, tq = lane % 4): before, lane tq holds v[jj] =
// columns 2tq, 2tq + 1 of the quad's 8-column block jj; after, it holds
// block tq's 8 columns in order (v[t] from lane t).  Two exchanges, with
// the lanes 2 apart and then 1 apart.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int tq) {
  const bool hi2 = tq & 2, hi1 = tq & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi2 ? v[0] : v[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi2 ? v[1] : v[3], 2);
  if (hi2) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, hi1 ? v[0] : v[1], 1);
  r1 = __shfl_xor_sync(0xffffffffu, hi1 ? v[2] : v[3], 1);
  if (hi1) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One row (h) of 32 columns (q) of a consumer thread's share into dst:
// bias, then activation, cast to bf16.  Register 4j + 2h + e of the wgmma
// layout is row row0 + 8h, column n0 + 8j + 2tq + e.  A quad's four lanes
// trade their pairs (quad_transpose) so that each stores 16 contiguous
// bytes, whole 32-byte sectors per row: half the store transactions of
// 4-byte stores, which held the tensor cores idle at the end of every
// tile.  The bias is read per use, not held, to keep the epilogue within
// the consumers' registers beside 128 accumulators.
template <int ACT>
__device__ __forceinline__ void ws_store_row(bf16* dst, const bf16* bias,
                                             const float* acc, int q, int h,
                                             int row0, int c0, int tq, int M,
                                             int N) {
  uint32_t v[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int c = c0 + 8 * jj + 2 * tq;
    const float* a = acc + 4 * (4 * q + jj) + 2 * h;
    const float b0 = bias != nullptr && c < N
                         ? __bfloat162float(bias[c]) : 0.0f;
    const float b1 = bias != nullptr && c + 1 < N
                         ? __bfloat162float(bias[c + 1]) : 0.0f;
    v[jj] = pack_bf16(activate(a[0] + b0, ACT), activate(a[1] + b1, ACT));
  }
  quad_transpose(v, tq);
  const int r = row0 + 8 * h, c = c0 + 8 * tq;
  if (r >= M || c >= N) return;
  bf16* out = dst + (size_t)r * N + c;
  if ((N & 7) == 0 && c + 8 <= N) {  // 16-byte aligned row starts
    *reinterpret_cast<uint4*>(out) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __nv_bfloat162 pr =
          *reinterpret_cast<const __nv_bfloat162*>(&v[e >> 1]);
      if (c + e < N) out[e] = (e & 1) ? pr.y : pr.x;
    }
  }
}

// The epilogue of a consumer thread's 64 x 256 share, once per output
// element.  The activation is a template argument so that the unrolled
// loop a tile runs holds only its own code: 128 inlined copies of both
// activations overflowed the instruction cache once a tile.  ZOUT: the
// pre-activation goes to Z first, by the same arithmetic with no
// activation (so bit for bit what a launch without one writes to C), in a
// pass of its own so that only one row's four packed registers are live.
template <int ACT, bool ZOUT>
__device__ __forceinline__ void ws_epilogue(const Args& args, const float* acc,
                                            int row0, int n0, int tq) {
  const int M = args.M, N = args.N;
#pragma unroll
  for (int q = 0; q < Ws::BN / 32; ++q) {  // 4 blocks of 8 columns
    const int c0 = n0 + 32 * q;
    if (c0 >= N) break;  // the same for the whole warp
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (ZOUT)
        ws_store_row<kNone>(args.Z, args.bias, acc, q, h, row0, c0, tq, M, N);
      ws_store_row<ACT>(args.C, args.bias, acc, q, h, row0, c0, tq, M, N);
    }
  }
}

template <bool AT, bool BT, bool ZOUT>
__global__ void __launch_bounds__(Ws::kThreads, 1)
    ws_kernel(const __grid_constant__ Args args) {
  constexpr int BM = Ws::BM, BN = Ws::BN, BK = Ws::BK, S = Ws::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ int s_last;
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int M = args.M, N = args.N, K = args.K;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n, KT = (K + BK - 1) / BK;
  const int p = blockIdx.x, P = gridDim.x, whole = args.whole;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Ws::kReleases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: stage n of the block's unit sequence goes to ring slot
    // n % S once the consumers have released that slot's previous use.
    // One thread issues the TMA loads; the warpgroup gives registers to
    // the consumers (128 x 40 + 256 x 232 is the 384 x 168 the block was
    // launched with).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    WsWalk walk(p, P, whole, tiles, KT);
    int t, k0, k1, n = 0;
    while (walk.next(t, k0, k1)) {
      int m0, n0;
      ws_tile_origin(t, tiles_m, tiles_n, m0, n0);
      for (int kt = k0; kt < k1; ++kt, ++n) {
        const int s = n % S;
        mbar_wait_or_trap(&empty[s], ((n / S) & 1) ^ 1);
        unsigned char* sa = smem + s * Ws::kStageBytes;
        unsigned char* sb = sa + Ws::kABytes;
        const int kk = kt * BK;
        mbar_expect_tx(&full[s], Ws::kStageBytes);
        if constexpr (AT) {  // two 64-row atoms of a^T, read MN-major
          tma_load_2d(sa, &args.tma_a, m0, kk, &full[s]);
          tma_load_2d(sa + BK * 128, &args.tma_a, m0 + 64, kk, &full[s]);
        } else {
          tma_load_2d(sa, &args.tma_a, kk, m0, &full[s]);
        }
        if constexpr (BT) {  // one box of BN rows of [N,K]: K-major
          tma_load_2d(sb, &args.tma_b, kk, n0, &full[s]);
        } else {  // a box per 64-column atom of [K,N]: MN-major
#pragma unroll
          for (int a = 0; a < BN / 64; ++a)
            tma_load_2d(sb + a * BK * 128, &args.tma_b, n0 + a * 64, kk,
                        &full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw computes rows [64 cw, 64 cw + 64) of each
  // tile; a K step's wgmma group stays in flight while the next one is
  // issued, and its stage is released once it has completed
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1, ctid = threadIdx.x - 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane / 4, tq = lane % 4;
  const int W = (tiles - whole) * KT;
  auto run_start = [&](int q) { return q * W / P; };
  auto owner = [&](int u) { return ((u + 1) * P - 1) / W; };
  const int first_split = whole + run_start(p) / KT;

  float acc[Ws::kAcc];
  WsWalk walk(p, P, whole, tiles, KT);
  int t, k0, k1, n = 0;
  while (walk.next(t, k0, k1)) {
    for (int kt = k0; kt < k1; ++kt, ++n) {
      const int s = n % S;
      mbar_wait_or_trap(&full[s], (n / S) & 1);
      const unsigned char* As = smem + s * Ws::kStageBytes + cw * 64 * 128;
      const unsigned char* Bs = smem + s * Ws::kStageBytes + Ws::kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major operands advance 32 bytes inside their swizzle atom; the
        // MN-major ones two 8-row groups of 1024 bytes, their 64-wide atoms
        // BK * 128 bytes apart
        const uint64_t da = AT ? smem_desc(As + kk * 2048, BK * 128, 1024)
                               : smem_desc(As + kk * 32, 16, 1024);
        const uint64_t db = BT ? smem_desc(Bs + kk * 32, 16, 1024)
                               : smem_desc(Bs + kk * 2048, BK * 128, 1024);
        wgmma_m64n256k16<AT ? 1 : 0, BT ? 0 : 1>(acc, da, db,
                                                 kt > k0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous K step's products are done
      if (kt > k0 && lane == 0) mbar_arrive(&empty[(n - 1) % S]);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(n - 1) % S]);
    fence_regs<Ws::kAcc>(acc);

    int m0, n0;
    ws_tile_origin(t, tiles_m, tiles_n, m0, n0);
    if (k0 != 0 || k1 != KT) {
      // a shared tile: partial out, float2 pair q of consumer thread ctid
      // at [q * 256 + ctid] of the slot (0 for the tile the block's run
      // starts in, 1 for the one it ends in); the last of the tile's blocks
      // to arrive sums the partials in block order
      const int slot = 2 * p + (t == first_split ? 0 : 1);
      float2* part = reinterpret_cast<float2*>(args.ws) +
                     (size_t)slot * (BM * BN / 2);
#pragma unroll
      for (int q = 0; q < Ws::kAcc / 2; ++q)
        part[q * 256 + ctid] = make_float2(acc[2 * q], acc[2 * q + 1]);
      __threadfence();
      consumer_sync();
      const int ut = (t - whole) * KT;
      const int q0 = owner(ut), q1 = owner(ut + KT - 1);
      if (ctid == 0) {
        const int prev = atomicAdd(args.counters + t, 1);
        s_last = prev == q1 - q0;
        if (s_last) args.counters[t] = 0;  // clean for the next launch
      }
      consumer_sync();
      if (!s_last) continue;
      __threadfence();
#pragma unroll
      for (int i = 0; i < Ws::kAcc; ++i) acc[i] = 0.0f;
      for (int qq = q0; qq <= q1; ++qq) {
        const int sl = 2 * qq + (t == whole + run_start(qq) / KT ? 0 : 1);
        const float2* src = reinterpret_cast<const float2*>(args.ws) +
                            (size_t)sl * (BM * BN / 2) + ctid;
#pragma unroll
        for (int q = 0; q < Ws::kAcc / 2; ++q) {
          const float2 v = __ldcg(src + q * 256);
          acc[2 * q] += v.x;
          acc[2 * q + 1] += v.y;
        }
      }
    }

    const int row0 = m0 + cw * 64 + warp * 16 + g;
    if (args.act == kGelu) {
      ws_epilogue<kGelu, ZOUT>(args, acc, row0, n0, tq);
    } else if (args.act == kSilu) {
      ws_epilogue<kSilu, ZOUT>(args, acc, row0, n0, tq);
    } else if constexpr (!ZOUT) {  // dispatch refuses Z with no activation
      ws_epilogue<kNone, false>(args, acc, row0, n0, tq);
    }
  }
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

// map of a row-major bf16 [rows, cols] matrix in boxes of box_rows x 64
// columns (128 bytes), 128-byte swizzled as wgmma reads them.  With
// wide_l2, L2 fetches 256 bytes per row: right where the next 128 bytes are
// this block's next box (the next K step of a K-major operand, the second
// atom of a 128-column B tile), and a waste of DRAM bytes where they belong
// to another block's tile.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows, bool wide_l2) {
  auto fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            wide_l2 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                    : CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          int MIN_BLOCKS, bool BT, bool VEC, bool WG = false,
          bool ZOUT = false>
cudaError_t launch(Args args, int blocks, cudaStream_t stream) {
  using G = Config<BM, BN, WARPS_M, WARPS_N, STAGES, WG>;
  constexpr int BK = G::BK;
  if constexpr (VEC) {
    bool ok = tensor_map(&args.tma_a, args.A, args.M, args.K, BM, true) &&
              (BT ? tensor_map(&args.tma_b, args.B, args.N, args.K, BN, true)
                  : tensor_map(&args.tma_b, args.B, args.K, args.N, BK,
                               BN >= 128));
    if (!ok) return cudaErrorInvalidValue;
  }
  auto kernel =
      mm_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS, BT, VEC, WG,
                ZOUT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long kt = (args.K + BK - 1) / BK;
  const long long units =
      (long long)((args.N + BN - 1) / BN) * ((args.M + BM - 1) / BM) * kt;
  if (blocks < 1 || blocks > units) return cudaErrorInvalidValue;
  bool shared = false;  // some run starts inside a tile
  for (long long p = 1; p < blocks && !shared; ++p)
    shared = p * units / blocks % kt != 0;
  if (shared && (args.ws == nullptr || args.counters == nullptr))
    return cudaErrorInvalidValue;
  kernel<<<blocks, G::kThreads, G::kSmem, stream>>>(args);
  return cudaGetLastError();
}

template <bool AT, bool BT, bool ZOUT>
cudaError_t launch_ws(Args args, int blocks, cudaStream_t stream) {
  constexpr int BM = Ws::BM, BN = Ws::BN, BK = Ws::BK;
  bool ok = (AT ? tensor_map(&args.tma_a, args.A, args.K, args.M, 64, true)
                : tensor_map(&args.tma_a, args.A, args.M, args.K, BM, true)) &&
            (BT ? tensor_map(&args.tma_b, args.B, args.N, args.K, BN, true)
                : tensor_map(&args.tma_b, args.B, args.K, args.N, BK, true));
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = ws_kernel<AT, BT, ZOUT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ws::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long kt = (args.K + BK - 1) / BK;
  const long long tiles =
      (long long)((args.N + BN - 1) / BN) * ((args.M + BM - 1) / BM);
  const long long units = (tiles - args.whole) * kt;  // the stream-K ones
  // the kernel's unit arithmetic (units * blocks) runs in 32 bits
  if (blocks < 1 || args.whole < 0 || args.whole > tiles ||
      units * blocks >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  if (units > 0) {
    // every block has a non-empty run, and a run that starts inside a
    // tile needs the workspace and the counters
    if (blocks > units) return cudaErrorInvalidValue;
    bool shared = false;
    for (long long p = 1; p < blocks && !shared; ++p)
      shared = p * units / blocks % kt != 0;
    if (shared && (args.ws == nullptr || args.counters == nullptr))
      return cudaErrorInvalidValue;
  } else if (blocks > tiles) {
    return cudaErrorInvalidValue;
  }
  kernel<<<blocks, Ws::kThreads, Ws::kSmem, stream>>>(args);
  return cudaGetLastError();
}

#ifdef REPRO_MATMUL_ZOUT
constexpr bool kZout = true;  // this library: the instances that write Z
#else
constexpr bool kZout = false;
#endif

// variant: the tile shape ops.matmul_plan chose (its MATMUL_VARIANTS order).
// Only variant 2 reads A transposed or finishes tiles whole, and it takes
// only operands TMA can read (the wrapper sends others to variant 1).  The
// pre-activation output has instances only for a row-major A and B (the
// up projection's layout; no wgrad or tied head has an activation).
template <bool AT, bool BT, bool VEC>
cudaError_t dispatch(int variant, const Args& args, int blocks,
                     cudaStream_t stream) {
  if ((args.Z != nullptr) != kZout) return cudaErrorInvalidValue;
  if constexpr (kZout) {
    if constexpr (!AT && !BT) {
      if (args.act == kNone || (variant != 2 && args.whole != 0))
        return cudaErrorInvalidValue;
      switch (variant) {
        case 0:
          return launch<16, 64, 1, 4, 6, 2, false, VEC, false, true>(
              args, blocks, stream);
        case 1:
          return launch<64, 128, 4, 1, 4, 2, false, VEC, true, true>(
              args, blocks, stream);
        case 2:
          if constexpr (VEC)
            return launch_ws<false, false, true>(args, blocks, stream);
      }
    }
    return cudaErrorInvalidValue;
  } else {
    if (variant == 2) {
      if constexpr (VEC)
        return launch_ws<AT, BT, false>(args, blocks, stream);
      return cudaErrorInvalidValue;
    }
    if constexpr (!AT) {
      if (args.whole != 0) return cudaErrorInvalidValue;
      switch (variant) {
        case 0:  // 16x64 on mma.sync: decode rows, or a small B
          return launch<16, 64, 1, 4, 6, 2, BT, VEC>(args, blocks, stream);
        case 1:  // 64x128 on wgmma: a prefill chunk
          return launch<64, 128, 4, 1, 4, 2, BT, VEC, true>(args, blocks,
                                                            stream);
      }
    }
    return cudaErrorInvalidValue;
  }
}

#ifdef REPRO_MATMUL_ZOUT
#define REPRO_MATMUL_ENTRY repro_matmul_z_bf16
#else
#define REPRO_MATMUL_ENTRY repro_matmul_bf16
#endif

}  // namespace

// a [M,K] row-major, or (a_trans, variant 2 and vec only) stored [K,M]
// row-major; b [K,N] row-major, or (b_trans) stored [N,K] row-major (not
// both transposed); bias [N] or null; c [M,N] row-major.  act: 0 none, 1 gelu-tanh, 2 silu.
// z: [M,N] row-major for the pre-activation (bias added, no activation;
// a row-major a and b, and an activation) in repro_matmul_z_bf16, null in
// repro_matmul_bf16.
// vec: 1 when the TMA path applies (16-byte-aligned bases, and 16-byte rows:
// K % 8 == 0 for a row-major a or a transposed b, M % 8 == 0 for a
// transposed a, N % 8 == 0 for a row-major b); 0 loads the tiles element
// by element (variants 0 and 1).  variant, blocks and whole come from
// ops.matmul_plan (whole:
// variant 2's tiles finished whole, 0 for the others); where a block's run
// starts inside a tile, ws holds 2 * blocks * BM * BN floats and counters
// one zeroed int per output tile.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int REPRO_MATMUL_ENTRY(const void* a, const void* b,
                                  const void* bias, void* c, void* z,
                                  void* ws, void* counters, int M, int N,
                                  int K, int a_trans, int b_trans, int act,
                                  int vec, int variant, int blocks, int whole,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (a_trans && b_trans))
    return cudaErrorInvalidValue;
  Args args{};
  args.A = static_cast<const bf16*>(a);
  args.B = static_cast<const bf16*>(b);
  args.bias = static_cast<const bf16*>(bias);
  args.C = static_cast<bf16*>(c);
  args.Z = static_cast<bf16*>(z);
  args.ws = static_cast<float*>(ws);
  args.counters = static_cast<int*>(counters);
  args.M = M;
  args.N = N;
  args.K = K;
  args.act = act;
  args.whole = whole;
  auto st = static_cast<cudaStream_t>(stream);
  if (a_trans) {
    return vec ? dispatch<true, false, true>(variant, args, blocks, st)
               : cudaErrorInvalidValue;
  }
  if (b_trans) {
    return vec ? dispatch<false, true, true>(variant, args, blocks, st)
               : dispatch<false, true, false>(variant, args, blocks, st);
  }
  return vec ? dispatch<false, false, true>(variant, args, blocks, st)
             : dispatch<false, false, false>(variant, args, blocks, st);
}
