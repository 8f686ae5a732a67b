// The attention forward in its training regime (s = 2048 and the like) on
// Hopper's warpgroup tensor cores (wgmma) fed by TMA, warp-specialized and
// persistent; bf16 in and out, fp32 accumulators and log-sum-exp, for
// sm_90a, bound through a plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel, pallas_call at line 102) at the shapes ops.attention_plan
// gives variant 1 (no key split, at least 128 q rows, head dim 112, 128 or
// 256); flash_attention.cu keeps the serving shapes (a 64-row prefill
// chunk, a decode row).  It computes what that kernel computes with its log-sum-exp:
//   qpos = q_offset[b] + i;  key j is visible when  j < kv_len[b],
//   j <= qpos (causal),  j > qpos - window (window > 0);
// scores x = s / sqrt(d), or softcap * tanh(s / (sqrt(d) softcap)), of
// s = q.k; O = softmax(x) V with the probabilities rounded to bf16 for the
// PV product and normalised by their fp32 sum; each row's natural-log
// log-sum-exp of its visible x, which flash_attention_bwd.cu reads (-inf,
// and O = 0, for a row that sees no key).
//
// What bounds it on the H100: operations.  At llama3-8b's s = 2048 the
// causal square holds 67 M visible (q, key) pairs a layer: 34 GFLOP of
// products against 42 MB of Q, K, V and O, and some 70 M exponentials,
// which on the SFU take more than half the tensor cores' time and have to
// run under the products.  The design (FA3's forward, simplified):
//   - one block an SM, persistent, three warpgroups: warpgroup 0 is the
//     producer (one thread issues every TMA load; the warpgroup gives its
//     registers away with setmaxnreg), warpgroups 1 and 2 are consumers
//     that each own 64 rows of a 128-row Q tile of one q head;
//   - Q, K and V arrive by 4D TMA maps over [b, s, heads, d] in boxes of 64
//     columns x 128 rows, 128-byte swizzled (rows and keys out of range and
//     the columns of a head dim of 112 padded to 128 read as zeros); K and
//     V tiles of 128 keys go through a ring of two stages with full and
//     empty mbarriers, K and V apart: the producer sends K one tile ahead of
//     V (V is released a tile later), and S = Q K^T starts before V lands;
//     a consumer releases Q after its last S of an item, so the next item's
//     Q loads under this one's last PV product and store;
//   - S = Q K^T is wgmma m64n128k16 from shared memory, O += P V wgmma with P
//     as a bf16 register operand and V read MN-major, fp32 accumulators;
//     S of key tile j is issued with O += P V of tile j - 1, and the
//     softmax of tile j runs while that product is on the tensor cores; the
//     two consumers take turns at issuing their products (two named
//     barriers), so one's softmax runs under the other's products;
//   - the softmax works in the log2 domain: p = ex2(s * c - m * c) with c =
//     log2(e) / sqrt(d) folded into one FFMA, the row max is the raw
//     scores', O and the row sum are rescaled by ex2 of the max's change;
//     the mask is evaluated only on key tiles that cross the diagonal,
//     kv_len or the window's edge, as two bounds a row; tiles hidden from
//     every row are never loaded;
//   - the host's schedule (ops.attention_train_schedule) deals the work
//     items -- (batch row, q head, row tile) -- to the block with the least
//     work so far: groups of kv heads whose K/V fit a share of the L2 one
//     after another, longest first inside a group, the q heads of a kv
//     group next to each other; no split over keys and no atomics, so the
//     same inputs give the same bits.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py's train-kernels,
// PERF.md): ahead of scaled_dot_product_attention at llama3-8b's, gpt-m2's
// and zamba2-7b's s = 2048.  What held it back on the way there: a product
// issued under a branch (ptxas serialized every wgmma), a mask of a dozen
// integer operations an element, and schedules that let 32 or 64 heads'
// K/V fall out of the L2.
// Head dim 256 (gemma2-2b) is an instance of its own, fa_train256_kernel:
// O at 64 x 256 fp32 is 128 registers a consumer thread, and Q with two
// stages of 128-key K and V tiles would be 320 KB, so its key tiles are 64
// (Q 64 KB + 2 x (K 32 + V 32) = 192 KB; S 32 and P 16 registers beside
// O, under the consumers' 240).  A 128-key tile with one stage would fit
// (192 KB) but leave no load in flight under the products.  Its softcap
// takes tanh as 1 - 2 / (1 + e^(2y)) (tanh_ex2): with tanhf the softmax
// outlasted the tile's products.  What bounds it at train-gemma's b = 1,
// 8 q heads (128 items on 132 blocks, one each): the chain of the last row
// tile's 32 key tiles, S then its softmax then P V on each consumer.
// q/k of head dim 192 with a V of 128 (deepseek-v3's MLA: 128 nope + 64
// rope columns score, 128 columns of V) is an instance of its own,
// fa_train_dv_kernel: the d = 128 design with S = Q K^T over 12 k steps
// of 16 (three 64-column chunks of Q and K, a 128-byte swizzle span each)
// and O += P V over V's two chunks, as at d = 128.  Q at 128 x 192 is 48
// KB, a K/V stage 48 + 32 KB, so two stages and Q take 208 KB (with the
// 1 KB alignment 209, under the 227 KB a block may have) and key tiles
// stay 128 wide; S (64), O (64) and P (32) registers a consumer thread,
// as at d = 128.  The scale is 1 / sqrt(192), of q's dim, and the TMA
// maps of Q and K carry 192 columns, V's and O's 128.
// Measured slower or no faster on the H100 (PERF.md): pairing
// 64-row tiles p and R - 1 - p on one K/V stream (the lone consumer still
// waits its turn every tile), and rows of 64 whose two consumers split the
// walk and merge (twice the K/V traffic a product, which the L2 does not
// feed).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kRows = 128;     // q positions of a tile, 64 a consumer
constexpr int kKeys = 128;     // keys of a K/V tile
constexpr int kStages = 2;     // K/V ring
constexpr int kChunk = 128 * 128;  // 64 columns x 128 rows of bf16: 16 KB
constexpr int kTile = 2 * kChunk;  // a 128 x 128 tile, head dim padded
// smem: Q, then the K stages, then the V stages; 1 KB to align to 1024
constexpr int kSmemBytes = (1 + 2 * kStages) * kTile + 1024;
// head dim 256: key tiles of 64; Q is four chunks (64 KB), a K or V tile
// four chunks of 64 keys (32 KB); Q and two stages of K and V are 192 KB
constexpr int kKeys256 = 64;
constexpr int kKvChunk = 64 * 128;
constexpr int kKvTile = 4 * kKvChunk;
constexpr int kSmem256 = 4 * kChunk + 2 * kStages * kKvTile + 1024;
// q/k 192, V 128: Q three chunks (48 KB), a K stage three (48 KB), a V
// stage two (32 KB): 48 + 2 x (48 + 32) = 208 KB and the alignment
constexpr int kQkChunks = 3;
constexpr int kVChunks = 2;
constexpr int kDv = 128;
constexpr int kSmemDv =
    (kQkChunks + kStages * (kQkChunks + kVChunks)) * kChunk + 1024;
static_assert(kSmemDv <= 232448, "q/k 192, V 128: over the block's smem");
// empty-barrier arrivals: lane 0 of each consumer warp
constexpr int kReleases = 8;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// D[64x128] (fp32, 64 registers a thread) (+)= A[64x16] B[16x128]: A and B
// K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
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
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x128] (fp32, 64 registers a thread) += A[64x16] B[16x128]: A from
// registers (four bf16 pairs a thread, mma.sync's A layout per warp), B
// MN-major in shared memory
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

// D[64x64] (fp32, 32 registers a thread) (+)= A[64x16] B[16x64]: A and B
// K-major in shared memory (S at head dim 256)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
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

// D[64x256] (fp32, 128 registers a thread) += A[64x16] B[16x256]: A from
// registers (as wgmma_rs_n128), B MN-major in shared memory (O += P V at
// head dim 256)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const unsigned* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
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
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// named barriers 1 and 2 (0 is __syncthreads'): the two consumer
// warpgroups take turns at issuing their products
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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
// A tile is two 64-column chunks of 128 rows of 128 bytes.  K-major operand
// (rows read along the head dim): k step kk of 16 columns is 32 bytes into
// chunk kk / 4, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile,
                                           int kk) {
  return smem_desc(tile + (kk >> 2) * kChunk + (kk & 3) * 32, 16, 1024);
}
// MN-major B (V: k steps run down the 128 key rows, N = the head dim across
// the two chunks): k step kk of 16 keys is 2048 bytes down each chunk
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile,
                                            int kk) {
  return smem_desc(tile + kk * 2048, kChunk, 1024);
}
// At head dim 256 a K or V tile is four 64-column chunks of 64 keys
// (kKvChunk): the same two reads with chunks of 64 rows
__device__ __forceinline__ uint64_t desc_k64(const unsigned char* tile,
                                             int kk) {
  return smem_desc(tile + (kk >> 2) * kKvChunk + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn64(const unsigned char* tile,
                                              int kk) {
  return smem_desc(tile + kk * 2048, kKvChunk, 1024);
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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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
// a 64-column x 128-row box of a 4D map [batch, seq, heads, d] at (col,
// head, row, b)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int col, int head, int row, int b,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row), "r"(b)
      : "memory");
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
// tanh(y) = 1 - 2 / (1 + e^(2y)) from y2 = 2 y log2(e): two MUFU
// operations where tanhf takes some twenty instructions; about 1e-7 from
// tanhf, 5e-6 on a score capped at 50 (the scores' exponentials then
// agree to 5e-6, far inside bf16's rounding of P)
__device__ __forceinline__ float tanh_ex2(float y2) {
  return fmaf(-2.0f, rcp(1.0f + ex2(y2)), 1.0f);
}

struct Args {
  CUtensorMap tq, tk, tv;  // TMA maps of Q, K, V
  bf16* O;                 // [b, sq, hq, d]
  float* lse;              // [b, hq, sq], or null (serving)
  const int* q_offset;
  const int* kv_len;
  const int* sched;  // [ctas + 1] offsets into the items that follow
  int b, sq, skv, hq, hkv, d, causal, window, row_tiles, ctas;
  // c: log2(e) / sqrt(d), or log2(e) with a softcap (the scores are then
  // capped first); cap_in = 1 / (sqrt(d) softcap)
  float softcap, cap_in, c;
};

// A work item: row tile `p0` of q head `h` of batch row `b`, and the key
// tiles [kt0, kt0 + nt) of KEYS keys its rows can see (ref.train_key_tiles).
struct Item {
  int b, h, p0, qoff, klen, kt0, nt;
};

template <int KEYS = kKeys>
__device__ __forceinline__ Item item_of(const Args& a, int id) {
  Item it;
  const int bh = id / a.row_tiles;
  it.p0 = (id % a.row_tiles) * kRows;
  it.h = bh % a.hq;
  it.b = bh / a.hq;
  it.qoff = a.q_offset[it.b];
  it.klen = max(0, min(a.kv_len[it.b], a.skv));
  int k_end = it.klen, k_begin = 0;
  if (a.causal) k_end = min(k_end, min(it.p0 + kRows, a.sq) + it.qoff);
  if (a.window > 0) k_begin = max(0, it.p0 + it.qoff - a.window + 1);
  it.kt0 = k_begin / KEYS;
  it.nt = k_end > k_begin ? (k_end - it.kt0 * KEYS + KEYS - 1) / KEYS : 0;
  return it;
}

// Whether every (row, key) of the tile's 128 x KEYS square is visible, so
// that its mask can be skipped.
template <int KEYS = kKeys>
__device__ __forceinline__ bool whole(const Args& a, const Item& it, int k0) {
  return k0 + KEYS <= it.klen &&
         (!a.causal || k0 + KEYS - 1 <= it.p0 + it.qoff) &&
         (a.window <= 0 || it.p0 + kRows - 1 + it.qoff - k0 < a.window);
}

// One key tile's online softmax on a consumer thread's scores s (rows row0
// and row0 + 8, keys k0 + 8j + 2 t4 + e of a tile of KEYS): the softcap,
// the mask where the tile crosses an edge, then in the log2 domain the row
// max m of the raw (or capped) scores, p = 2^(s c - m c) in place, alpha =
// 2^(m_old c - m c) (0 while m_old is -inf) and l = alpha l + this thread's
// share of the row sum (the quad's four shares are added at the end).
// FAST_TANH: the softcap's tanh by tanh_ex2 (head dim 256, where tanhf's
// instructions outlast the tile's products).
template <bool CAP, int KEYS = kKeys, bool FAST_TANH = false>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* alpha, const Args& a,
                                             const Item& it, int k0, int row0,
                                             int t4) {
  constexpr int J = KEYS / 8;  // 8-key column groups of a thread's scores
  if constexpr (CAP && FAST_TANH) {
    const float y2 = 2.0f * 1.4426950408889634f * a.cap_in;
#pragma unroll
    for (int x = 0; x < 4 * J; ++x)
      s[x] = a.softcap * tanh_ex2(s[x] * y2);
  } else if constexpr (CAP) {
#pragma unroll
    for (int x = 0; x < 4 * J; ++x)
      s[x] = a.softcap * tanhf(s[x] * a.cap_in);
  }
  if (!whole<KEYS>(a, it, k0)) {
    // key k0 + 2 t4 + cx is visible from qpos when lo <= cx < hi
    const int base = k0 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row0 + 8 * h + it.qoff;
      const int hi = a.causal ? min(it.klen, qpos + 1) - base
                              : it.klen - base;
      const int lo = a.window > 0 ? qpos - a.window + 1 - base : -(1 << 30);
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cx = 8 * jj + e;
          if (cx >= hi || cx < lo) s[4 * jj + 2 * h + e] = -INFINITY;
        }
      }
    }
  }
  const float c = a.c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * h], s[4 * jj + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mc = mx == -INFINITY ? 0.0f : mx * c;
    alpha[h] = ex2(fmaf(m[h], c, -mc));
    m[h] = mx;
    float sum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * jj + 2 * h + e;
        s[x] = ex2(fmaf(s[x], c, -mc));
        sum += s[x];
      }
    }
    l[h] = fmaf(l[h], alpha[h], sum);
  }
}

// The kernel.  KSTEPS: 16-column k steps of S = Q K^T (7 at d = 112, whose
// padding columns are zeros, 8 at d = 128).  CAP: a softcap is applied.
template <int KSTEPS, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    fa_train_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, q_empty, k_full[kStages],
      k_empty[kStages], v_full[kStages], v_empty[kStages];
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + kTile;             // stage s at s * kTile
  unsigned char* Vs = Ks + kStages * kTile;   // stage s at s * kTile

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, kReleases);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], kReleases);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], kReleases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int first = a.sched[blockIdx.x], last = a.sched[blockIdx.x + 1];
  const int* items = a.sched + a.ctas + 1;

  if (threadIdx.x < 128) {
    // ---- producer: every item's Q once its consumers have released the
    // last one's, then its K/V tiles, last key tile first, through the ring
    // (K of tile j + 1 before V of tile j).  128 x 24 + 256 x 240 registers
    // is the 384 x 168 the block launched with.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    const int grp = a.hq / a.hkv;
    int n = 0, qn = 0;
    auto load_k = [&](const Item& it, int kvh, int j, int t) {
      const int s = t % kStages;
      unsigned char* kd = Ks + s * kTile;
      const int k0 = (it.kt0 + it.nt - 1 - j) * kKeys;
      mbar_wait(&k_empty[s], ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(&k_full[s], kTile);
      tma_load_4d(kd, &a.tk, 0, kvh, k0, it.b, &k_full[s]);
      tma_load_4d(kd + kChunk, &a.tk, 64, kvh, k0, it.b, &k_full[s]);
    };
    auto load_v = [&](const Item& it, int kvh, int j, int t) {
      const int s = t % kStages;
      unsigned char* vd = Vs + s * kTile;
      const int k0 = (it.kt0 + it.nt - 1 - j) * kKeys;
      mbar_wait(&v_empty[s], ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(&v_full[s], kTile);
      tma_load_4d(vd, &a.tv, 0, kvh, k0, it.b, &v_full[s]);
      tma_load_4d(vd + kChunk, &a.tv, 64, kvh, k0, it.b, &v_full[s]);
    };
    for (int i = first; i < last; ++i) {
      const Item it = item_of(a, items[i]);
      if (it.nt == 0) continue;
      mbar_wait(&q_empty, (qn & 1) ^ 1);
      ++qn;
      mbar_expect_tx(&q_full, kTile);
      tma_load_4d(Qs, &a.tq, 0, it.h, it.p0, it.b, &q_full);
      tma_load_4d(Qs + kChunk, &a.tq, 64, it.h, it.p0, it.b, &q_full);
      const int kvh = it.h / grp;
      load_k(it, kvh, 0, n);
      for (int j = 0; j < it.nt; ++j, ++n) {
        if (j + 1 < it.nt) load_k(it, kvh, j + 1, n + 1);
        load_v(it, kvh, j, n);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of each tile.
  // Register 4j + 2h + e of a 64 x 128 fp32 tile is row 16 warp + g + 8h,
  // column 8j + 2 t4 + e.  The first key tile of an item is peeled off the
  // loop and the last PV product follows it, so that no product is issued
  // under a branch (ptxas then serializes every wgmma of the kernel).  The
  // two consumers issue their products in turns (turn_wait / turn_pass).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane / 4, t4 = lane % 4;
  int n = 0, qn = 0;
  if (cw == 1) turn_pass(1);  // the first consumer goes first

  for (int i = first; i < last; ++i) {
    const Item it = item_of(a, items[i]);
    const int row0 = it.p0 + 64 * cw + 16 * warp + g;  // and row0 + 8
    float o[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 64; ++x) o[x] = 0.0f;

    if (it.nt > 0) {
      mbar_wait(&q_full, qn & 1);
      ++qn;
      const unsigned char* Qw = Qs + 64 * cw * 128;
      float s[64], alpha[2];
      unsigned p[32];  // P as bf16 pairs: p[2j + h] = columns 8j + 2t4, +1
      // the walk's first key tile (the item's last): S alone
      {
        const int st = n % kStages;
        mbar_wait(&k_full[st], (n / kStages) & 1);
        turn_wait(1 + cw);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          wgmma_ss_n128(s, desc_k(Qw, kk), desc_k(Ks + st * kTile, kk), kk);
        wgmma_commit();
        turn_pass(2 - cw);
        wgmma_wait<0>();
        fence_regs<64>(s);
        if (lane == 0) {
          mbar_arrive(&k_empty[st]);
          if (it.nt == 1) mbar_arrive(&q_empty);
        }
        softmax_tile<CAP>(s, m, l, alpha, a, it,
                          (it.kt0 + it.nt - 1) * kKeys, row0, t4);
#pragma unroll
        for (int x = 0; x < 32; ++x)
          p[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
        ++n;
      }
      // S of this tile with O += P V of the last one; the softmax runs
      // while the PV product is on the tensor cores
      for (int j = 1; j < it.nt; ++j, ++n) {
        const int st = n % kStages, sp = (n - 1) % kStages;
        mbar_wait(&k_full[st], (n / kStages) & 1);
        fence_regs<64>(s);
        fence_regs<64>(o);
        turn_wait(1 + cw);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          wgmma_ss_n128(s, desc_k(Qw, kk), desc_k(Ks + st * kTile, kk), kk);
        wgmma_commit();
        mbar_wait(&v_full[sp], ((n - 1) / kStages) & 1);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wgmma_rs_n128(o, p + 4 * kk, desc_mn(Vs + sp * kTile, kk));
        wgmma_commit();
        turn_pass(2 - cw);
        wgmma_wait<1>();  // S
        fence_regs<64>(s);
        if (lane == 0) {
          mbar_arrive(&k_empty[st]);
          if (j == it.nt - 1) mbar_arrive(&q_empty);
        }
        softmax_tile<CAP>(s, m, l, alpha, a, it,
                          (it.kt0 + it.nt - 1 - j) * kKeys, row0, t4);
        wgmma_wait<0>();  // O += P V
        fence_regs<64>(o);
        if (lane == 0) mbar_arrive(&v_empty[sp]);
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          p[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
          o[2 * x] *= alpha[x & 1];
          o[2 * x + 1] *= alpha[x & 1];
        }
      }
      // O += P V of the walk's last key tile
      const int sp = (n - 1) % kStages;
      mbar_wait(&v_full[sp], ((n - 1) / kStages) & 1);
      fence_regs<64>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_n128(o, p + 4 * kk, desc_mn(Vs + sp * kTile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(o);
      if (lane == 0) mbar_arrive(&v_empty[sp]);
    }

    // O / l in bf16 (the real columns), and the log-sum-exp
    const size_t q_ld = (size_t)a.hq * a.d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int pos = row0 + 8 * h;
      if (pos >= a.sq) continue;
      const float inv = sum > 0.0f ? 1.0f / sum : 0.0f;
      if (a.lse != nullptr && t4 == 0)
        a.lse[((size_t)it.b * a.hq + it.h) * a.sq + pos] =
            sum > 0.0f ? (m[h] * a.c + log2f(sum)) * kLn2 : -INFINITY;
      bf16* out =
          a.O + ((size_t)it.b * a.sq + pos) * q_ld + (size_t)it.h * a.d;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = 8 * jj + 2 * t4;
        if (col < a.d)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(o[4 * jj + 2 * h] * inv,
                                    o[4 * jj + 2 * h + 1] * inv);
      }
    }
  }
}

// The kernel at head dim 256 (gemma2-2b).  The d <= 128 design with the
// tiles the budget allows (see the note at the top): S = Q K^T is wgmma
// m64n64k16 over 16 k steps, O += P V wgmma m64n256k16 with P from
// registers; the producer, the ring, the turns, the peeled first tile and
// the mask on crossing tiles as in fa_train_kernel.
template <bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    fa_train256_kernel(const __grid_constant__ Args a) {
  constexpr int K = kKeys256;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, q_empty, k_full[kStages],
      k_empty[kStages], v_full[kStages], v_empty[kStages];
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + 4 * kChunk;          // stage s at s * kKvTile
  unsigned char* Vs = Ks + kStages * kKvTile;   // stage s at s * kKvTile

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, kReleases);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], kReleases);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], kReleases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int first = a.sched[blockIdx.x], last = a.sched[blockIdx.x + 1];
  const int* items = a.sched + a.ctas + 1;

  if (threadIdx.x < 128) {
    // ---- producer, as in fa_train_kernel: Q in four 128-row boxes, K and
    // V in four 64-key boxes each
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    const int grp = a.hq / a.hkv;
    int n = 0, qn = 0;
    auto load_kv = [&](const CUtensorMap* map, unsigned char* ring,
                       uint64_t* full, uint64_t* empty, const Item& it,
                       int kvh, int j, int t) {
      const int s = t % kStages;
      const int k0 = (it.kt0 + it.nt - 1 - j) * K;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], kKvTile);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tma_load_4d(ring + s * kKvTile + c * kKvChunk, map, 64 * c, kvh, k0,
                    it.b, &full[s]);
    };
    for (int i = first; i < last; ++i) {
      const Item it = item_of<K>(a, items[i]);
      if (it.nt == 0) continue;
      mbar_wait(&q_empty, (qn & 1) ^ 1);
      ++qn;
      mbar_expect_tx(&q_full, 4 * kChunk);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tma_load_4d(Qs + c * kChunk, &a.tq, 64 * c, it.h, it.p0, it.b,
                    &q_full);
      const int kvh = it.h / grp;
      load_kv(&a.tk, Ks, k_full, k_empty, it, kvh, 0, n);
      for (int j = 0; j < it.nt; ++j, ++n) {
        if (j + 1 < it.nt)
          load_kv(&a.tk, Ks, k_full, k_empty, it, kvh, j + 1, n + 1);
        load_kv(&a.tv, Vs, v_full, v_empty, it, kvh, j, n);
      }
    }
    return;
  }

  // ---- consumers: register 4j + 2h + e of S (j < 8) or O (j < 32) is row
  // 16 warp + g + 8h, column 8j + 2 t4 + e
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane / 4, t4 = lane % 4;
  int n = 0, qn = 0;
  if (cw == 1) turn_pass(1);  // the first consumer goes first

  for (int i = first; i < last; ++i) {
    const Item it = item_of<K>(a, items[i]);
    const int row0 = it.p0 + 64 * cw + 16 * warp + g;  // and row0 + 8
    float o[128], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 128; ++x) o[x] = 0.0f;

    if (it.nt > 0) {
      mbar_wait(&q_full, qn & 1);
      ++qn;
      const unsigned char* Qw = Qs + 64 * cw * 128;
      float s[32], alpha[2];
      unsigned p[16];  // P as bf16 pairs: p[2j + h] = columns 8j + 2t4, +1
      // the walk's first key tile (the item's last): S alone
      {
        const int st = n % kStages;
        mbar_wait(&k_full[st], (n / kStages) & 1);
        turn_wait(1 + cw);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk)
          wgmma_ss_n64(s, desc_k(Qw, kk), desc_k64(Ks + st * kKvTile, kk),
                       kk);
        wgmma_commit();
        turn_pass(2 - cw);
        wgmma_wait<0>();
        fence_regs<32>(s);
        if (lane == 0) {
          mbar_arrive(&k_empty[st]);
          if (it.nt == 1) mbar_arrive(&q_empty);
        }
        softmax_tile<CAP, K, true>(s, m, l, alpha, a, it,
                                   (it.kt0 + it.nt - 1) * K, row0, t4);
#pragma unroll
        for (int x = 0; x < 16; ++x)
          p[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
        ++n;
      }
      // S of this tile with O += P V of the last one; the softmax runs
      // while the PV product is on the tensor cores
      for (int j = 1; j < it.nt; ++j, ++n) {
        const int st = n % kStages, sp = (n - 1) % kStages;
        mbar_wait(&k_full[st], (n / kStages) & 1);
        fence_regs<32>(s);
        fence_regs<128>(o);
        turn_wait(1 + cw);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk)
          wgmma_ss_n64(s, desc_k(Qw, kk), desc_k64(Ks + st * kKvTile, kk),
                       kk);
        wgmma_commit();
        mbar_wait(&v_full[sp], ((n - 1) / kStages) & 1);
#pragma unroll
        for (int kk = 0; kk < K / 16; ++kk)
          wgmma_rs_n256(o, p + 4 * kk, desc_mn64(Vs + sp * kKvTile, kk));
        wgmma_commit();
        turn_pass(2 - cw);
        wgmma_wait<1>();  // S
        fence_regs<32>(s);
        if (lane == 0) {
          mbar_arrive(&k_empty[st]);
          if (j == it.nt - 1) mbar_arrive(&q_empty);
        }
        softmax_tile<CAP, K, true>(s, m, l, alpha, a, it,
                                   (it.kt0 + it.nt - 1 - j) * K, row0, t4);
        wgmma_wait<0>();  // O += P V
        fence_regs<128>(o);
        if (lane == 0) mbar_arrive(&v_empty[sp]);
#pragma unroll
        for (int x = 0; x < 16; ++x) p[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
#pragma unroll
        for (int x = 0; x < 64; ++x) {
          o[2 * x] *= alpha[x & 1];
          o[2 * x + 1] *= alpha[x & 1];
        }
      }
      // O += P V of the walk's last key tile
      const int sp = (n - 1) % kStages;
      mbar_wait(&v_full[sp], ((n - 1) / kStages) & 1);
      fence_regs<128>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk)
        wgmma_rs_n256(o, p + 4 * kk, desc_mn64(Vs + sp * kKvTile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<128>(o);
      if (lane == 0) mbar_arrive(&v_empty[sp]);
    }

    // O / l in bf16, and the log-sum-exp
    const size_t q_ld = (size_t)a.hq * 256;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int pos = row0 + 8 * h;
      if (pos >= a.sq) continue;
      const float inv = sum > 0.0f ? 1.0f / sum : 0.0f;
      if (a.lse != nullptr && t4 == 0)
        a.lse[((size_t)it.b * a.hq + it.h) * a.sq + pos] =
            sum > 0.0f ? (m[h] * a.c + log2f(sum)) * kLn2 : -INFINITY;
      bf16* out =
          a.O + ((size_t)it.b * a.sq + pos) * q_ld + (size_t)it.h * 256;
#pragma unroll
      for (int jj = 0; jj < 32; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + 2 * t4) =
            __floats2bfloat162_rn(o[4 * jj + 2 * h] * inv,
                                  o[4 * jj + 2 * h + 1] * inv);
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

// The kernel at q/k head dim 192 and V head dim 128 (deepseek-v3's MLA):
// fa_train_kernel's design, its loops and barriers, with Q and K tiles of
// three 64-column chunks (S over 12 k steps), V tiles of two and O of 128
// columns; no softcap.
__global__ void __launch_bounds__(kThreads, 1)
    fa_train_dv_kernel(const __grid_constant__ Args a) {
  constexpr int KSTEPS = 4 * kQkChunks;
  constexpr int kQkTile = kQkChunks * kChunk, kVTile = kVChunks * kChunk;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, q_empty, k_full[kStages],
      k_empty[kStages], v_full[kStages], v_empty[kStages];
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + kQkTile;            // stage s at s * kQkTile
  unsigned char* Vs = Ks + kStages * kQkTile;  // stage s at s * kVTile

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, kReleases);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], kReleases);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], kReleases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int first = a.sched[blockIdx.x], last = a.sched[blockIdx.x + 1];
  const int* items = a.sched + a.ctas + 1;

  if (threadIdx.x < 128) {
    // ---- producer, as fa_train_kernel's: Q of each item, then its K/V
    // tiles last key tile first (K of tile j + 1 before V of tile j)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    const int grp = a.hq / a.hkv;
    int n = 0, qn = 0;
    auto load_k = [&](const Item& it, int kvh, int j, int t) {
      const int s = t % kStages;
      unsigned char* kd = Ks + s * kQkTile;
      const int k0 = (it.kt0 + it.nt - 1 - j) * kKeys;
      mbar_wait(&k_empty[s], ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(&k_full[s], kQkTile);
      for (int c = 0; c < kQkChunks; ++c)
        tma_load_4d(kd + c * kChunk, &a.tk, 64 * c, kvh, k0, it.b,
                    &k_full[s]);
    };
    auto load_v = [&](const Item& it, int kvh, int j, int t) {
      const int s = t % kStages;
      unsigned char* vd = Vs + s * kVTile;
      const int k0 = (it.kt0 + it.nt - 1 - j) * kKeys;
      mbar_wait(&v_empty[s], ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(&v_full[s], kVTile);
      for (int c = 0; c < kVChunks; ++c)
        tma_load_4d(vd + c * kChunk, &a.tv, 64 * c, kvh, k0, it.b,
                    &v_full[s]);
    };
    for (int i = first; i < last; ++i) {
      const Item it = item_of(a, items[i]);
      if (it.nt == 0) continue;
      mbar_wait(&q_empty, (qn & 1) ^ 1);
      ++qn;
      mbar_expect_tx(&q_full, kQkTile);
      for (int c = 0; c < kQkChunks; ++c)
        tma_load_4d(Qs + c * kChunk, &a.tq, 64 * c, it.h, it.p0, it.b,
                    &q_full);
      const int kvh = it.h / grp;
      load_k(it, kvh, 0, n);
      for (int j = 0; j < it.nt; ++j, ++n) {
        if (j + 1 < it.nt) load_k(it, kvh, j + 1, n + 1);
        load_v(it, kvh, j, n);
      }
    }
    return;
  }

  // ---- consumers, as fa_train_kernel's (the peeled first key tile, the
  // turns, S of tile j issued with O += P V of tile j - 1)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane / 4, t4 = lane % 4;
  int n = 0, qn = 0;
  if (cw == 1) turn_pass(1);  // the first consumer goes first

  for (int i = first; i < last; ++i) {
    const Item it = item_of(a, items[i]);
    const int row0 = it.p0 + 64 * cw + 16 * warp + g;  // and row0 + 8
    float o[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 64; ++x) o[x] = 0.0f;

    if (it.nt > 0) {
      mbar_wait(&q_full, qn & 1);
      ++qn;
      const unsigned char* Qw = Qs + 64 * cw * 128;
      float s[64], alpha[2];
      unsigned p[32];  // P as bf16 pairs: p[2j + h] = columns 8j + 2t4, +1
      {
        const int st = n % kStages;
        mbar_wait(&k_full[st], (n / kStages) & 1);
        turn_wait(1 + cw);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          wgmma_ss_n128(s, desc_k(Qw, kk), desc_k(Ks + st * kQkTile, kk),
                        kk);
        wgmma_commit();
        turn_pass(2 - cw);
        wgmma_wait<0>();
        fence_regs<64>(s);
        if (lane == 0) {
          mbar_arrive(&k_empty[st]);
          if (it.nt == 1) mbar_arrive(&q_empty);
        }
        softmax_tile<false>(s, m, l, alpha, a, it,
                            (it.kt0 + it.nt - 1) * kKeys, row0, t4);
#pragma unroll
        for (int x = 0; x < 32; ++x)
          p[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
        ++n;
      }
      for (int j = 1; j < it.nt; ++j, ++n) {
        const int st = n % kStages, sp = (n - 1) % kStages;
        mbar_wait(&k_full[st], (n / kStages) & 1);
        fence_regs<64>(s);
        fence_regs<64>(o);
        turn_wait(1 + cw);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          wgmma_ss_n128(s, desc_k(Qw, kk), desc_k(Ks + st * kQkTile, kk),
                        kk);
        wgmma_commit();
        mbar_wait(&v_full[sp], ((n - 1) / kStages) & 1);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wgmma_rs_n128(o, p + 4 * kk, desc_mn(Vs + sp * kVTile, kk));
        wgmma_commit();
        turn_pass(2 - cw);
        wgmma_wait<1>();  // S
        fence_regs<64>(s);
        if (lane == 0) {
          mbar_arrive(&k_empty[st]);
          if (j == it.nt - 1) mbar_arrive(&q_empty);
        }
        softmax_tile<false>(s, m, l, alpha, a, it,
                            (it.kt0 + it.nt - 1 - j) * kKeys, row0, t4);
        wgmma_wait<0>();  // O += P V
        fence_regs<64>(o);
        if (lane == 0) mbar_arrive(&v_empty[sp]);
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          p[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
          o[2 * x] *= alpha[x & 1];
          o[2 * x + 1] *= alpha[x & 1];
        }
      }
      const int sp = (n - 1) % kStages;
      mbar_wait(&v_full[sp], ((n - 1) / kStages) & 1);
      fence_regs<64>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_n128(o, p + 4 * kk, desc_mn(Vs + sp * kVTile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(o);
      if (lane == 0) mbar_arrive(&v_empty[sp]);
    }

    // O / l in bf16 (128 columns a row of O), and the log-sum-exp
    const size_t o_ld = (size_t)a.hq * kDv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int pos = row0 + 8 * h;
      if (pos >= a.sq) continue;
      const float inv = sum > 0.0f ? 1.0f / sum : 0.0f;
      if (a.lse != nullptr && t4 == 0)
        a.lse[((size_t)it.b * a.hq + it.h) * a.sq + pos] =
            sum > 0.0f ? (m[h] * a.c + log2f(sum)) * kLn2 : -INFINITY;
      bf16* out = a.O + ((size_t)it.b * a.sq + pos) * o_ld + (size_t)it.h * kDv;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = 8 * jj + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(o[4 * jj + 2 * h] * inv,
                                  o[4 * jj + 2 * h + 1] * inv);
      }
    }
  }
}

// map of a contiguous bf16 [batch, seq, heads, d] in boxes of 64 columns of
// one head at `rows` consecutive positions, 128-byte swizzled as wgmma
// reads them; out-of-range positions and columns read as zeros
bool tensor_map(CUtensorMap* map, const void* base, int batch, int seq,
                int heads, int d, int rows = kRows) {
  auto fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                           (cuuint64_t)seq * heads * d * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KSTEPS, bool CAP>
cudaError_t launch(const Args& a, cudaStream_t st) {
  auto kernel = fa_train_kernel<KSTEPS, CAP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  kernel<<<a.ctas, kThreads, kSmemBytes, st>>>(a);
  return cudaGetLastError();
}

template <bool CAP>
cudaError_t launch256(const Args& a, cudaStream_t st) {
  auto kernel = fa_train256_kernel<CAP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem256);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  kernel<<<a.ctas, kThreads, kSmem256, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_dv(const Args& a, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_train_dv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemDv);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  fa_train_dv_kernel<<<a.ctas, kThreads, kSmemDv, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q/o [b, sq, hq, d], k/v [b, skv, hkv, d], contiguous bf16 with
// 16-byte-aligned bases; lse null or fp32 [b, hq, sq]; q_offset/kv_len [b]
// int32 on the device.  d is 112, 128 or 256; hq % hkv == 0.  sched: int32 on
// the device, ops.attention_train_schedule's [ctas + 1] offsets and then
// its items ((batch row * hq + q head) * row tiles + row tile, row tiles
// of 128), each block's items in the order it takes them.  One launch of
// `ctas` blocks.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_train_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_offset, const void* kv_len, const void* sched, int b,
    int sq, int skv, int hq, int hkv, int d, int causal, int window,
    float softcap, int ctas, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      ctas <= 0)
    return cudaErrorInvalidValue;
  if (d != 112 && d != 128 && d != 256) return cudaErrorInvalidValue;
  Args a{};
  const int keys = d == 256 ? kKeys256 : kKeys;  // the boxes of K and V
  if (!tensor_map(&a.tq, q, b, sq, hq, d) ||
      !tensor_map(&a.tk, k, b, skv, hkv, d, keys) ||
      !tensor_map(&a.tv, v, b, skv, hkv, d, keys))
    return cudaErrorInvalidValue;
  a.O = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.q_offset = static_cast<const int*>(q_offset);
  a.kv_len = static_cast<const int*>(kv_len);
  a.sched = static_cast<const int*>(sched);
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.hkv = hkv;
  a.d = d;
  a.causal = causal;
  a.window = window;
  a.row_tiles = (sq + kRows - 1) / kRows;
  a.ctas = ctas;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const float log2e = 1.4426950408889634f;
  a.softcap = softcap;
  a.cap_in = softcap > 0.0f ? scale / softcap : 0.0f;
  a.c = softcap > 0.0f ? log2e : scale * log2e;
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 256)
    return softcap > 0.0f ? launch256<true>(a, st) : launch256<false>(a, st);
  if (softcap > 0.0f)
    return d == 112 ? launch<7, true>(a, st) : launch<8, true>(a, st);
  return d == 112 ? launch<7, false>(a, st) : launch<8, false>(a, st);
}

// q [b, sq, hq, d] and k [b, skv, hkv, d] with d = 192, v [b, skv, hkv,
// dv] and o [b, sq, hq, dv] with dv = 128 (deepseek-v3's MLA), contiguous
// bf16 with 16-byte-aligned bases; no softcap; everything else as
// repro_flash_attention_train_bf16's (the scale 1 / sqrt(d), of q's dim).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_train_dv_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_offset, const void* kv_len, const void* sched, int b,
    int sq, int skv, int hq, int hkv, int d, int dv, int causal, int window,
    int ctas, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      ctas <= 0 || d != 64 * kQkChunks || dv != kDv)
    return cudaErrorInvalidValue;
  Args a{};
  if (!tensor_map(&a.tq, q, b, sq, hq, d) ||
      !tensor_map(&a.tk, k, b, skv, hkv, d) ||
      !tensor_map(&a.tv, v, b, skv, hkv, dv))
    return cudaErrorInvalidValue;
  a.O = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.q_offset = static_cast<const int*>(q_offset);
  a.kv_len = static_cast<const int*>(kv_len);
  a.sched = static_cast<const int*>(sched);
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.hkv = hkv;
  a.d = d;
  a.causal = causal;
  a.window = window;
  a.row_tiles = (sq + kRows - 1) / kRows;
  a.ctas = ctas;
  a.softcap = 0.0f;
  a.cap_in = 0.0f;
  a.c = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  return launch_dv(a, static_cast<cudaStream_t>(stream));
}
