// Building blocks of the Hopper (sm_90a) flash-attention kernels, shared by
// flash_fwd.cu (K1, K2) and flash_bwd.cu (K4a, K4b, K4c): TMA copies of
// 64-row tiles into 128-byte swizzled shared memory on mbarriers, wgmma
// products of one warpgroup (4 warps, 128 threads) with fp32 accumulators
// in registers, the MUFU exponential, the conversion of an accumulator into a bf16 register operand,
// the grid order of the causal kernels, the bf16 store of an accumulator's
// rows, and the host-side TMA map of a (batch, rows, heads, D) tensor.
// Each source includes this header once; everything here has internal
// linkage.

#pragma once

#include <cuda.h>  // CUtensorMap; its encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NWARPS = 4;     // each warp owns 16 rows of the block's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float MASKED = -1e30f;  // the TPU kernel's NEG_INF for masked keys

struct Strides {  // in elements: batch, sequence, head
  long long b, s, h;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory that completes a phase when one arrival and
// the bytes of the TMA copies it was told to expect have come in.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// Tiles in shared memory: 64 rows of D bf16 values, as D/64 column blocks
// of 64 rows x 128 bytes, each block 1024-byte aligned, the 16-byte chunk j
// of row r stored at chunk j ^ (r % 8) of its row: the 128-byte swizzle in
// which TMA writes a box and wgmma reads an operand. One layout serves a
// tile both as a K-major operand (the head dim summed: S = Q K^T) and as an
// MN-major one (rows summed: O = P V, dV = P^T dO).
template <int D>
struct Tile {
  static constexpr int bytes = 64 * D * 2;
  static constexpr int block = 64 * 128;  // one column block
};

// Rows [row0, row0 + 64) of head `head` of batch `b` into the tile at
// shared address `dst` by TMA (one 64 x 64 box per column block; rows past
// the sequence arrive as zeros), completing on `bar`. One thread issues it.
template <int D>
__device__ __forceinline__ void tma_tile(unsigned dst, const CUtensorMap& map, int row0,
                                         int head, int b, unsigned bar) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst + cb * Tile<D>::block),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(cb * 64), "r"(head), "r"(row0), "r"(b),
        "r"(bar)
        : "memory");
}

// 2^x on the special-function unit (MUFU.EX2)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptors (128-byte swizzle; the tile 1024-byte
// aligned). K-major, for the k-th 16 columns of the head dim: rows 128
// bytes apart, groups of 8 rows 1024 apart. MN-major, for rows 16k..16k+15
// of the tile taken as the summed (K) dimension and the head dim as N:
// groups of 8 rows 1024 apart (SBO), column blocks Tile::block apart (LBO).
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

template <int D>
__device__ __forceinline__ uint64_t desc_k(unsigned tile, int k) {
  return smem_desc(tile + (k / 4) * Tile<D>::block + (k % 4) * 32, 16, 1024);
}

template <int D>
__device__ __forceinline__ uint64_t desc_mn(unsigned tile, int k) {
  return smem_desc(tile + k * 16 * 128, Tile<D>::block, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma.wait_group that makes it valid.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (64 x N fp32 over the warpgroup) += a . b for one k-step of 16: the
// warp w of the group holds rows 16w + lane/4 and 16w + lane/4 + 8, the
// m16n8 accumulator layout of mma.sync for each 8 columns. _ss: a and b
// K-major from shared memory; _rs: a (16 rows a warp, bf16, the m16k16 A
// layout) from registers, b MN-major from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[8][4], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128_t(float (&d)[16][4], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[D / 8][4], const unsigned (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (&d)[8][4], const unsigned (&a)[4], uint64_t b) {
  wgmma_rs_n64_t(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float (&d)[16][4], const unsigned (&a)[4], uint64_t b) {
  wgmma_rs_n128_t(d, a, b);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
}

// c (64 x 64) += a . b^T over the head dim, a and b 64-row tiles of
// width D; only the first KSTEPS k-steps of 16 columns are summed (a head
// dim of 80 or 96 in a 128-column tile, whose other columns are zeros).
template <int D, int KSTEPS = D / 16>
__device__ __forceinline__ void scores(float (&c)[8][4], unsigned a, unsigned b) {
#pragma unroll
  for (int k = 0; k < KSTEPS; ++k) wgmma_ss_n64(c, desc_k<D>(a, k), desc_k<D>(b, k));
}

// acc (64 x D) += a . b, a (64 x 64 bf16) in registers, b a 64-row tile.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const unsigned (&a)[4][4],
                                           unsigned b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_rs_t<D>(acc, a[k], desc_mn<D>(b, k));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The 64 x 64 fp32 accumulator as four bf16 A operands of 16 columns:
// tiles 2t and 2t+1 hold exactly the values A chunk t needs in each lane.
__device__ __forceinline__ void to_operand(unsigned (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t][0] = pack_bf16(c[2 * t][0], c[2 * t][1]);
    a[t][1] = pack_bf16(c[2 * t][2], c[2 * t][3]);
    a[t][2] = pack_bf16(c[2 * t + 1][0], c[2 * t + 1][1]);
    a[t][3] = pack_bf16(c[2 * t + 1][2], c[2 * t + 1][3]);
  }
}

// The (tile, head, batch) a block of a (tiles, heads, batch) grid owns.
// Blocks are dispatched in index order. Without the causal mask every tile
// of a head costs the same and the tile runs fastest, so the blocks of a
// head, which read the same rows, run together. Under it the order is
// tile-major, the costliest tile of every head first (K4c: key tile 0,
// which meets every q tile; K2 and K4b: the last q tile, which meets every
// key tile), so the short tiles fill in behind the long ones; within a
// tile the heads run in order, so the q heads of a GQA group, which read
// the same K/V, run next to each other.
struct Block {
  int tile, head, b;
};

template <bool CAUSAL, bool LAST_FIRST>
__device__ __forceinline__ Block block_of_grid() {
  if (!CAUSAL) return Block{(int)blockIdx.x, (int)blockIdx.y, (int)blockIdx.z};
  const int n = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int rest = n % (gridDim.y * gridDim.z);
  const int rank = n / (gridDim.y * gridDim.z);
  return Block{LAST_FIRST ? (int)gridDim.x - 1 - rank : rank,
               rest % (int)gridDim.y, rest / (int)gridDim.y};
}

// Rows r0 and r0 + 8 of the first D columns of the warpgroup's 64 x 8NT
// accumulator, times `mul0` and `mul1` respectively, to bf16 rows of `out`
// (row stride `stride`); rows at or past `limit` are skipped.
template <int D, int NT>
__device__ __forceinline__ void store_rows(bf16* out, long long stride,
                                           const float (&acc)[NT][4],
                                           int r0, int limit, int lane,
                                           float mul0, float mul1) {
  static_assert(D % 8 == 0 && D / 8 <= NT, "D columns of the accumulator");
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r >= limit) continue;
    const float mul = half ? mul1 : mul0;
    bf16* row = out + (long long)r * stride + (lane % 4) * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8) = __floats2bfloat162_rn(
          acc[nt][2 * half] * mul, acc[nt][2 * half + 1] * mul);
  }
}

// The 1024-byte aligned start of the dynamic shared memory (the launch
// asks for 1024 bytes more than the layout).
__device__ __forceinline__ unsigned aligned_smem(const unsigned char* smem) {
  return (smem_addr(smem) + 1023u) & ~1023u;
}

// --------------------------------------------------------------- host ----

template <typename Kernel>
int prepare(Kernel kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the i-th tensor's (batch, sequence, head) strides of a launcher's array
Strides strides(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A TMA map of a bf16 (batch, rows, heads, D) tensor with the given
// strides (in elements: batch, row, head; the head dim contiguous), read in
// boxes of 64 rows x 64 values of one head, 128-byte swizzled (the Tile
// layout); rows past `rows`, and columns past `d` (a head dim of 80 or 96
// in a tile of two column blocks), read as zeros, and a box's bytes count
// in full on its mbarrier.
int tensor_map(CUtensorMap* map, const void* data, int b, int rows, int heads, int d,
               const Strides& st) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    int err = (int)cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                    cudaEnableDefault, &found);
#else
    int err = (int)cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                           &found);
#endif
    if (err) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)b};
  const cuuint64_t bytes[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                               (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(data),
                            dims, bytes, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
