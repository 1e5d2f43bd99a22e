// Flash-attention forward for Hopper (sm_90a): kernels K1 and K2.
//
// Replaces the TPU kernels in u2tokenizer_tpu/ops/flash_attention.py:
//   K1  flash_fwd_noncausal  <- _kernel                  (ViT self-attention)
//   K2  flash_fwd_causal     <- _kernel_causal_chunked   (decoder prefill)
//
// What it computes: per (batch b, head h) softmax(q k^T * scale) v over the
// keys j < lens[b] (and j <= i for query i when causal); query head h reads
// kv head h / group (GQA). Tensors keep the framework's (B, S, H, D) layout
// with arbitrary batch/sequence/head strides and a contiguous head dim, so
// the ViT's fused qkv projection is read in place, without a transpose.
//
// Bound on the H100: FLOPs. K1 at the ViT shape does 4*2049^2*64 FLOP per
// (chunk, head) against 2*2049*64*2 bytes read; K2 at the prefill shape is
// likewise far above the card's ~295 FLOP/byte ridge. The TPU kernel kept a
// head's whole K/V resident in VMEM; one ViT head's K alone (262 KB) is over
// the 227 KB of shared memory a block may use, so this design walks K/V in
// 64-key tiles with an fp32 online softmax instead. One block of 4 warps per
// (q tile of 64 rows, head, batch); Q, the K/V tile, the score tile, the
// bf16 probabilities and the fp32 output accumulator live in shared memory.
// Both products run on the tensor cores through WMMA (bf16 in, fp32
// accumulate). Tiles past lens[b] are skipped (they contribute exp(-inf) = 0),
// and K2 stops at the q tile's causal frontier, so the work is what the data
// needs. The ragged key tail (2049 = 32*64 + 1) is masked in the kernel: rows
// past the sequence are zero-filled and scored -inf; nothing is padded on the
// host. Query rows past the sequence are computed and not stored.
//
// Not yet done (later work): wgmma and TMA, register-resident accumulators,
// warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NWARPS = 4;     // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float MASKED = -1e30f;  // the TPU kernel's NEG_INF for masked keys

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;   // bf16 Q/K/V tile row stride
  static constexpr int LDS = BK + 4;  // fp32 score row stride
  static constexpr int LDP = BK + 8;  // bf16 probability row stride
  static constexpr int LDO = D + 4;   // fp32 accumulator row stride
  static constexpr size_t q = 0;
  static constexpr size_t k = q + size_t(BQ) * LDH * 2;
  static constexpr size_t v = k + size_t(BK) * LDH * 2;
  static constexpr size_t s = v + size_t(BK) * LDH * 2;
  static constexpr size_t p = s + size_t(BQ) * LDS * 4;
  static constexpr size_t o = p + size_t(BQ) * LDP * 2;
  static constexpr size_t bytes = o + size_t(BQ) * LDO * 4;
};

// Copy rows [row0, row0 + nrows) of a (rows, D) bf16 matrix with the given
// row stride into a shared tile; rows at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int limit, int nrows) {
  constexpr int VEC = 8;  // bf16 values per 16-byte load
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < nrows * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDH + c) = val;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ lens,
                 bf16* __restrict__ out, int sq, int sk, int group, float scale,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lens[b], sk);

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  // keys that can be visible to this q tile
  int kv_end = len;
  if (CAUSAL) kv_end = min(kv_end, q0 + BQ);
  const int n_tiles = max((kv_end + BK - 1) / BK, 1);

  load_tile<D>(sQ, qb, q_ss, q0, sq, BQ);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;

  // softmax state: lanes 2r and 2r+1 share row `row` of this warp's 16 rows
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int q_idx = q0 + row;
  float m_run = -INFINITY, l_run = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // all warps are done with the previous K/V tile
    load_tile<D>(sK, kb, k_ss, k0, sk, BK);
    load_tile<D>(sV, vb, v_ss, k0, sk, BK);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int nf = 0; nf < BK / 16; ++nf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kf = 0; kf < D / 16; ++kf) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * L::LDH + kf * 16, L::LDH);
        wmma::load_matrix_sync(fb, sK + nf * 16 * L::LDH + kf * 16, L::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * L::LDS + nf * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile's 64 keys, 32 per lane
    float sv[BK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = half * (BK / 2) + j;
      const int key = k0 + c;
      float x = sS[row * L::LDS + c] * scale;
      if (key >= sk) x = -INFINITY;  // past the sequence: not a key at all
      else if (key >= len || (CAUSAL && key > q_idx)) x = MASKED;
      sv[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = __expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float pj = __expf(sv[j] - m_new);
      psum += pj;
      sP[row * L::LDP + half * (BK / 2) + j] = __float2bfloat16(pj);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll 8
    for (int j = 0; j < D / 2; ++j) sO[row * L::LDO + half * (D / 2) + j] *= alpha;
    __syncwarp();

    // O += P V for this warp's 16 rows
#pragma unroll
    for (int nf = 0; nf < D / 16; ++nf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_tile = sO + warp * 16 * L::LDO + nf * 16;
      wmma::load_matrix_sync(acc, o_tile, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kf = 0; kf < BK / 16; ++kf) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + warp * 16 * L::LDP + kf * 16, L::LDP);
        wmma::load_matrix_sync(fb, sV + kf * 16 * L::LDH + nf * 16, L::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (q_idx < sq) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    bf16* orow = out + b * o_sb + (long long)q_idx * o_ss + h * o_sh + half * (D / 2);
    const float* srow = sO + row * L::LDO + half * (D / 2);
#pragma unroll 8
    for (int j = 0; j < D / 2; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j) =
          __floats2bfloat162_rn(srow[j] * inv, srow[j + 1] * inv);
    }
  }
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, int b, int h, int hkv, int sq, int sk, float scale,
           const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, CAUSAL>;
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lens, static_cast<bf16*>(out), sq, sk,
      h / hkv, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <bool CAUSAL>
int dispatch(const void* q, const void* k, const void* v, const void* lens,
             void* out, int b, int h, int hkv, int sq, int sk, int d,
             float scale, const void* strides, void* stream) {
  const int* l = static_cast<const int*>(lens);
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64, CAUSAL>(q, k, v, l, out, b, h, hkv, sq, sk, scale, st, s);
  if (d == 128) return launch<128, CAUSAL>(q, k, v, l, out, b, h, hkv, sq, sk, scale, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 int64 in elements, host memory: q (batch, seq, head),
// k (batch, seq, head), v (batch, seq, head), out (batch, seq, head).
extern "C" int flash_fwd_noncausal(const void* q, const void* k, const void* v,
                                   const void* lens, void* out, int b, int h,
                                   int hkv, int sq, int sk, int d, float scale,
                                   const void* strides, void* stream) {
  return dispatch<false>(q, k, v, lens, out, b, h, hkv, sq, sk, d, scale, strides, stream);
}

extern "C" int flash_fwd_causal(const void* q, const void* k, const void* v,
                                const void* lens, void* out, int b, int h,
                                int hkv, int sq, int sk, int d, float scale,
                                const void* strides, void* stream) {
  return dispatch<true>(q, k, v, lens, out, b, h, hkv, sq, sk, d, scale, strides, stream);
}
