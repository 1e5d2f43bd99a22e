// Flash-attention backward for Hopper (sm_90a): kernels K4a, K4b and K4c.
//
// Replaces the TPU kernels in u2tokenizer_tpu/ops/flash_attention.py that
// _flash_bwd_raw chains:
//   K4a  flash_bwd_lse  <- _lse_kernel  row logsumexp of the masked scores
//   K4b  flash_bwd_dq   <- _dq_kernel   dq = sum_k dS K * scale
//   K4c  flash_bwd_dkv  <- _dkv_kernel  dv = sum_q P^T dO, dk = sum_q dS^T Q * scale
// with P = exp(S * scale - lse), dS = P o (dO V^T - dd), dd = rowsum(dO o O)
// (dd is computed by the caller). Masks as in the forward (flash_fwd.cu):
// keys j >= lens[b], and j > i when causal, score -1e30; query head h reads
// kv head h / group (GQA). q, k, v and dO are read through their (batch,
// sequence, head) strides with a contiguous head dim, so the ViT's q/k/v
// stay views of the fused qkv projection; lse and dd are fp32 (B, H, Sq).
//
// Bound on the H100: operations. Per visible (query, key) pair and head,
// K4a does 2*D FLOP (QK^T), K4b 6*D (QK^T, dO V^T, dS K) and K4c 8*D (the
// same two score products again, P^T dO and dS^T Q), against O(S*D) bytes;
// at the training shapes (ViT 2049 tokens, D = 64; decoder 1024 tokens,
// D = 128) each is far above the card's ~295 FLOP/byte ridge. The design is
// the simple one: 64-row tiles, 4 warps per block, bf16 WMMA (mma.sync) with
// fp32 accumulation, scores and probabilities staged in shared memory.
//   * K4a: one block per (64-row q tile, head, batch) walks K in 64-key
//     tiles up to lens[b] and the causal frontier with an fp32 running
//     max and sum.
//   * K4b: one block per (q tile, head, batch) holds the Q and dO tiles in
//     shared memory; for each K/V tile it forms S and dP, then dS, and
//     accumulates dS K in registers (WMMA fragments); one scale at the end.
//   * K4c: one block per (64-key tile, kv head, batch) holds its K and V
//     tiles and walks the group's q heads, and for each the q tiles from the
//     causal frontier on, accumulating dV and dK in fp32 shared memory. The
//     GQA group is summed inside the block, as on the TPU, so no atomics are
//     needed and the result is deterministic. A block whose keys all lie at
//     or past lens[b] writes zeros without reading anything else.
// P and dS are rounded to bf16 before their products (the TPU kernel takes
// them in fp32). Tiles past lens[b] are skipped, the ragged edge (2049 =
// 32*64 + 1) is masked in the kernel, nothing is padded on the host, and
// rows past the sequence are never written.
//
// Not yet done (later work): wgmma and TMA, register-resident dK/dV,
// fusing K4a into K4b.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NWARPS = 4;     // each warp owns 16 rows of the block's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float MASKED = -1e30f;  // the TPU kernel's NEG_INF for masked keys

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;

struct Strides {  // in elements: batch, sequence, head
  long long b, s, h;
};

template <int D>
struct Dims {
  static constexpr int LDH = D + 8;   // bf16 tile row stride (Q, K, V, dO)
  static constexpr int LDS = 64 + 4;  // fp32 score row stride
  static constexpr int LDP = 64 + 8;  // bf16 probability row stride
  static constexpr int LDO = D + 4;   // fp32 accumulator row stride
  static constexpr size_t tile = size_t(64) * LDH * 2;
  static constexpr size_t score = size_t(64) * LDS * 4;
  static constexpr size_t prob = size_t(64) * LDP * 2;
  static constexpr size_t accum = size_t(64) * LDO * 4;
};

// Copy rows [row0, row0 + 64) of a (rows, D) bf16 matrix with the given row
// stride into a shared tile; rows at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int limit) {
  constexpr int VEC = 8;  // bf16 values per 16-byte load
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Dims<D>::LDH + c) = val;
  }
}

// c (16 x 64 fp32, row stride LDS) = a (16 x D) . b^T, b (64 x D); a and b
// are bf16 tiles in shared memory with row stride LDH.
template <int D>
__device__ __forceinline__ void mm_abt(float* c, const bf16* a, const bf16* b) {
  constexpr int LDH = Dims<D>::LDH;
#pragma unroll
  for (int nf = 0; nf < 4; ++nf) {
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kf = 0; kf < D / 16; ++kf) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + kf * 16, LDH);
      wmma::load_matrix_sync(fb, b + nf * 16 * LDH + kf * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + nf * 16, acc, Dims<D>::LDS, wmma::mem_row_major);
  }
}

// c (16 x D fp32 in shared memory, row stride LDO) += a (16 x 64 bf16, row
// stride LDP) . b (64 x D bf16, row stride LDH).
template <int D>
__device__ __forceinline__ void mm_ab_acc(float* c, const bf16* a, const bf16* b) {
#pragma unroll
  for (int nf = 0; nf < D / 16; ++nf) {
    Acc acc;
    wmma::load_matrix_sync(acc, c + nf * 16, Dims<D>::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kf = 0; kf < 4; ++kf) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, a + kf * 16, Dims<D>::LDP);
      wmma::load_matrix_sync(fb, b + kf * 16 * Dims<D>::LDH + nf * 16, Dims<D>::LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + nf * 16, acc, Dims<D>::LDO, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------- K4a ----

template <int D>
struct LseLayout {
  static constexpr size_t q = 0;
  static constexpr size_t k = q + Dims<D>::tile;
  static constexpr size_t s = k + Dims<D>::tile;
  static constexpr size_t bytes = s + Dims<D>::score;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const int* __restrict__ lens, float* __restrict__ lse, int sq,
           int sk, int group, float scale, Strides qs, Strides ks) {
  using L = LseLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  float* sS = reinterpret_cast<float*>(smem + L::s);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lens[b], sk);
  const bf16* kb = k + b * ks.b + (h / group) * ks.h;

  int kv_end = len;
  if (CAUSAL) kv_end = min(kv_end, q0 + BQ);
  const int n_tiles = max((kv_end + BK - 1) / BK, 1);

  load_tile<D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  // lanes 2r and 2r+1 share row `row` of this warp's 16 rows
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int q_idx = q0 + row;
  float m_run = -INFINITY, l_run = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<D>(sK, kb, ks.s, k0, sk);
    __syncthreads();
    mm_abt<D>(sS + warp * 16 * Dims<D>::LDS, sQ + warp * 16 * Dims<D>::LDH, sK);
    __syncwarp();
    float sv[BK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = half * (BK / 2) + j;
      const int key = k0 + c;
      float x = sS[row * Dims<D>::LDS + c] * scale;
      if (key >= sk) x = -INFINITY;  // past the sequence: not a key at all
      else if (key >= len || (CAUSAL && key > q_idx)) x = MASKED;
      sv[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) psum += expf(sv[j] - m_new);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * expf(m_run - m_new) + psum;
    m_run = m_new;
  }
  if (q_idx < sq && half == 0)
    lse[((long long)b * gridDim.y + h) * sq + q_idx] = m_run + logf(fmaxf(l_run, 1e-30f));
}

// ---------------------------------------------------------------- K4b ----

template <int D>
struct DqLayout {
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + Dims<D>::tile;
  static constexpr size_t k = dout + Dims<D>::tile;
  static constexpr size_t v = k + Dims<D>::tile;
  static constexpr size_t s = v + Dims<D>::tile;
  static constexpr size_t dp = s + Dims<D>::score;
  static constexpr size_t ds = dp + Dims<D>::score;
  static constexpr size_t bytes = ds + Dims<D>::prob;
  // the epilogue stages dQ (64 x LDO fp32) over the K and V tiles
  static_assert(Dims<D>::accum <= 2 * Dims<D>::tile, "dQ staging overflows K/V");
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dd,
          const int* __restrict__ lens, bf16* __restrict__ dq, int sq, int sk,
          int group, float scale, Strides qs, Strides ks, Strides vs,
          Strides os, Strides dqs) {
  using L = DqLayout<D>;
  constexpr int LDH = Dims<D>::LDH, LDS = Dims<D>::LDS, LDP = Dims<D>::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sO = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lens[b], sk);
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  int kv_end = len;
  if (CAUSAL) kv_end = min(kv_end, q0 + BQ);
  const int n_tiles = (kv_end + BK - 1) / BK;

  load_tile<D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  load_tile<D>(sO, dout + b * os.b + h * os.h, os.s, q0, sq);
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int q_idx = q0 + row;
  const bool row_ok = q_idx < sq;
  const long long stat = ((long long)b * gridDim.y + h) * sq + q_idx;
  const float lse_r = row_ok ? lse[stat] : 0.f;
  const float dd_r = row_ok ? dd[stat] : 0.f;

  Acc acc[D / 16];
#pragma unroll
  for (int nf = 0; nf < D / 16; ++nf) wmma::fill_fragment(acc[nf], 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<D>(sK, kb, ks.s, k0, sk);
    load_tile<D>(sV, vb, vs.s, k0, sk);
    __syncthreads();
    mm_abt<D>(sS + warp * 16 * LDS, sQ + warp * 16 * LDH, sK);   // S
    mm_abt<D>(sP + warp * 16 * LDS, sO + warp * 16 * LDH, sV);   // dP
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < BK / 2; ++j) {
      const int c = half * (BK / 2) + j;
      const int key = k0 + c;
      const bool visible = row_ok && key < len && (!CAUSAL || key <= q_idx);
      const float p = visible ? __expf(sS[row * LDS + c] * scale - lse_r) : 0.f;
      sDS[row * LDP + c] = __float2bfloat16(p * (sP[row * LDS + c] - dd_r));
    }
    __syncwarp();
#pragma unroll
    for (int nf = 0; nf < D / 16; ++nf) {
#pragma unroll
      for (int kf = 0; kf < BK / 16; ++kf) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, sDS + warp * 16 * LDP + kf * 16, LDP);
        wmma::load_matrix_sync(fb, sK + kf * 16 * LDH + nf * 16, LDH);
        wmma::mma_sync(acc[nf], fa, fb, acc[nf]);
      }
    }
  }

  __syncthreads();  // every warp is done with K and V: stage dQ over them
  float* stage = reinterpret_cast<float*>(smem + L::k);
  constexpr int LDO = Dims<D>::LDO;
#pragma unroll
  for (int nf = 0; nf < D / 16; ++nf)
    wmma::store_matrix_sync(stage + warp * 16 * LDO + nf * 16, acc[nf], LDO,
                            wmma::mem_row_major);
  __syncwarp();
  if (row_ok) {
    bf16* orow = dq + b * dqs.b + (long long)q_idx * dqs.s + h * dqs.h + half * (D / 2);
    const float* srow = stage + row * LDO + half * (D / 2);
#pragma unroll 8
    for (int j = 0; j < D / 2; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(orow + j) =
          __floats2bfloat162_rn(srow[j] * scale, srow[j + 1] * scale);
  }
}

// ---------------------------------------------------------------- K4c ----

template <int D>
struct DkvLayout {
  static constexpr size_t k = 0;
  static constexpr size_t v = k + Dims<D>::tile;
  static constexpr size_t q = v + Dims<D>::tile;
  static constexpr size_t dout = q + Dims<D>::tile;
  static constexpr size_t s = dout + Dims<D>::tile;
  static constexpr size_t dp = s + Dims<D>::score;
  static constexpr size_t p = dp + Dims<D>::score;
  static constexpr size_t ds = p + Dims<D>::prob;
  static constexpr size_t dk = ds + Dims<D>::prob;
  static constexpr size_t dv = dk + Dims<D>::accum;
  static constexpr size_t lse = dv + Dims<D>::accum;
  static constexpr size_t dd = lse + BQ * 4;
  static constexpr size_t bytes = dd + BQ * 4;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dd,
           const int* __restrict__ lens, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int h, int sq, int sk, int group,
           float scale, Strides qs, Strides ks, Strides vs, Strides os,
           Strides dks, Strides dvs) {
  using L = DkvLayout<D>;
  constexpr int LDH = Dims<D>::LDH, LDS = Dims<D>::LDS, LDP = Dims<D>::LDP;
  constexpr int LDO = Dims<D>::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sO = reinterpret_cast<bf16*>(smem + L::dout);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sdK = reinterpret_cast<float*>(smem + L::dk);
  float* sdV = reinterpret_cast<float*>(smem + L::dv);
  float* sL = reinterpret_cast<float*>(smem + L::lse);
  float* sD = reinterpret_cast<float*>(smem + L::dd);

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lens[b], sk);
  // lanes 2r and 2r+1 share key row `row` of this warp's 16 keys
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int key = k0 + row;
  bf16* dk_row = dk + b * dks.b + (long long)key * dks.s + kvh * dks.h + half * (D / 2);
  bf16* dv_row = dv + b * dvs.b + (long long)key * dvs.s + kvh * dvs.h + half * (D / 2);

  if (k0 >= len) {  // every key of the tile is masked: dk = dv = 0
    if (key < sk) {
      const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
      for (int j = 0; j < D / 2; j += 2) {
        *reinterpret_cast<__nv_bfloat162*>(dk_row + j) = zero;
        *reinterpret_cast<__nv_bfloat162*>(dv_row + j) = zero;
      }
    }
    return;
  }

  load_tile<D>(sK, k + b * ks.b + kvh * ks.h, ks.s, k0, sk);
  load_tile<D>(sV, v + b * vs.b + kvh * vs.h, vs.s, k0, sk);
  for (int i = threadIdx.x; i < 64 * LDO; i += NTHREADS) sdK[i] = sdV[i] = 0.f;

  const int q_first = CAUSAL ? k0 / BQ : 0;  // q tiles before it see no key here
  const int n_qt = (sq + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int hq = kvh * group + g;
    const bf16* qb = q + b * qs.b + hq * qs.h;
    const bf16* ob = dout + b * os.b + hq * os.h;
    const long long stat0 = ((long long)b * h + hq) * sq;
    for (int qt = q_first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // all warps are done with the previous Q/dO tile
      load_tile<D>(sQ, qb, qs.s, q0, sq);
      load_tile<D>(sO, ob, os.s, q0, sq);
      for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
        const bool ok = q0 + i < sq;
        sL[i] = ok ? lse[stat0 + q0 + i] : 0.f;
        sD[i] = ok ? dd[stat0 + q0 + i] : 0.f;
      }
      __syncthreads();
      mm_abt<D>(sS + warp * 16 * LDS, sK + warp * 16 * LDH, sQ);   // S^T
      mm_abt<D>(sDP + warp * 16 * LDS, sV + warp * 16 * LDH, sO);  // dP^T
      __syncwarp();
#pragma unroll 8
      for (int j = 0; j < BQ / 2; ++j) {
        const int c = half * (BQ / 2) + j;
        const int qi = q0 + c;
        const bool visible = key < len && qi < sq && (!CAUSAL || key <= qi);
        const float p = visible ? __expf(sS[row * LDS + c] * scale - sL[c]) : 0.f;
        sP[row * LDP + c] = __float2bfloat16(p);
        sDS[row * LDP + c] = __float2bfloat16(p * (sDP[row * LDS + c] - sD[c]));
      }
      __syncwarp();
      mm_ab_acc<D>(sdV + warp * 16 * LDO, sP + warp * 16 * LDP, sO);   // P^T dO
      mm_ab_acc<D>(sdK + warp * 16 * LDO, sDS + warp * 16 * LDP, sQ);  // dS^T Q
    }
  }
  __syncthreads();  // the zero fill is visible even where no q tile ran
  if (key < sk) {
    const float* krow = sdK + row * LDO + half * (D / 2);
    const float* vrow = sdV + row * LDO + half * (D / 2);
#pragma unroll 8
    for (int j = 0; j < D / 2; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + j) =
          __floats2bfloat162_rn(krow[j] * scale, krow[j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + j) =
          __floats2bfloat162_rn(vrow[j], vrow[j + 1]);
    }
  }
}

// --------------------------------------------------------------- launch ----

template <typename Kernel>
int prepare(Kernel kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Strides strides(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <int D, bool CAUSAL>
int launch_lse(const void* q, const void* k, const int* lens, void* lse,
               int b, int h, int hkv, int sq, int sk, float scale,
               const long long* st, cudaStream_t stream) {
  auto kern = lse_kernel<D, CAUSAL>;
  const size_t smem = LseLayout<D>::bytes;
  int err = prepare(kern, smem);
  if (err) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), lens,
      static_cast<float*>(lse), sq, sk, h / hkv, scale, strides(st, 0),
      strides(st, 1));
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dd, const int* lens, void* dq,
              int b, int h, int hkv, int sq, int sk, float scale,
              const long long* st, cudaStream_t stream) {
  auto kern = dq_kernel<D, CAUSAL>;
  const size_t smem = DqLayout<D>::bytes;
  int err = prepare(kern, smem);
  if (err) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd), lens,
      static_cast<bf16*>(dq), sq, sk, h / hkv, scale, strides(st, 0),
      strides(st, 1), strides(st, 2), strides(st, 3), strides(st, 4));
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dd, const int* lens, void* dk,
               void* dv, int b, int h, int hkv, int sq, int sk, float scale,
               const long long* st, cudaStream_t stream) {
  auto kern = dkv_kernel<D, CAUSAL>;
  const size_t smem = DkvLayout<D>::bytes;
  int err = prepare(kern, smem);
  if (err) return err;
  dim3 grid((sk + BK - 1) / BK, hkv, b);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd), lens,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, sq, sk, h / hkv,
      scale, strides(st, 0), strides(st, 1), strides(st, 2), strides(st, 3),
      strides(st, 4), strides(st, 5));
  return (int)cudaGetLastError();
}

}  // namespace

// All entry points: bf16 q (B, Sq, H, D), k/v (B, Sk, Hkv, D), dout like q;
// fp32 lse/dd (B, H, Sq) contiguous; int32 lens (B,); d in {64, 128};
// `strides` is host memory holding 3 int64 (batch, sequence, head) strides
// in elements per tensor, in the order of the tensor arguments.

// strides: q, k.
extern "C" int flash_bwd_lse(const void* q, const void* k, const void* lens,
                             void* lse, int b, int h, int hkv, int sq, int sk,
                             int d, int causal, float scale,
                             const void* strides, void* stream) {
  const int* l = static_cast<const int*>(lens);
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && !causal) return launch_lse<64, false>(q, k, l, lse, b, h, hkv, sq, sk, scale, st, s);
  if (d == 64 && causal) return launch_lse<64, true>(q, k, l, lse, b, h, hkv, sq, sk, scale, st, s);
  if (d == 128 && !causal) return launch_lse<128, false>(q, k, l, lse, b, h, hkv, sq, sk, scale, st, s);
  if (d == 128 && causal) return launch_lse<128, true>(q, k, l, lse, b, h, hkv, sq, sk, scale, st, s);
  return (int)cudaErrorInvalidValue;
}

// strides: q, k, v, dout, dq.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* dd,
                            const void* lens, void* dq, int b, int h, int hkv,
                            int sq, int sk, int d, int causal, float scale,
                            const void* strides, void* stream) {
  const int* l = static_cast<const int*>(lens);
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && !causal) return launch_dq<64, false>(q, k, v, dout, lse, dd, l, dq, b, h, hkv, sq, sk, scale, st, s);
  if (d == 64 && causal) return launch_dq<64, true>(q, k, v, dout, lse, dd, l, dq, b, h, hkv, sq, sk, scale, st, s);
  if (d == 128 && !causal) return launch_dq<128, false>(q, k, v, dout, lse, dd, l, dq, b, h, hkv, sq, sk, scale, st, s);
  if (d == 128 && causal) return launch_dq<128, true>(q, k, v, dout, lse, dd, l, dq, b, h, hkv, sq, sk, scale, st, s);
  return (int)cudaErrorInvalidValue;
}

// strides: q, k, v, dout, dk, dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* dd,
                             const void* lens, void* dk, void* dv, int b,
                             int h, int hkv, int sq, int sk, int d, int causal,
                             float scale, const void* strides, void* stream) {
  const int* l = static_cast<const int*>(lens);
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && !causal) return launch_dkv<64, false>(q, k, v, dout, lse, dd, l, dk, dv, b, h, hkv, sq, sk, scale, st, s);
  if (d == 64 && causal) return launch_dkv<64, true>(q, k, v, dout, lse, dd, l, dk, dv, b, h, hkv, sq, sk, scale, st, s);
  if (d == 128 && !causal) return launch_dkv<128, false>(q, k, v, dout, lse, dd, l, dk, dv, b, h, hkv, sq, sk, scale, st, s);
  if (d == 128 && causal) return launch_dkv<128, true>(q, k, v, dout, lse, dd, l, dk, dv, b, h, hkv, sq, sk, scale, st, s);
  return (int)cudaErrorInvalidValue;
}
