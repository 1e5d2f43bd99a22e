// Single-token GQA decode attention over the head-major quantized KV cache
// for Hopper (sm_90a): kernel K3, in two forms.
//
// Replaces u2tokenizer_tpu/ops/decode_attention.py:_decode_kernel. Its body
// converts int8 or int4 cache values to bf16 in registers, so one Pallas
// kernel serves both caches; here one template over the element width gives
// the two entries:
//   decode_attention_int8: k, v (B, Hkv, S, D) int8;
//   decode_attention_int4: k, v (B, Hkv, S, D/2) int8, two values a byte
//     along D, the low nibble the even index, each in [-7, 7] and read
//     sign-extended (the port's packed cache, ops/attention.pack_nibbles).
//
// What it computes: for batch row b and query head h (kv head h / group),
//   s_j = (bf16(q * scale) . k_int[j]) * k_scale[j]       over visible keys j
//   p_j = bf16(softmax(s)_j * v_scale[j]);   out = sum_j p_j v_int[j]
// where key j is visible iff j < prompt_len[b] or s_prompt <= j < end[b]
// (the right-padded prompt, then the tokens generated so far).
//
// Bound on the H100: bytes. Each decode step streams every visible cache
// row once (D*BITS/8 bytes of K and of V, plus a bf16 scale each) and does
// 4*D FLOPs per row per query head, far below the card's ~295 FLOP/byte
// ridge. The design reads each row exactly once for all `group` query heads
// of its kv head: one block per (batch row, kv head), each row read as
// 16 bytes a thread (D/16 threads at int8, D/32 at int4), the values
// unpacked and converted in registers, the k-scale folded into the score
// and the v-scale into the probability. The mask is two intervals computed
// from two scalars per row, and only visible rows are read at all (rows of
// the pad gap and unwritten slots cost no bytes). Scores and softmax live
// in shared memory and registers; the value sums are reduced over a warp's
// rows with shuffles, then over the block's warps in shared memory.
//
// Known limits (later work): at batch 4 with 8 kv heads the grid is only 32
// blocks on 132 SMs, so the card's bandwidth is far from saturated; the fix
// is to split each (row, head) over the sequence and merge partial softmaxes.
// At group 8 the int4 form holds 256 query values a thread and spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Block-wide reduction; `red` holds NWARPS floats. Every thread gets the result.
template <bool MAX>
__device__ float block_reduce(float x, float* red) {
  x = MAX ? warp_max(x) : warp_sum(x);
  __syncthreads();  // `red` may still be read by a previous reduction
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// 16 cache bytes -> 128 / BITS values, sign-extended: value n of a 32-bit
// word sits in its bits [BITS*n, BITS*(n+1)), so byte order and, at int4,
// the low nibble first give the values in the order of d.
template <int BITS>
__device__ __forceinline__ void unpack16(const uint4& raw, float* x) {
  constexpr int PER = 32 / BITS;
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < PER; ++n)
      x[i * PER + n] = (float)((int32_t)(w[i] << (32 - BITS * (n + 1))) >> (32 - BITS));
}

template <int BITS, int D, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k,
                   const bf16* __restrict__ ks, const int8_t* __restrict__ v,
                   const bf16* __restrict__ vs, const int* __restrict__ plen,
                   const int* __restrict__ end, bf16* __restrict__ out, int hkv,
                   int sk, int s_prompt, float scale) {
  constexpr int ROW = D * BITS / 8;    // bytes per cache row
  constexpr int TPR = ROW / 16;        // threads per cache row, 16 bytes each
  constexpr int DPT = D / TPR;         // values per thread: 16 (int8), 32 (int4)
  constexpr int RPW = 32 / TPR;        // rows per warp per step
  constexpr int RPI = NTHREADS / TPR;  // rows per block per step
  extern __shared__ __align__(16) float smem[];
  float* s_p = smem;                   // [G][n_vis] scores, then probabilities
  float* s_part = smem + G * sk;       // [NWARPS][G][D] partial outputs
  __shared__ float red[NWARPS];

  const int bh = blockIdx.x;           // b * hkv + kv head
  const int b = bh / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % TPR;          // which DPT dims of the row
  const int slot = warp * RPW + lane / TPR;  // this thread's row within a step

  // visible rows = [0, a) + [c, e), renumbered 0 .. n_vis-1
  const int a = max(min(plen[b], sk), 0);
  const int c = max(s_prompt, a);
  const int e = max(min(end[b], sk), c);
  const int n_vis = a + (e - c);

  // q rounded like the TPU kernel: bf16(q * bf16(scale))
  const bf16 scale_h = __float2bfloat16(scale);
  float qr[G][DPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bf16* qh = q + ((long long)bh * G + g) * D + sub * DPT;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      qr[g][j] = __bfloat162float(__hmul(qh[j], scale_h));
  }

  const int8_t* kb = k + (long long)bh * sk * ROW + sub * 16;
  const int8_t* vb = v + (long long)bh * sk * ROW + sub * 16;
  const bf16* ksb = ks + (long long)bh * sk;
  const bf16* vsb = vs + (long long)bh * sk;

  // phase 1: scores. The loop bound is warp-uniform so that the shuffles
  // below always run on full warps.
  for (int i0 = warp * RPW; i0 < n_vis; i0 += RPI) {
    const int i = i0 + lane / TPR;
    const bool ok = i < n_vis;
    const int r = i < a ? i : c + (i - a);
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (ok) raw = *reinterpret_cast<const uint4*>(kb + (long long)r * ROW);
    float kf[DPT];
    unpack16<BITS>(raw, kf);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(qr[g][j], kf[j], acc[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
    }
    if (ok && sub == 0) {
      const float kscale = __bfloat162float(ksb[r]);
#pragma unroll
      for (int g = 0; g < G; ++g) s_p[g * sk + i] = acc[g] * kscale;
    }
  }
  __syncthreads();

  // phase 2: softmax per query head; fold the v-scales into the probabilities
  for (int g = 0; g < G; ++g) {
    float* sg = s_p + g * sk;
    float m = -INFINITY;
    for (int i = threadIdx.x; i < n_vis; i += NTHREADS) m = fmaxf(m, sg[i]);
    m = block_reduce<true>(m, red);
    float l = 0.f;
    for (int i = threadIdx.x; i < n_vis; i += NTHREADS) {
      const float p = __expf(sg[i] - m);
      sg[i] = p;
      l += p;
    }
    l = block_reduce<false>(l, red);
    const float inv = 1.f / l;
    for (int i = threadIdx.x; i < n_vis; i += NTHREADS) {
      const int r = i < a ? i : c + (i - a);
      const float p = sg[i] * inv * __bfloat162float(vsb[r]);
      sg[i] = __bfloat162float(__float2bfloat16(p));
    }
  }
  __syncthreads();

  // phase 3: out = sum_i p_i v_i, each thread over its rows and DPT dims
  float o[G][DPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[g][j] = 0.f;
  for (int i = slot; i < n_vis; i += RPI) {
    const int r = i < a ? i : c + (i - a);
    const uint4 raw = *reinterpret_cast<const uint4*>(vb + (long long)r * ROW);
    float vf[DPT];
    unpack16<BITS>(raw, vf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = s_p[g * sk + i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) o[g][j] = fmaf(p, vf[j], o[g][j]);
    }
  }
  // sum over the warp's rows: the lanes with the same `sub` hold the same dims
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
#pragma unroll
      for (int off = 16; off >= TPR; off >>= 1)
        o[g][j] += __shfl_xor_sync(0xffffffffu, o[g][j], off);
    }
  if (lane < TPR) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        s_part[(warp * G + g) * D + sub * DPT + j] = o[g][j];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += NTHREADS) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) acc += s_part[w * G * D + idx];
    out[(long long)bh * G * D + idx] = __float2bfloat16(acc);
  }
}

template <int BITS, int D, int G>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, const void* plen, const void* end, void* out,
           int b, int hkv, int sk, int s_prompt, float scale,
           cudaStream_t stream) {
  auto kern = decode_attn_kernel<BITS, D, G>;
  const size_t smem = (size_t(G) * sk + size_t(NWARPS) * G * D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<b * hkv, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k),
      static_cast<const bf16*>(ks), static_cast<const int8_t*>(v),
      static_cast<const bf16*>(vs), static_cast<const int*>(plen),
      static_cast<const int*>(end), static_cast<bf16*>(out), hkv, sk,
      s_prompt, scale);
  return (int)cudaGetLastError();
}

template <int BITS, int D>
int dispatch_group(int g, const void* q, const void* k, const void* ks,
                   const void* v, const void* vs, const void* plen,
                   const void* end, void* out, int b, int hkv, int sk,
                   int s_prompt, float scale, cudaStream_t s) {
  switch (g) {
    case 1: return launch<BITS, D, 1>(q, k, ks, v, vs, plen, end, out, b, hkv, sk, s_prompt, scale, s);
    case 2: return launch<BITS, D, 2>(q, k, ks, v, vs, plen, end, out, b, hkv, sk, s_prompt, scale, s);
    case 4: return launch<BITS, D, 4>(q, k, ks, v, vs, plen, end, out, b, hkv, sk, s_prompt, scale, s);
    case 8: return launch<BITS, D, 8>(q, k, ks, v, vs, plen, end, out, b, hkv, sk, s_prompt, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int BITS>
int dispatch(const void* q, const void* k, const void* ks, const void* v,
             const void* vs, const void* plen, const void* end, void* out,
             int b, int h, int hkv, int sk, int d, int s_prompt, float scale,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = h / hkv;
  if (d == 64) return dispatch_group<BITS, 64>(g, q, k, ks, v, vs, plen, end, out, b, hkv, sk, s_prompt, scale, s);
  if (d == 128) return dispatch_group<BITS, 128>(g, q, k, ks, v, vs, plen, end, out, b, hkv, sk, s_prompt, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, 1, H, D) bf16; k, v (B, Hkv, S, D) int8; ks, vs (B, Hkv, S) bf16;
// plen, end (B,) int32; out (B, 1, H, D) bf16. All contiguous on the device.
extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* ks, const void* v,
                                     const void* vs, const void* plen,
                                     const void* end, void* out, int b, int h,
                                     int hkv, int sk, int d, int s_prompt,
                                     float scale, void* stream) {
  return dispatch<8>(q, k, ks, v, vs, plen, end, out, b, h, hkv, sk, d,
                     s_prompt, scale, stream);
}

// As decode_attention_int8, with k, v (B, Hkv, S, D/2) int8 holding packed
// int4 pairs (low nibble = even d).
extern "C" int decode_attention_int4(const void* q, const void* k,
                                     const void* ks, const void* v,
                                     const void* vs, const void* plen,
                                     const void* end, void* out, int b, int h,
                                     int hkv, int sk, int d, int s_prompt,
                                     float scale, void* stream) {
  return dispatch<4>(q, k, ks, v, vs, plen, end, out, b, h, hkv, sk, d,
                     s_prompt, scale, stream);
}
