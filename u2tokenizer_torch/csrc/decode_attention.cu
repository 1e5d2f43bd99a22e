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
//   out = sum_j softmax(s)_j * v_scale[j] * v_int[j]
// where key j is visible iff j < prompt_len[b] or s_prompt <= j < end[b]
// (the right-padded prompt, then the tokens generated so far).
//
// Bound on the H100: bytes. Each decode step streams every visible cache
// row once (D*BITS/8 bytes of K and of V, plus a bf16 scale each) and does
// 4*D FLOPs per row per query head, far below the card's ~295 FLOP/byte
// ridge. So the design reads each visible row exactly once for all `group`
// query heads of its kv head, and keeps enough bytes in flight to fill the
// card at every batch:
//   * Split over the sequence. The grid is (n_split, Hkv, B), one launch.
//     The visible rows of a (row, kv head), renumbered [0, a) + [c, e)
//     from two scalars, are cut into n_split equal shares; a block takes
//     one. The host picks n_split from static shapes only (B * Hkv against
//     the SMs, and the cache length; ops/decode_attention.split_count), so
//     the call never reads prompt_len or end on the host and can be
//     captured in a CUDA graph. A share may hold no rows. On the H100 the
//     serving calls read fastest at about two blocks an SM (B=4: 8 splits,
//     B=1: 12-16) and unsplit at B=112, where 896 blocks already fill the
//     card and each split costs a partial and a merge (PERF.md, PR 6).
//   * One pass, online softmax. Each thread owns 16 values of a row's head
//     dim (16 bytes at int8, 8 at int4) and loads the K and V bytes and the
//     two scales of U rows (2 at int8, 4 at int4: 64 bytes a thread) before
//     it uses any, so every thread keeps several loads in flight (32 or 128
//     bytes, 64-thread blocks, and the next iteration's loads issued before
//     this one's arithmetic all read slower on the H100). The values are
//     made fp32 without int-to-float conversions (unpack). Scores
//     are reduced over the row's D/16 threads by shuffles; each warp keeps
//     a running max and sum per query head (log2 units, MUFU.EX2) and its
//     value sums in registers, rescaled when the max moves. The warps'
//     partials merge in shared memory in warp order.
//   * The merge over splits. With one split the block writes the output.
//     Else each block writes (m, l) per query head and its fp32 value sums
//     (group x D) to a workspace, fences, and takes a ticket from a counter
//     per (row, kv head); the block that takes the last ticket merges the
//     n_split partials in split order, writes the output and sets the
//     counter back to 0. The result does not depend on the blocks' order
//     (bit-equal from call to call), and no memset runs between calls: the
//     wrapper allocates the workspace and the counters (zeroed) once per
//     device. Two calls on different streams must not share them.
// The probability of each row is rounded to bf16 before the value product,
// unnormalised and times its v-scale (the TPU kernel and the plain version
// round the normalised one): each term differs from the plain version's by
// up to 2^-8 relative. Over many rows those differences average out and
// the output's own bf16 rounding dominates; over a few they need not (a
// mirror of this arithmetic in plain PyTorch, at this kernel's shapes on
// random data, went past chip_smoke.py's limit for K3 below ~250 visible
// rows, and used at most 0.62 of it from 512 on). So a (row, kv head) with
// fewer than EXACT_ROWS = 512 visible rows is not split: one block takes
// it in the plain version's order of rounding (scores into shared memory,
// the softmax, p = bf16(softmax * v_scale), the value pass), and the other
// blocks of its grid column exit. The test is made on the device, per
// (row, kv head), from prompt_len and end.
//
// Known limits (later work): at B=112 the kernel reads at ~40 % of the
// card's byte rate: with 128 registers a thread, 4 blocks (16 warps) share
// an SM, and the ~170 instructions each (row, thread) issues (unpacking,
// 2 x group x 16 FMAs, the shuffles and the online softmax, the latter
// repeated by the row's D/16 threads) leave the loads' latency exposed.
// A group of 2 fills 2 of a tensor-core tile's 16 rows, so mma does not
// pay here. At group 8 a thread holds 128 query values and 128 value sums
// and spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DPT = 16;  // head-dim values a thread owns
constexpr float LOG2E = 1.4426950408889634f;
// A (row, kv head) with fewer visible rows is not split (see the header).
constexpr int EXACT_ROWS = 512;
constexpr int MAX_SPLIT = 64;  // ops/decode_attention.split_count keeps to it

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// The DPT * BITS / 8 cache bytes of a thread's slice of a row.
template <int BITS>
struct Slice {
  static constexpr int words = DPT * BITS / 32;  // 4 at int8, 2 at int4
  uint32_t w[words];
};

template <int BITS>
__device__ __forceinline__ Slice<BITS> load_slice(const int8_t* p) {
  Slice<BITS> s;
  if constexpr (BITS == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    s.w[0] = r.x; s.w[1] = r.y; s.w[2] = r.z; s.w[3] = r.w;
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    s.w[0] = r.x; s.w[1] = r.y;
  }
  return s;
}

// Slice -> DPT values with no int-to-float conversion (I2F runs at 16 a
// clock on an SM, against 64 logic and 128 fp32 operations). Value n of a
// 32-bit word sits in its bits [BITS*n, BITS*(n+1)) (byte order and, at
// int4, the low nibble first give the values in the order of d). Flipping
// its sign bit makes it s + OFF >= 0; masked in place within its 16-bit
// half of the word and or-ed into the bits of 2^23, it reads as
// 2^23 + (s + OFF) * 2^sh exactly, so one fp32 subtraction gives
//   x = (s + OFF) * 2^sh,   sh = BITS * (n % (PER / 2)).
// The caller folds 2^-sh into its other factor (unscale) and takes OFF off
// the sum once (score: OFF * sum q; values: OFF * sum p).
template <int BITS>
struct Packed {
  static constexpr int PER = 32 / BITS;  // values a word
  static constexpr float OFF = BITS == 8 ? 128.f : 8.f;
  static constexpr uint32_t FLIP = BITS == 8 ? 0x80808080u : 0x88888888u;
};

template <int BITS>
__device__ __forceinline__ void unpack(const Slice<BITS>& s, float (&x)[DPT]) {
  constexpr int PER = Packed<BITS>::PER, HALF = PER / 2;
  constexpr uint32_t MASK = (1u << BITS) - 1;
#pragma unroll
  for (int i = 0; i < Slice<BITS>::words; ++i) {
    const uint32_t w = s.w[i] ^ Packed<BITS>::FLIP;
    const uint32_t half[2] = {w, w >> 16};
#pragma unroll
    for (int n = 0; n < PER; ++n)
      x[i * PER + n] =
          __uint_as_float((half[n / HALF] & (MASK << (BITS * (n % HALF)))) | 0x4B000000u) -
          8388608.f;
  }
}

// 2^-sh of value j of a slice (a power of two: multiplying by it is exact)
template <int BITS>
__device__ __forceinline__ float unscale(int j) {
  constexpr int HALF = Packed<BITS>::PER / 2;
  return 1.f / (float)(1u << (BITS * (j % Packed<BITS>::PER % HALF)));
}

// The thread's DPT values of q, rounded like the TPU kernel (bf16(q *
// bf16(scale))) and times unscale, and OFF times their sum before unscale.
template <int BITS, int D, int G>
__device__ __forceinline__ void load_q(const bf16* q, float scale, int sub,
                                       float (&qr)[G][DPT], float (&qoff)[G]) {
  const bf16 scale_h = __float2bfloat16(scale);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4* qh = reinterpret_cast<const uint4*>(q + g * D + sub * DPT);
    qoff[g] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint4 raw = qh[half];
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = __bfloat162float(__hmul(x[j], scale_h));
        qoff[g] += v;
        qr[g][half * 8 + j] = v * unscale<BITS>(half * 8 + j);
      }
    }
    qoff[g] *= Packed<BITS>::OFF;
  }
}

// q . k over the row's TPR threads (each thread's DPT values, then
// shuffles): every lane of the row gets it.
template <int BITS, int G, int TPR>
__device__ __forceinline__ void dots(const float (&qr)[G][DPT], const float (&qoff)[G],
                                     const Slice<BITS>& kr, float (&acc)[G]) {
  float kf[DPT];
  unpack<BITS>(kr, kf);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc[g] = -qoff[g];
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[g] = fmaf(qr[g][j], kf[j], acc[g]);
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
  }
}

// The value sums o' = sum p * x and psum = sum p (this thread's rows) to
// sum p * v: unscaled, OFF * psum taken off.
template <int BITS, int G>
__device__ __forceinline__ void finish_values(float (&o)[G][DPT], const float (&psum)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      o[g][j] = fmaf(o[g][j], unscale<BITS>(j), -Packed<BITS>::OFF * psum[g]);
}

// A (row, kv head) with n_vis < EXACT_ROWS visible rows, by one block in
// the plain version's order of rounding: the scores into shared memory, the
// softmax over them, p = bf16(softmax * v_scale), then the value pass.
template <int BITS, int D, int G>
__device__ void exact_row(const float (&qr)[G][DPT], const float (&qoff)[G], const int8_t* kb,
                          const int8_t* vb,
                          const bf16* ksb, const bf16* vsb, int a, int c, int n_vis,
                          bf16* out, float (*s_o)[G][D]) {
  constexpr int ROW = D * BITS / 8;
  constexpr int TPR = D / DPT;
  constexpr int RPW = 32 / TPR;
  __shared__ float s_p[G][EXACT_ROWS];  // scores, then probabilities
  __shared__ float red[NWARPS];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % TPR;
  const int slot = lane / TPR;

  for (int i0 = warp * RPW; i0 < n_vis; i0 += NWARPS * RPW) {  // warp-uniform
    const int i = i0 + slot;
    const bool ok = i < n_vis;
    const int r = i < a ? i : c + (i - a);
    Slice<BITS> kr = {};
    if (ok) kr = load_slice<BITS>(kb + (long long)r * ROW);
    float acc[G];
    dots<BITS, G, TPR>(qr, qoff, kr, acc);
    if (ok && sub == 0)
#pragma unroll
      for (int g = 0; g < G; ++g) s_p[g][i] = acc[g] * __bfloat162float(ksb[r]);
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    float m = -INFINITY;
    for (int i = threadIdx.x; i < n_vis; i += NTHREADS) m = fmaxf(m, s_p[g][i]);
    m = block_reduce<true>(m, red);
    float l = 0.f;
    for (int i = threadIdx.x; i < n_vis; i += NTHREADS) {
      const float p = __expf(s_p[g][i] - m);
      s_p[g][i] = p;
      l += p;
    }
    const float inv = 1.f / block_reduce<false>(l, red);
    for (int i = threadIdx.x; i < n_vis; i += NTHREADS) {
      const int r = i < a ? i : c + (i - a);
      s_p[g][i] = __bfloat162float(__float2bfloat16(s_p[g][i] * inv * __bfloat162float(vsb[r])));
    }
  }
  __syncthreads();
  float o[G][DPT] = {}, psum[G] = {};
  for (int i = warp * RPW + slot; i < n_vis; i += NWARPS * RPW) {
    const int r = i < a ? i : c + (i - a);
    float vf[DPT];
    unpack<BITS>(load_slice<BITS>(vb + (long long)r * ROW), vf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      psum[g] += s_p[g][i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) o[g][j] = fmaf(s_p[g][i], vf[j], o[g][j]);
    }
  }
  finish_values<BITS, G>(o, psum);
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off >= TPR; off >>= 1)
#pragma unroll
      for (int j = 0; j < DPT; ++j) o[g][j] += __shfl_xor_sync(0xffffffffu, o[g][j], off);
    if (lane < TPR)
#pragma unroll
      for (int j = 0; j < DPT; ++j) s_o[warp][g][sub * DPT + j] = o[g][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NTHREADS) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) acc += s_o[w][idx / D][idx % D];
    out[idx] = __float2bfloat16(acc);
  }
}

template <int BITS, int D, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k,
                   const bf16* __restrict__ ks, const int8_t* __restrict__ v,
                   const bf16* __restrict__ vs, const int* __restrict__ plen,
                   const int* __restrict__ end, bf16* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ counters, int sk,
                   int s_prompt, float scale) {
  constexpr int ROW = D * BITS / 8;         // bytes per cache row
  constexpr int BPT = DPT * BITS / 8;       // bytes a thread reads of a row
  constexpr int TPR = D / DPT;              // threads per row
  constexpr int RPW = 32 / TPR;             // rows per warp per load
  constexpr int U = 64 / (2 * BPT);         // rows a thread loads at once
  constexpr int RW = RPW * U;               // rows per warp per iteration
  constexpr int PART = G * (D + 2);         // floats of a split's partial
  __shared__ float s_m[NWARPS][G], s_l[NWARPS][G];
  __shared__ __align__(16) float s_o[NWARPS][G][D];
  __shared__ int s_last;

  const int n_split = gridDim.x;
  const int split = blockIdx.x;
  const int hkv = gridDim.y;
  const int bh = blockIdx.z * hkv + blockIdx.y;  // b * hkv + kv head
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % TPR;           // which DPT dims of the row
  const int slot = lane / TPR;          // this lane's row within a load

  // visible rows = [0, a) + [c, e), renumbered 0 .. n_vis-1; this block's
  // share is [lo, hi)
  const int a = max(min(plen[b], sk), 0);
  const int c = max(s_prompt, a);
  const int e = max(min(end[b], sk), c);
  const int n_vis = a + (e - c);
  const int share = (n_vis + n_split - 1) / n_split;
  const int lo = min(split * share, n_vis);
  const int hi = min(lo + share, n_vis);

  float qr[G][DPT], qoff[G];
  load_q<BITS, D, G>(q + (long long)bh * G * D, scale, sub, qr, qoff);

  const int8_t* kb = k + (long long)bh * sk * ROW + sub * BPT;
  const int8_t* vb = v + (long long)bh * sk * ROW + sub * BPT;
  const bf16* ksb = ks + (long long)bh * sk;
  const bf16* vsb = vs + (long long)bh * sk;
  if (n_vis < EXACT_ROWS) {  // block-uniform: a short row is not split
    if (split == 0)
      exact_row<BITS, D, G>(qr, qoff, kb, vb, ksb, vsb, a, c, n_vis,
                            out + (long long)bh * G * D, s_o);
    return;
  }

  // per query head: the running max (log2 units) and sum, the value sums
  // o' and psum of finish_values
  float m_run[G], l_run[G], o[G][DPT], psum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = psum[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[g][j] = 0.f;
  }

  // The loop bound is warp-uniform, so the shuffles always run on full warps.
  for (int i0 = lo + warp * RW; i0 < hi; i0 += NWARPS * RW) {
    Slice<BITS> kr[U], vr[U];
    float ksc[U], vsc[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load of the iteration first
      const int i = i0 + u * RPW + slot;
      ok[u] = i < hi;
      const int r = i < a ? i : c + (i - a);
      if (ok[u]) {
        kr[u] = load_slice<BITS>(kb + (long long)r * ROW);
        vr[u] = load_slice<BITS>(vb + (long long)r * ROW);
        ksc[u] = __bfloat162float(ksb[r]);
        vsc[u] = __bfloat162float(vsb[r]);
      } else {
#pragma unroll
        for (int w = 0; w < Slice<BITS>::words; ++w) kr[u].w[w] = vr[u].w[w] = 0u;
        ksc[u] = vsc[u] = 0.f;
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float acc[G];
      dots<BITS, G, TPR>(qr, qoff, kr[u], acc);
#pragma unroll
      for (int g = 0; g < G; ++g)
        s[u][g] = ok[u] ? acc[g] * ksc[u] * LOG2E : -INFINITY;  // log2 units
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][g]);
#pragma unroll
      for (int off = 16; off >= TPR; off >>= 1)  // over the warp's rows
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[g], mx);
      if (m_new > m_run[g]) {  // warp-uniform; m_new is finite here
        const float alpha = exp2_approx(m_run[g] - m_new);
        l_run[g] *= alpha;
        psum[g] *= alpha;
#pragma unroll
        for (int j = 0; j < DPT; ++j) o[g][j] *= alpha;
        m_run[g] = m_new;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? exp2_approx(s[u][g] - m_run[g]) : 0.f;
        l_run[g] += p;
        s[u][g] = __bfloat162float(__float2bfloat16(p * vsc[u]));
        psum[g] += s[u][g];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[DPT];
      unpack<BITS>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < DPT; ++j) o[g][j] = fmaf(s[u][g], vf[j], o[g][j]);
    }
  }

  finish_values<BITS, G>(o, psum);

  // the warp's partial: sums over its rows (the lanes of one `sub` hold the
  // same dims of different rows; every lane of a row holds its p)
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off >= TPR; off >>= 1) {
      l_run[g] += __shfl_xor_sync(0xffffffffu, l_run[g], off);
#pragma unroll
      for (int j = 0; j < DPT; ++j) o[g][j] += __shfl_xor_sync(0xffffffffu, o[g][j], off);
    }
    if (lane == 0) {
      s_m[warp][g] = m_run[g];
      s_l[warp][g] = l_run[g];
    }
    if (lane < TPR)
#pragma unroll
      for (int j = 0; j < DPT; ++j) s_o[warp][g][sub * DPT + j] = o[g][j];
  }
  __syncthreads();

  // the block's partial, the warps merged in order; with one split it is
  // the output
  float* part = ws + ((long long)bh * n_split + split) * PART;
  for (int idx = threadIdx.x; idx < G * D; idx += NTHREADS) {
    const int g = idx / D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, s_m[w][g]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = s_m[w][g] == -INFINITY ? 0.f : exp2_approx(s_m[w][g] - m);
      l = fmaf(s_l[w][g], f, l);
      acc = fmaf(s_o[w][g][idx % D], f, acc);
    }
    if (n_split == 1) {
      out[(long long)bh * G * D + idx] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
    } else {
      if (idx % D == 0) {
        part[g] = m;
        part[G + g] = l;
      }
      part[2 * G + idx] = acc;
    }
  }
  if (n_split == 1) return;

  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&counters[bh], 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the splits' weights e^(m - M) / L per query head into shared memory,
  // then each output value's sum over the splits, loads in flight together
  __shared__ float s_f[MAX_SPLIT][G];
  const float* parts = ws + (long long)bh * n_split * PART;
  for (int t = threadIdx.x; t < n_split * G; t += NTHREADS)
    s_f[t / G][t % G] = __ldcg(parts + (t / G) * PART + t % G);  // m
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float m = -INFINITY, l = 0.f;
    for (int sp = 0; sp < n_split; ++sp) m = fmaxf(m, s_f[sp][g]);
    for (int sp = 0; sp < n_split; ++sp) {  // in split order: deterministic
      const float f = s_f[sp][g] == -INFINITY ? 0.f : exp2_approx(s_f[sp][g] - m);
      l = fmaf(__ldcg(parts + sp * PART + G + g), f, l);
      s_f[sp][g] = f;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int sp = 0; sp < n_split; ++sp) s_f[sp][g] *= inv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NTHREADS) {
    const int g = idx / D;
    float acc = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_split; ++sp)  // in split order
      acc = fmaf(__ldcg(parts + sp * PART + 2 * G + idx), s_f[sp][g], acc);
    out[(long long)bh * G * D + idx] = __float2bfloat16(acc);
  }
  if (threadIdx.x == 0) counters[bh] = 0;  // every split of this launch has counted
}

template <int BITS, int D, int G>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, const void* plen, const void* end, void* out,
           void* ws, void* counters, int b, int hkv, int sk, int s_prompt,
           int n_split, float scale, cudaStream_t stream) {
  dim3 grid(n_split, hkv, b);
  decode_attn_kernel<BITS, D, G><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k),
      static_cast<const bf16*>(ks), static_cast<const int8_t*>(v),
      static_cast<const bf16*>(vs), static_cast<const int*>(plen),
      static_cast<const int*>(end), static_cast<bf16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), sk, s_prompt, scale);
  return (int)cudaGetLastError();
}

#define K3_ARGS q, k, ks, v, vs, plen, end, out, ws, counters, b, hkv, sk, s_prompt, n_split, scale, s

template <int BITS, int D>
int dispatch_group(int g, const void* q, const void* k, const void* ks,
                   const void* v, const void* vs, const void* plen,
                   const void* end, void* out, void* ws, void* counters, int b,
                   int hkv, int sk, int s_prompt, int n_split, float scale,
                   cudaStream_t s) {
  switch (g) {
    case 1: return launch<BITS, D, 1>(K3_ARGS);
    case 2: return launch<BITS, D, 2>(K3_ARGS);
    case 4: return launch<BITS, D, 4>(K3_ARGS);
    case 8: return launch<BITS, D, 8>(K3_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

template <int BITS>
int dispatch(const void* q, const void* k, const void* ks, const void* v,
             const void* vs, const void* plen, const void* end, void* out,
             void* ws, void* counters, int b, int h, int hkv, int sk, int d,
             int s_prompt, int n_split, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = h / hkv;
  if (n_split < 1 || n_split > MAX_SPLIT) return (int)cudaErrorInvalidValue;
  if (d == 64) return dispatch_group<BITS, 64>(g, K3_ARGS);
  if (d == 128) return dispatch_group<BITS, 128>(g, K3_ARGS);
  return (int)cudaErrorInvalidValue;
}

#undef K3_ARGS

}  // namespace

// q (B, 1, H, D) bf16; k, v (B, Hkv, S, D) int8; ks, vs (B, Hkv, S) bf16;
// plen, end (B,) int32; out (B, 1, H, D) bf16. All contiguous on the
// device. ws: B * Hkv * n_split * group * (D + 2) fp32 (unused at
// n_split 1); counters: B * Hkv int32, zero before the first call, left
// zero by every call.
extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* ks, const void* v,
                                     const void* vs, const void* plen,
                                     const void* end, void* out, void* ws,
                                     void* counters, int b, int h, int hkv,
                                     int sk, int d, int s_prompt, int n_split,
                                     float scale, void* stream) {
  return dispatch<8>(q, k, ks, v, vs, plen, end, out, ws, counters, b, h, hkv, sk, d,
                     s_prompt, n_split, scale, stream);
}

// As decode_attention_int8, with k, v (B, Hkv, S, D/2) int8 holding packed
// int4 pairs (low nibble = even d).
extern "C" int decode_attention_int4(const void* q, const void* k,
                                     const void* ks, const void* v,
                                     const void* vs, const void* plen,
                                     const void* end, void* out, void* ws,
                                     void* counters, int b, int h, int hkv,
                                     int sk, int d, int s_prompt, int n_split,
                                     float scale, void* stream) {
  return dispatch<4>(q, k, ks, v, vs, plen, end, out, ws, counters, b, h, hkv, sk, d,
                     s_prompt, n_split, scale, stream);
}
