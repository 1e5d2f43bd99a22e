// Flash-attention forward for Hopper (sm_90a): kernels K1 and K2.
//
// Replaces the TPU kernels in u2tokenizer_tpu/ops/flash_attention.py:
//   K1  flash_fwd_noncausal  <- _kernel                 (:45, ViT self-attention)
//   K2  flash_fwd_causal     <- _kernel_causal_chunked  (:73, decoder prefill)
//
// What it computes: per (batch b, head h) softmax(q k^T * scale) v over the
// keys j < lens[b] (and j <= i for query i when causal); query head h reads
// kv head h / group (GQA). Keys in [lens[b], sk) score -1e30 (the TPU
// kernel's NEG_INF), keys past the sequence -inf. Tensors keep the
// framework's (B, S, H, D) layout with arbitrary batch/sequence/head
// strides and a contiguous head dim, so the ViT's q/k/v are read in place
// from its fused qkv projection; nothing is padded on the host.
//
// Bound on the H100: operations. Per visible (query, key) pair and head the
// two products do 4*D FLOP against O(S*D) bytes read; at the ViT's shape
// (2049 tokens, D = 64) and the prefill's (1024 tokens, D = 128) that is
// far above the card's ~295 FLOP/byte ridge. The TPU kernel kept a head's
// whole K/V resident in VMEM; one ViT head's K alone (262 KB) is over the
// 227 KB a block may use, so this kernel walks K/V in 64-key tiles with an
// fp32 online softmax, and keeps the tensor cores on wgmma with every fp32
// intermediate in registers and the copies off the threads that compute.
//
// Design: one warpgroup (4 warps, 128 threads) a block owns 64 query rows
// of one head (grid: q tiles, heads, batch).
//   * Copies: TMA (hopper.cuh). Thread 0 asks for the Q tile once and for
//     each 64-key K and V tile (one 64 x 64 box per 64 columns of the head
//     dim, 128-byte swizzled as wgmma reads it; rows past the sequence
//     arrive as zeros); an mbarrier a slot reports each tile's bytes. K has
//     two slots: the next tile's K is in flight while this one is used. V
//     has two slots at D=64; at D=128 one, and the next tile's V is asked
//     for once O += P V of this one is done, in flight while the next S and
//     softmax run: that brings a block to 66,592 B, so three blocks share an
//     SM instead of two (on the H100 it read faster at the B=4 prefill than
//     two V slots, and no slower at the other calls).
//   * S = Q K^T by wgmma m64n64k16 with both operands in shared memory, into
//     registers (fp32, 32 a thread: rows r0 and r0 + 8 of its warp's 16).
//     The scores are taken to log2 units (scale * log2 e) and masked; the
//     row max comes from the thread's 16 values of each row and shuffles
//     within the quad (xor 1, 2); the running max m and the thread's part
//     of the running sum l stay in registers (l is summed over the quad
//     once, in the epilogue). P = exp2(S - m) is rounded to bf16 into the
//     register A operand (wgmma's accumulator layout of 16 columns is its A
//     layout), and O += P V runs by wgmma m64nDk16 with V read MN-major
//     from the same swizzled layout that serves K as a K-major operand.
//   * O stays in registers (D/2 fp32 a thread), rescaled by exp2(m_old -
//     m_new) per row each tile and divided by l in the bf16 store. No
//     score, probability or accumulator tile goes through shared memory.
//   * Masks: only tiles that cross lens[b], the sequence end (2049 = 32*64
//     + 1) or the causal diagonal test each (query, key) pair. Tiles at or
//     past lens[b] and past the q tile's causal frontier are not visited.
//     Query rows past the sequence are computed and not stored.
//   * Grid order (block_of_grid): under the causal mask the costliest q
//     tile (the last, which meets every key tile) of every head first, the
//     q heads of a GQA group next to each other, so the short tiles fill in
//     behind the long ones.
// P is rounded to bf16 before its product, unnormalised (the TPU kernel
// rounds it after normalising, in _kernel); chip_smoke.py's limit for K1/K2
// allows for that.
//
// Shared memory per block, registers a thread (ptxas, CUDA 12.9, causal /
// non-causal, no spills), blocks an SM (of 233,472 B, 1 KB of it reserved
// a block, and 65,536 registers):
//     D=64   42,024 B   90 / 92   5      D=128  66,592 B  133 / 128  3
//
// Not yet done (later work): tile t+1's S product overlapping tile t's
// softmax inside the warpgroup (FA3's intra-warpgroup pipelining, with a
// third K slot) was tried and read slower at every call on the H100: its
// slot and registers cost a block an SM, and the blocks on an SM already
// overlap one another's softmax and products. Left: a producer warp with
// setmaxnreg and two consumer warpgroups taking turns; splitting the long
// causal q tiles of the B=1 call, where every block is resident at once
// and the last q tile's walk sets the time; saving the row logsumexp for
// the backward, so that K4a goes.

#include "hopper.cuh"

namespace {

template <int D>
struct FwdLayout {
  // V stages: two at D=64; one at D=128, where it brings a block from
  // 82,968 to 66,592 B, so that three fit an SM instead of two
  static constexpr int v_stages = D == 128 ? 1 : 2;
  static constexpr int tile = Tile<D>::bytes;
  static constexpr int q = 0;
  static constexpr int k0 = q + tile;                // K tile t in slot t % 2
  static constexpr int v0 = k0 + 2 * tile;           // V tile t in slot t % v_stages
  static constexpr int bars = v0 + v_stages * tile;  // Q, the K slots, the V slots
  static constexpr int n_bars = 3 + v_stages;
  static constexpr int bytes = bars + n_bars * 8 + 1024;
};

// The online softmax of one 64-key tile's scores, in place: s (this
// thread's part of S = Q K^T for keys k0.., rows q_row and q_row + 8)
// becomes P = exp2(S * scale * log2 e - m) with m the running row max;
// m_run and the thread's part of the running sum l_run move on, and alpha
// is the factor that takes O from the old max to the new one. Only a tile
// on an edge (`edge`) tests each (query, key) pair against the masks.
template <bool CAUSAL>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2],
                                               float to_log2, bool edge, int k0,
                                               int len, int sk, int q_row, int lane) {
  float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * to_log2;
      if (edge) {
        const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
        if (key >= sk) x = -INFINITY;  // past the sequence: not a key at all
        else if (key >= len || (CAUSAL && key > q_row + 8 * (e >> 1))) x = MASKED;
      }
      s[j][e] = x;
      m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the quad's four threads hold a row
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
    alpha[i] = exp2_approx(m_run[i] - m_new[i]);
    m_run[i] = m_new[i];
    l_run[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(s[j][e] - m_new[e >> 1]);
      l_run[e >> 1] += p;
      s[j][e] = p;
    }
  }
}

// q, k and v are read through TMA maps (tensor_map in hopper.cuh).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 4 : 3)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
                 const __grid_constant__ CUtensorMap v, const int* __restrict__ lens,
                 bf16* __restrict__ out, int sq, int sk, int group, float scale,
                 Strides os) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned base = aligned_smem(smem);
  const unsigned bar = base + L::bars;

  const Block blk = block_of_grid<CAUSAL, true>();
  const int q0 = blk.tile * BQ;
  const int h = blk.head;
  const int b = blk.b;
  const int kvh = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lens[b], sk);

  // keys that can be visible to this q tile
  int kv_end = len;
  if (CAUSAL) kv_end = min(kv_end, q0 + BQ);
  const int n_tiles = max((kv_end + BK - 1) / BK, 1);

  // K tile t in slot t % 2 and V tile t in slot t % v_stages, each slot on
  // its own mbarrier
  auto k_bar = [&](int t) { return bar + 8 * (1 + (t & 1)); };
  auto v_bar = [&](int t) { return bar + 8 * (3 + t % L::v_stages); };
  auto issue_k = [&](int t) {  // by one thread
    mbar_expect(k_bar(t), L::tile);
    tma_tile<D>(base + L::k0 + (t & 1) * L::tile, k, t * BK, kvh, b, k_bar(t));
  };
  auto issue_v = [&](int t) {
    mbar_expect(v_bar(t), L::tile);
    tma_tile<D>(base + L::v0 + (t % L::v_stages) * L::tile, v, t * BK, kvh, b, v_bar(t));
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::n_bars; ++i) mbar_init(bar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar, L::tile);
    tma_tile<D>(base + L::q, q, q0, h, b, bar);
    issue_k(0);
    issue_v(0);
  }

  // this lane's rows of the block's tile: r0 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  const float to_log2 = scale * 1.4426950408889634f;  // scale * log2(e)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's columns only
  float acc[D / 8][4];
  zero(acc);
  mbar_wait(bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    // the next tile's K (and, with two V stages, its V) is in flight while
    // this one is used
    if (threadIdx.x == 0 && t + 1 < n_tiles) {
      issue_k(t + 1);
      if (L::v_stages == 2) issue_v(t + 1);
    }
    const int k0 = t * BK;
    mbar_wait(k_bar(t), (t >> 1) & 1);
    float s[8][4], alpha[2];
    zero(s);  // before the fence: wgmma then reads what these wrote
    wgmma_fence();
    scores<D>(s, base + L::q, base + L::k0 + (t & 1) * L::tile);  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const bool edge = k0 + BK > len || (CAUSAL && k0 + BK - 1 > q0);
    online_softmax<CAUSAL>(s, m_run, l_run, alpha, to_log2, edge, k0, len, sk, q0 + r0,
                           lane);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    unsigned pa[4][4];
    to_operand(pa, s);
    mbar_wait(v_bar(t), (t / L::v_stages) & 1);
    wgmma_fence();
    accumulate<D>(acc, pa, base + L::v0 + (t % L::v_stages) * L::tile);  // O += P V
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with this tile's K and V slots
    if (L::v_stages == 1 && threadIdx.x == 0 && t + 1 < n_tiles) issue_v(t + 1);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
  store_rows<D>(out + b * os.b + h * os.h, os.s, acc, q0 + r0, sq, lane, inv[0], inv[1]);
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, int b, int h, int hkv, int sq, int sk, float scale,
           const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, CAUSAL>;
  const size_t smem = FwdLayout<D>::bytes;
  int err = prepare(kern, smem);
  CUtensorMap maps[3];
  if (!err) err = tensor_map(&maps[0], q, b, sq, h, D, strides(st, 0));
  if (!err) err = tensor_map(&maps[1], k, b, sk, hkv, D, strides(st, 1));
  if (!err) err = tensor_map(&maps[2], v, b, sk, hkv, D, strides(st, 2));
  if (err) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, NTHREADS, smem, stream>>>(maps[0], maps[1], maps[2], lens,
                                         static_cast<bf16*>(out), sq, sk, h / hkv,
                                         scale, strides(st, 3));
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
