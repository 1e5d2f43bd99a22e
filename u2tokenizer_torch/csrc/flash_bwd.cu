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
// K4a does 2*D FLOP (QK^T) and one exponential, K4b 6*D (QK^T, dO V^T,
// dS K) and K4c 8*D (the same two score products again, P^T dO and dS^T Q)
// and one each, against O(S*D) bytes; at the training shapes (ViT 2049
// tokens, D = 64; decoder 1024 tokens, D = 128) each is far above the
// card's ~295 FLOP/byte ridge. So all three keep the tensor cores on
// wgmma, every fp32 intermediate in registers, and the copies off the
// threads that compute.
//
// K4b and K4c: one warpgroup (4 warps, 128 threads) a block, 64-row tiles.
//   * K4c: a block owns 64 keys of one kv head (grid: key tiles, kv heads,
//     batch). K and V stay in shared memory; the block walks the GQA
//     group's q heads and, for each, the q tiles from the causal frontier
//     on. Per q tile: S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 with
//     both operands in shared memory, into registers (fp32, 32 a thread
//     each); P^T and dS^T formed in registers from lse and dd staged with
//     the tile and rounded to bf16; then dV += P^T dO and dK += dS^T Q by
//     wgmma m64nDk16 with P^T / dS^T as the register A operand (wgmma's
//     accumulator layout of 16 columns is its A layout) and dO / Q read
//     MN-major from the same tiles. dK and dV (D/2 fp32 each a thread) stay
//     in registers for the whole walk; no fp32 tile goes through shared
//     memory. The group is summed inside the block: no atomics,
//     deterministic.
//   * K4b: a block owns 64 query rows of one head. Q and dO stay in shared
//     memory; per K/V tile, S = Q K^T and dP = dO V^T into registers, dS in
//     registers, dQ += dS K with dS as the register A operand; dQ stays in
//     registers until the scaled bf16 store.
//   * In an iteration S and dP are separate wgmma groups: P is formed while
//     dP is in flight, and in K4c dV += P^T dO runs while dS^T is formed.
//   * Copies: TMA. Thread 0 asks for each 64-row tile (one 64 x 64 box per
//     64 columns of the head dim, 128-byte swizzled as wgmma reads it; rows
//     past the sequence arrive as zeros) and an mbarrier reports its bytes.
//     Two stages: K4c's Q/dO tiles, K4b's K/V tiles; the next tile is in
//     flight while this one is used. K4c's lse and dd (64 fp32 each, whose
//     rows need not be 16-byte aligned) come by 4-byte cp.async, one value
//     a thread. The threads that compute spend no instructions on the
//     tiles' copies, where this design's first version, with per-thread
//     16-byte cp.async, stalled on issuing them (PERF.md, PR 4).
//   * Shared memory per block, registers a thread (ptxas, CUDA 12.9,
//     causal / non-causal, no spills), blocks per SM (of 232,448 B and
//     65,536 registers):
//       K4b  D=64   50,200 B  122 / 122  4      D=128   99,352 B  156 / 154  2
//       K4c  D=64   51,224 B  168 / 161  3      D=128  100,376 B  236 / 230  2
//     where PR 2's fp32 staging (K4c 125,440 / 190,976 B) allowed one K4c
//     block. K4c at D=128 holds 128 accumulator floats, S^T and dP^T (64)
//     and the bf16 P^T and dS^T operands (32) a thread.
//   * Masks: only tiles that cross lens[b], the sequence end or the causal
//     diagonal test each (query, key) pair; a masked pair gets P = 0. A
//     K4c block whose keys all lie at or past lens[b] writes zeros without
//     reading anything else; rows past the sequence are never written.
//   * Grid order, and the B=1 decoder call (16 key tiles x 8 kv heads =
//     128 K4c blocks on 132 SMs; under the causal mask key tile 0 walks 2 x
//     16 q tiles and the last 2 x 1). Two options were weighed: ordering
//     the grid so the longest tiles start first, or splitting a key tile's
//     q range over two blocks and summing the two fp32 partial dK/dV in a
//     fixed order. Chosen: ordering (block_of_grid). Under the causal mask
//     the blocks run tile-major, the costliest tile of every head first,
//     so the short tiles fill in behind (the B=4 decoder call has 512 K4c
//     blocks for 264 slots). The split would need a (2, B, Sk, Hkv, D) fp32
//     scratch and a second pass over it, a launch that K4c's count and the
//     TPU kernel do not have; at B=1 every block is resident at once, so
//     the call lasts as long as tile 0's walk (PERF.md gives its time).
// P and dS are rounded to bf16 before their products (the TPU kernel takes
// them in fp32). Nothing is padded on the host.
//
// K4a: K1's loop with the P V product taken out, on the same building
// blocks (hopper.cuh). One warpgroup a block owns 64 query rows of one head
// (grid: q tiles, heads, batch; under the causal mask block_of_grid's
// order, the last q tile, which meets every key tile, first). Q comes once
// and the 64-key K tiles into two slots by TMA; S = Q K^T by wgmma
// m64n64k16 from shared memory into registers (32 fp32 a thread: rows r0
// and r0 + 8, 16 keys each). Per tile, only a tile on an edge (lens[b],
// the sequence end, the diagonal) tests each pair; the row max is the
// thread's 16 values and two quad shuffles; the exponential takes
// s * scale * log2 e - m in one FFMA and MUFU.EX2; each thread keeps its
// own running sum, reduced over the quad once, and lse = (m + log2 l) ln 2.
// No score tile touches shared memory. At D=64 it does one exponential
// for each 2 * D = 128 FLOPs of QK^T, so the special-function units (16
// ex2 a clock an SM) and not the tensor cores bound it; a block takes
// 25,624 B at D=64 and 50,200 B at D=128, so several blocks share an SM
// and one's wgmma overlaps another's exponentials.
//
// Not yet done (later work): a producer warp with setmaxnreg and two
// consumer warpgroups taking turns (so that one's exp overlaps the other's
// wgmma), the B=1 split above, and K4a's removal by saving lse in the
// forward.

#include "hopper.cuh"  // TMA, mbarriers, wgmma and the tiles' layout, shared with K1/K2

namespace {

// ---------------------------------------------------------------- K4a ----

template <int D>
struct LseLayout {
  static constexpr int tile = Tile<D>::bytes;
  static constexpr int q = 0;
  static constexpr int k0 = q + tile;          // K tile t in slot t % 2
  static constexpr int bars = k0 + 2 * tile;   // Q, then one a K slot
  static constexpr int bytes = bars + 3 * 8 + 1024;
};

// q and k are read through TMA maps (tensor_map in hopper.cuh).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 6 : 4)
lse_kernel(const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
           const int* __restrict__ lens, float* __restrict__ lse, int sq, int sk,
           int group, float scale) {
  using L = LseLayout<D>;
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

  int kv_end = len;
  if (CAUSAL) kv_end = min(kv_end, q0 + BQ);
  const int n_tiles = max((kv_end + BK - 1) / BK, 1);

  auto k_bar = [&](int t) { return bar + 8 * (1 + (t & 1)); };
  auto issue_k = [&](int t) {  // by one thread
    mbar_expect(k_bar(t), L::tile);
    tma_tile<D>(base + L::k0 + (t & 1) * L::tile, k, t * BK, kvh, b, k_bar(t));
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar, L::tile);
    tma_tile<D>(base + L::q, q, q0, h, b, bar);
    issue_k(0);
  }

  // this lane's rows of the block's tile: r0 and r0 + 8. Scores stay raw
  // (q.k) until the exponential, which takes s * scale * log2 e - m in one
  // FFMA; m is the running row max in log2 units. A masked key's raw score
  // is set so that it reads MASKED (natural units) there, as in the TPU
  // kernel; a key past the sequence reads -inf.
  const int r0 = warp * 16 + lane / 4;
  const float to_log2 = scale * 1.4426950408889634f;  // scale * log2(e)
  const float masked_raw = MASKED / scale;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's columns only
  mbar_wait(bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (threadIdx.x == 0 && t + 1 < n_tiles) issue_k(t + 1);
    const int k0 = t * BK;
    mbar_wait(k_bar(t), (t >> 1) & 1);
    float s[8][4];
    zero(s);  // before the fence: wgmma then reads what these wrote
    wgmma_fence();
    scores<D>(s, base + L::q, base + L::k0 + (t & 1) * L::tile);  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    __syncthreads();  // every warp's wgmma has read this slot: it may refill
    if (k0 + BK > len || (CAUSAL && k0 + BK - 1 > q0)) {  // an edge tile
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
          if (key >= sk) s[j][e] = -INFINITY;  // past the sequence: not a key at all
          else if (key >= len || (CAUSAL && key > q0 + r0 + 8 * (e >> 1)))
            s[j][e] = masked_raw;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the quad's four threads hold a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_run[i], mx[i] * to_log2);
      l_run[i] *= exp2_approx(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l_run[e >> 1] += exp2_approx(fmaf(s[j][e], to_log2, -m_new[e >> 1]));
  }

  // lse = (m + log2 l) ln 2, in natural-log units, as K4b and K4c read it
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = q0 + r0 + 8 * i;
    if (qi < sq && lane % 4 == 0)
      lse[((long long)b * gridDim.y + h) * sq + qi] =
          (m_run[i] + log2f(fmaxf(l, 1e-30f))) * 0.6931471805599453f;
  }
}

// ------------------------------------------------ K4c: cp.async helpers ----

// 4 bytes from global to shared memory, asynchronously; zero-filled when
// !ok (src is then any valid address and is not read).
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed cp.async groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- K4b ----

template <int D>
struct DqLayout {
  static constexpr int tile = Tile<D>::bytes;
  static constexpr int q = 0;
  static constexpr int dout = q + tile;
  static constexpr int stage0 = dout + tile;  // stage s: K at +0, V at +tile
  static constexpr int stage = 2 * tile;
  static constexpr int bars = stage0 + 2 * stage;  // Q/dO, then one a stage
  static constexpr int bytes = bars + 3 * 8 + 1024;
};

// q, k, v and dO are read through TMA maps (tensor_map below).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 2)
dq_kernel(const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
          const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap dout,
          const float* __restrict__ lse, const float* __restrict__ dd,
          const int* __restrict__ lens, bf16* __restrict__ dq, int sq, int sk,
          int group, float scale, Strides dqs) {
  using L = DqLayout<D>;
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

  int kv_end = len;
  if (CAUSAL) kv_end = min(kv_end, q0 + BQ);
  const int n_tiles = max((kv_end + BK - 1) / BK, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {  // K/V tile t into stage t % 2, by one thread
    const unsigned st = base + L::stage0 + (t & 1) * L::stage;
    const unsigned full = bar + 8 * (1 + (t & 1));
    mbar_expect(full, 2 * L::tile);
    tma_tile<D>(st, k, t * BK, kvh, b, full);
    tma_tile<D>(st + L::tile, v, t * BK, kvh, b, full);
  };
  if (threadIdx.x == 0) {
    mbar_expect(bar, 2 * L::tile);
    tma_tile<D>(base + L::q, q, q0, h, b, bar);
    tma_tile<D>(base + L::dout, dout, q0, h, b, bar);
    if (n_tiles > 0) issue(0);
  }

  // this lane's rows of the block's tile: r0 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    const long long stat = ((long long)b * gridDim.y + h) * sq + qi;
    lse_r[i] = qi < sq ? lse[stat] : 0.f;
    dd_r[i] = qi < sq ? dd[stat] : 0.f;
  }

  float acc[D / 8][4];
  zero(acc);
  mbar_wait(bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (threadIdx.x == 0 && t + 1 < n_tiles) issue(t + 1);
    mbar_wait(bar + 8 * (1 + (t & 1)), (t >> 1) & 1);
    const int k0 = t * BK;
    const unsigned sK = base + L::stage0 + (t & 1) * L::stage;
    const unsigned sV = sK + L::tile;
    float s[8][4], dp[8][4];
    zero(s);  // before the fence: wgmma then reads what these wrote
    zero(dp);
    wgmma_fence();
    scores<D>(s, base + L::q, sK);      // S
    wgmma_commit();
    scores<D>(dp, base + L::dout, sV);  // dP, in flight while P is formed
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    const bool edge = k0 + BK > len || (CAUSAL && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = __expf(s[j][e] * scale - lse_r[i]);
        if (edge) {
          const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
          if (key >= len || (CAUSAL && key > q0 + r0 + 8 * i)) p = 0.f;
        }
        s[j][e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dd_r[e >> 1]);  // dS
    unsigned ds[4][4];
    to_operand(ds, dp);
    wgmma_fence();
    accumulate<D>(acc, ds, sK);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with this stage
  }

  store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.s, acc, q0 + r0, sq, lane,
                scale, scale);
}

// ---------------------------------------------------------------- K4c ----

template <int D>
struct DkvLayout {
  static constexpr int tile = Tile<D>::bytes;
  static constexpr int k = 0;
  static constexpr int v = k + tile;
  static constexpr int stage0 = v + tile;  // stage s: Q at +0, dO at +tile
  static constexpr int stage = 2 * tile;
  static constexpr int stats0 = stage0 + 2 * stage;  // stage s: lse, dd (BQ fp32 each)
  static constexpr int stats = 2 * BQ * 4;
  static constexpr int bars = stats0 + 2 * stats;  // K/V, then one a stage
  static constexpr int bytes = bars + 3 * 8 + 1024;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 2)
dkv_kernel(const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
           const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap dout,
           const float* __restrict__ lse, const float* __restrict__ dd,
           const int* __restrict__ lens, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int h, int sq, int sk, int group,
           float scale, Strides dks, Strides dvs) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned base = aligned_smem(smem);
  const unsigned bar = base + L::bars;
  const float* stats = reinterpret_cast<const float*>(smem + (base - smem_addr(smem)) + L::stats0);

  const Block blk = block_of_grid<CAUSAL, false>();
  const int k0 = blk.tile * BK;
  const int kvh = blk.head;
  const int b = blk.b;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lens[b], sk);
  bf16* dkb = dk + b * dks.b + kvh * dks.h;
  bf16* dvb = dv + b * dvs.b + kvh * dvs.h;

  if (k0 >= len) {  // every key of the tile is masked: dk = dv = 0
    constexpr int PER_ROW = D / 8;
    for (int i = threadIdx.x; i < 64 * PER_ROW; i += NTHREADS) {
      const int key = k0 + i / PER_ROW;
      const int c = (i % PER_ROW) * 8;
      if (key < sk) {
        *reinterpret_cast<uint4*>(dkb + (long long)key * dks.s + c) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dvb + (long long)key * dvs.s + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  const int q_first = CAUSAL ? k0 / BQ : 0;  // q tiles before it see no key here
  const int n_qt = max((sq + BQ - 1) / BQ - q_first, 0);
  const int n_iter = group * n_qt;  // (q head of the group, q tile) pairs

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the Q, dO, lse and dd tiles of step `it` into stage it % 2: Q and dO
  // by TMA from thread 0, lse and dd by cp.async, one value a thread
  auto issue = [&](int it) {
    const int hq = kvh * group + it / n_qt;
    const int q0 = (q_first + it % n_qt) * BQ;
    if (threadIdx.x == 0) {
      const unsigned st = base + L::stage0 + (it & 1) * L::stage;
      const unsigned full = bar + 8 * (1 + (it & 1));
      mbar_expect(full, 2 * L::tile);
      tma_tile<D>(st, q, q0, hq, b, full);
      tma_tile<D>(st + L::tile, dout, q0, hq, b, full);
    }
    if (threadIdx.x < 2 * BQ) {
      const int i = threadIdx.x % BQ;
      const float* src = (threadIdx.x < BQ ? lse : dd) + ((long long)b * h + hq) * sq;
      const bool ok = q0 + i < sq;
      cp_async4(base + L::stats0 + (it & 1) * L::stats + threadIdx.x * 4,
                ok ? src + q0 + i : src, ok);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect(bar, 2 * L::tile);
    tma_tile<D>(base + L::k, k, k0, kvh, b, bar);
    tma_tile<D>(base + L::v, v, k0, kvh, b, bar);
  }
  if (n_iter > 0) issue(0);
  cp_async_commit();
  mbar_wait(bar, 0);

  // this lane's key rows of the tile: r0 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    mbar_wait(bar + 8 * (1 + (it & 1)), (it >> 1) & 1);
    __syncthreads();  // every thread's lse and dd value is in
    const int q0 = (q_first + it % n_qt) * BQ;
    const unsigned sQ = base + L::stage0 + (it & 1) * L::stage;
    const unsigned sO = sQ + L::tile;
    const float* sL = stats + (it & 1) * (L::stats / 4);
    const float* sD = sL + BQ;
    float s[8][4], dp[8][4];
    zero(s);  // before the fence: wgmma then reads what these wrote
    zero(dp);
    wgmma_fence();
    scores<D>(s, base + L::k, sQ);   // S^T
    wgmma_commit();
    scores<D>(dp, base + L::v, sO);  // dP^T, in flight while P^T is formed
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    const bool edge = k0 + BK > len || q0 + BQ > sq || (CAUSAL && q0 < k0 + BK);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + (lane % 4) * 2 + (e & 1);
        float p = __expf(s[j][e] * scale - sL[c]);
        if (edge) {
          const int key = k0 + r0 + 8 * (e >> 1);
          const int qi = q0 + c;
          if (key >= len || qi >= sq || (CAUSAL && key > qi)) p = 0.f;
        }
        s[j][e] = p;  // P^T
      }
    }
    unsigned pa[4][4], da[4][4];
    to_operand(pa, s);
    wgmma_fence();
    accumulate<D>(dv_acc, pa, sO);  // dV += P^T dO, in flight while dS^T is formed
    wgmma_commit();
    wgmma_wait<1>();  // dP^T
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + (lane % 4) * 2 + (e & 1);
        dp[j][e] = s[j][e] * (dp[j][e] - sD[c]);  // dS^T
      }
    }
    to_operand(da, dp);
    wgmma_fence();
    accumulate<D>(dk_acc, da, sQ);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // every warp is done with this stage
  }

  store_rows<D>(dkb, dks.s, dk_acc, k0 + r0, sk, lane, scale, scale);
  store_rows<D>(dvb, dvs.s, dv_acc, k0 + r0, sk, lane, 1.f, 1.f);
}

// --------------------------------------------------------------- launch ----

// The TMA maps of q, k, v and dO (strides in that order in `st`).
int qkvo_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
              const void* dout, int b, int h, int hkv, int sq, int sk, int d,
              const long long* st) {
  int err = tensor_map(&maps[0], q, b, sq, h, d, strides(st, 0));
  if (!err) err = tensor_map(&maps[1], k, b, sk, hkv, d, strides(st, 1));
  if (!err) err = tensor_map(&maps[2], v, b, sk, hkv, d, strides(st, 2));
  if (!err) err = tensor_map(&maps[3], dout, b, sq, h, d, strides(st, 3));
  return err;
}

template <int D, bool CAUSAL>
int launch_lse(const void* q, const void* k, const int* lens, void* lse,
               int b, int h, int hkv, int sq, int sk, float scale,
               const long long* st, cudaStream_t stream) {
  auto kern = lse_kernel<D, CAUSAL>;
  const size_t smem = LseLayout<D>::bytes;
  int err = prepare(kern, smem);
  CUtensorMap maps[2];
  if (!err) err = tensor_map(&maps[0], q, b, sq, h, D, strides(st, 0));
  if (!err) err = tensor_map(&maps[1], k, b, sk, hkv, D, strides(st, 1));
  if (err) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, NTHREADS, smem, stream>>>(maps[0], maps[1], lens,
                                         static_cast<float*>(lse), sq, sk,
                                         h / hkv, scale);
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
  CUtensorMap maps[4];
  if (!err) err = qkvo_maps(maps, q, k, v, dout, b, h, hkv, sq, sk, D, st);
  if (err) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, NTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(dd), lens, static_cast<bf16*>(dq), sq, sk,
      h / hkv, scale, strides(st, 4));
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
  CUtensorMap maps[4];
  if (!err) err = qkvo_maps(maps, q, k, v, dout, b, h, hkv, sq, sk, D, st);
  if (err) return err;
  dim3 grid((sk + BK - 1) / BK, hkv, b);
  kern<<<grid, NTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(dd), lens, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), h, sq, sk, h / hkv, scale, strides(st, 4),
      strides(st, 5));
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