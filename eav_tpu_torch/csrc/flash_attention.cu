// Flash attention for Hopper (sm_90a): forward (K1), dK/dV (K2), dQ (K3) and
// the one-pass forward (K5).
//
// These replace the three Pallas TPU kernels of eav_tpu/ops/pallas/attention.py
// and the one of scripts/flash_onepass_experiment.py:
//   K1 eav_flash_fwd     <- _flash_kernel   (attention.py:73)
//   K2 eav_flash_dkv     <- _dkv_kernel     (attention.py:113)
//   K3 eav_flash_dq      <- _dq_kernel      (attention.py:158)
//   K5 eav_flash_onepass <- _onepass_kernel (flash_onepass_experiment.py:25),
//      described at its kernels below.
//
// Operands are head-major (BH, T_pad, D), row-major and contiguous, in float32
// or bfloat16. Keys at or beyond t_real are masked by adding -1e30 to their
// scores, so exp() gives exactly 0 and no NaN appears. K1-K3 also have a
// causal mode (the template parameter CAUSAL, chosen by the launchers' causal
// flag; the non-causal instantiation is the code without it): query i sees
// keys j <= i only. A block skips the key (or query) tiles that lie wholly
// on the masked side of the diagonal and masks the scores of the tile that
// straddles it; the 64-row query and key tiles line up, so one tile a block
// straddles it. The causal K1 and K3 run their query tiles in reverse order
// (blockIdx.x 0 takes the last, which sees every key), so the longest blocks
// start first; K2's longest already do. All products accumulate
// in float32, and the softmax state (m, l, lse) is float32. The rounding points
// of the TPU kernels are kept: P is rounded to V's type before P.V and dS to
// Q's type before dS.K and dS^T.Q.
//
// What bounds them on the H100: at the AST shape (BH 96, T 1214, D 64) each
// kernel does 4-8 T^2 D BH = 3.6e10-7.2e10 FLOP (K1 4, K2 8, K3 6) on 60-90
// MB of operands, so the bound is operations, far above the card's ~295
// FLOP/byte ridge, and the (T, T) scores never leave the SM. The TPU's
// sequential grid axis (the inner loop over K or Q blocks) becomes a loop
// inside each block, so blocks are independent and no atomics are needed
// (dQ stays its own kernel, K3, so it is deterministic). Two designs:
//
// - bfloat16, all four kernels: wgmma.mma_async products, FlashAttention-3
//   style, described at the kernels below. Tiles stream through a cp.async
//   ring while the current one is multiplied; they sit in wgmma's canonical
//   swizzled layout, read through descriptors, and the transpose bit of the
//   bf16 wgmma reads a row-major tile as the MN-major operand, so nothing is
//   stored transposed; one warpgroup issues 64-row products, and the scores
//   stay in its registers as the A operand of the next product.
// - float32: FMA from shared-memory tiles (tensor cores would mean TF32 and
//   lose float32's precision). A 64x64 tile per block, 256 threads as a
//   16x16 grid; thread (ty, tx) owns rows ty+16i and columns tx+16j.
//
// Each extern "C" launcher takes raw pointers, sizes and a CUDA stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;  // the key mask: exp(s - 1e30 - m) is exactly 0

// ===========================================================================
// float32: FMA kernels from shared-memory tiles
// ===========================================================================

constexpr int BLOCK = 64;       // rows of a Q or K/V tile
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int PLD = BLOCK + 1;  // padded row stride of a (BLOCK, BLOCK) tile

// max / sum over the 16 lanes that share a ty (lanes tx = 0..15 of a half warp)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows row0 .. row0+ROWS-1 of a (t_pad, D) matrix into shared memory with
// row stride D + 1; rows at or past t_pad read as zero.
template <int D, int ROWS = BLOCK>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int t_pad) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < t_pad ? src[static_cast<size_t>(row) * D + c] : 0.f;
  }
}

// Row statistics (lse, di) of rows row0 .. row0+BLOCK-1 into shared memory.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int t_pad) {
  for (int r = threadIdx.x; r < BLOCK; r += THREADS) {
    const int row = row0 + r;
    dst[r] = row < t_pad ? src[row] : 0.f;
  }
}

// acc[i][j] += sum_d A[ty+16i][d] * B[tx+16j][d] for i < MI rows of A and
// j < 4 rows of B, both row-major with stride D + 1.
template <int D, int MI>
__device__ __forceinline__ void tile_dot(float (&acc)[MI][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[MI], b[4];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K1: forward. Block (q tile, bh); loops over the K/V tiles that hold real
// keys, carrying the online-softmax state m, l and the output accumulator.
// ---------------------------------------------------------------------------
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int t_pad, int t_real, float scale) {
  constexpr int LD = D + 1;
  constexpr int CJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BLOCK * LD;
  float* Vs = Ks + BLOCK * LD;
  float* Ps = Vs + BLOCK * LD;

  const int bh = blockIdx.y;
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BLOCK;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D>(Qs, q + base, q0, t_pad);

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  // tiles wholly past t_real (or, causal, past the diagonal) would change
  // nothing (p = 0, alpha = 1)
  const int nk_real = (t_real + BLOCK - 1) / BLOCK;
  const int nk = CAUSAL ? min(nk_real, qt + 1) : nk_real;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BLOCK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    load_tile<D>(Ks, k + base, k0, t_pad);
    load_tile<D>(Vs, v + base, k0, t_pad);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<D>(s, Qs, Ks, ty, tx);

    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = (k0 + tx + 16 * j < t_real) ? 0.f : NEG_INF;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rowmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = scale * s[i][j] + bias[j];
        if (CAUSAL && k0 + tx + 16 * j > q0 + ty + 16 * i) s[i][j] = NEG_INF;
        rowmax = fmaxf(rowmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(rowmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BLOCK; ++kk) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_pad) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      o[base + static_cast<size_t>(row) * D + tx + 16 * c] = acc[i][c] / l_safe;
    if (tx == 0) lse[static_cast<size_t>(bh) * t_pad + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// K2: dK and dV. Block (k tile, bh); loops over all Q tiles.
//   P = exp(S - lse), dV += P^T dO, dP = dO V^T, dS = P (dP - di),
//   dK += scale dS^T Q
// ---------------------------------------------------------------------------
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              float* __restrict__ dk, float* __restrict__ dv, int t_pad, int t_real,
              float scale) {
  constexpr int LD = D + 1;
  constexpr int CJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BLOCK * LD;
  float* Qs = Vs + BLOCK * LD;
  float* dOs = Qs + BLOCK * LD;
  float* Ps = dOs + BLOCK * LD;
  float* dSs = Ps + BLOCK * PLD;
  float* Ls = dSs + BLOCK * PLD;
  float* Dis = Ls + BLOCK;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BLOCK;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * t_pad;
  const float* di_bh = di + static_cast<size_t>(bh) * t_pad;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D>(Ks, k + base, k0, t_pad);
  load_tile<D>(Vs, v + base, k0, t_pad);

  float bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bias[j] = (k0 + tx + 16 * j < t_real) ? 0.f : NEG_INF;

  float dk_acc[4][CJ], dv_acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (t_pad + BLOCK - 1) / BLOCK;
  // causal: the query tiles from this key tile's own on
  for (int qt = CAUSAL ? blockIdx.x : 0; qt < nq; ++qt) {
    const int q0 = qt * BLOCK;
    __syncthreads();
    load_tile<D>(Qs, q + base, q0, t_pad);
    load_tile<D>(dOs, dout + base, q0, t_pad);
    load_rows(Ls, lse_bh, q0, t_pad);
    load_rows(Dis, di_bh, q0, t_pad);
    __syncthreads();

    // scores and dP in [query][key] orientation
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool valid = q0 + r < t_pad;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool seen = !CAUSAL || k0 + tx + 16 * j <= q0 + r;
        const float p = valid && seen ? expf(scale * s[i][j] + bias[j] - Ls[r]) : 0.f;
        const float ds = p * (dp[i][j] - Dis[r]);
        Ps[r * PLD + tx + 16 * j] = p;
        dSs[r * PLD + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    // this thread's dK/dV rows are keys ty+16i
#pragma unroll 4
    for (int qq = 0; qq < BLOCK; ++qq) {
      float pk[4], sk[4], go[CJ], qv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = Ps[qq * PLD + ty + 16 * i];
        sk[i] = dSs[qq * PLD + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        go[c] = dOs[qq * LD + tx + 16 * c];
        qv[c] = Qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          dv_acc[i][c] = fmaf(pk[i], go[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sk[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= t_pad) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const size_t at = base + static_cast<size_t>(row) * D + tx + 16 * c;
      dk[at] = scale * dk_acc[i][c];
      dv[at] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dQ. Block (q tile, bh); loops over the K/V tiles that hold real keys
// (the others give dS = 0). dQ += scale dS K.
// ---------------------------------------------------------------------------
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             float* __restrict__ dq, int t_pad, int t_real, float scale) {
  constexpr int LD = D + 1;
  constexpr int CJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BLOCK * LD;
  float* Ks = dOs + BLOCK * LD;
  float* Vs = Ks + BLOCK * LD;
  float* dSs = Vs + BLOCK * LD;
  float* Ls = dSs + BLOCK * PLD;
  float* Dis = Ls + BLOCK;

  const int bh = blockIdx.y;
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BLOCK;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D>(Qs, q + base, q0, t_pad);
  load_tile<D>(dOs, dout + base, q0, t_pad);
  load_rows(Ls, lse + static_cast<size_t>(bh) * t_pad, q0, t_pad);
  load_rows(Dis, di + static_cast<size_t>(bh) * t_pad, q0, t_pad);

  float dq_acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dq_acc[i][c] = 0.f;

  const int nk_real = (t_real + BLOCK - 1) / BLOCK;
  const int nk = CAUSAL ? min(nk_real, qt + 1) : nk_real;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BLOCK;
    __syncthreads();
    load_tile<D>(Ks, k + base, k0, t_pad);
    load_tile<D>(Vs, v + base, k0, t_pad);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = (k0 + tx + 16 * j < t_real) ? 0.f : NEG_INF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool valid = q0 + r < t_pad;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool seen = !CAUSAL || k0 + tx + 16 * j <= q0 + r;
        const float p = valid && seen ? expf(scale * s[i][j] + bias[j] - Ls[r]) : 0.f;
        dSs[r * PLD + tx + 16 * j] = p * (dp[i][j] - Dis[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BLOCK; ++kk) {
      float sv[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) dq_acc[i][c] = fmaf(sv[i], kv[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_pad) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      dq[base + static_cast<size_t>(row) * D + tx + 16 * c] = scale * dq_acc[i][c];
  }
}

// ===========================================================================
// bfloat16: register and copy helpers
// ===========================================================================
//
// A wgmma accumulator of 64 rows is, per warp, the C fragment layout of
// mma.m16n8k16 stacked over the four warps (lane = 4 g + c: warp w holds
// rows 16w + g and 16w + g + 8, columns 8j + 2c and 8j + 2c + 1 of each
// 8-column tile j). The C fragments of two adjacent 8-column tiles, rounded
// to bf16 in pairs, are exactly the register A fragment of one 16-deep step,
// which is how scores feed the next product.

typedef __nv_bfloat16 bf16;

// two floats rounded to bf16 (round to nearest even) in one register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Row results of a warp's (16 x D) accumulator, times `mul[r]` for rows g
// and g+8, to rows row0 + g (+8) of a (t_pad, D) bf16 matrix.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int row0,
                                           int t_pad, const float (&mul)[2]) {
  const int g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= t_pad) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row) * D + dt * 8 + 2 * c) =
          pack_bf16(acc[dt][2 * r] * mul[r], acc[dt][2 * r + 1] * mul[r]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without passing through registers;
// with valid false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
// The same for 4 bytes (one float).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ===========================================================================
// bfloat16 (K1, K2, K3, K5): wgmma from swizzled shared memory
// ===========================================================================
//
// One consumer warpgroup (4 warps, 128 threads) per block owns 64 rows: keys
// in K2, queries in K1, K3 and K5. Every product is a wgmma.mma_async
// m64nNk16 with f32 accumulators; the accumulator's per-warp layout is that
// of mma.m16n8k16's C, stacked over the four warps (warp w holds rows
// 16w..16w+15), so the scores rounded to bf16 are directly the register A
// operand of the next product:
//   K1, K5: S = Q K^T (both K-major), P in registers, O += P V (V read
//       MN-major through wgmma's transpose bit);
//   K3: S = Q K^T, dP = dO V^T (A and B from shared memory, both K-major),
//       dS = P (dP - di) in registers, dQ += dS K (A from registers, B = the
//       K tile read MN-major through wgmma's transpose bit);
//   K2: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T in registers,
//       dV += P^T dO and dK += dS^T Q (dO and Q tiles read MN-major).
// No operand is stored transposed: one row-major tile serves both as a
// K-major operand (its D columns as the contraction) and as an MN-major one
// (its rows as the contraction).
//
// Tiles are in wgmma's canonical swizzled layout (the SwzTile note below)
// and stream through a ring of cp.async stages, 16 bytes a copy, written
// straight to their swizzled addresses: the next tiles land while the
// current one is multiplied. Per step the backward's warpgroup issues the
// two first products as two commit groups, turns S into P as soon as the
// first group is done (while dP still runs), starts the P product, turns dP
// into dS and starts the dS product, then waits for both before the ring
// slot is reused. The forwards' schedule is described at FwdPlan.

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int WG_ROWS = 64;      // rows a warpgroup owns (wgmma's M)

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units) and the swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | mode << 62;
}

// An (R, D) bf16 tile in wgmma's canonical swizzled layout. A row's 2D bytes
// are cut into column blocks of SW = min(2D, 128) bytes (one block below
// D 128, two at D 128); each block holds all R rows at SW bytes a row, and
// the 16-byte chunks of row r are permuted by the SW-byte swizzle, the
// address bits [4, 4 + log2(SW / 16)) XORed with bits [7, ...) (so at SW 128
// chunk c of row r sits at c ^ (r % 8)). Blocks start on 1024-byte
// boundaries, so the pattern is that of the absolute address, as the
// hardware applies it. The same tile is read
// - K-major, the 16 columns 16ks.. of all rows as one k-step: start at that
//   column's byte in its block, 8-row groups SBO = 8 SW apart;
// - MN-major, the rows 16ks.. as one k-step and all D columns as N: start
//   at row 16ks, column blocks LBO = R SW apart, 8-row groups SBO = 8 SW.
template <int R, int D>
struct SwzTile {
  static constexpr int SW = 2 * D < 128 ? 2 * D : 128;
  static constexpr int BLOCK_BYTES = R * SW;
  static constexpr int BYTES = R * D * 2;
  static constexpr uint64_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static_assert(BLOCK_BYTES % 1024 == 0, "column blocks must keep 1024-byte alignment");

  // byte offset of the 16-byte chunk ch (columns 8ch..8ch+7) of row r
  static __device__ __forceinline__ int offset(int r, int ch) {
    constexpr int CPR = SW / 16;  // chunks per row of a column block
    const int o = r * SW + (ch % CPR) * 16;
    return (ch / CPR) * BLOCK_BYTES + (o ^ ((o >> 3) & ((CPR - 1) << 4)));
  }
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int ks) {
    const int byte = ks * 32;
    return smem_desc(base + (byte / SW) * BLOCK_BYTES + byte % SW, 16, 8 * SW, MODE);
  }
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int ks) {
    return smem_desc(base + ks * 16 * SW, BLOCK_BYTES, 8 * SW, MODE);
  }
};

// Rows row0 .. row0+R-1 of a (t_pad, D) bf16 matrix into a SwzTile by
// cp.async; rows at or past t_pad are zero-filled. The blocks are one
// warpgroup, so threadIdx.x % WG_THREADS is threadIdx.x: written so, the
// compiler knows the start is below 128 and the trip count exact. At the
// AST shape on an H100 (80GB HBM3, 700 W) a loop from threadIdx.x took 29%
// longer for K1, 35% for K5 and 15% for K2 + K3, and a fully unrolled loop
// of fixed count 16% longer for K2 + K3, whose swizzled addresses it holds
// in registers (K2 at 183 instead of 165: two blocks an SM instead of
// three); eav_tpu_torch/scripts/flash_variants.py measures both.
template <int R, int D>
__device__ __forceinline__ void issue_swz(unsigned char* dst, const bf16* __restrict__ src,
                                          int row0, int t_pad) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x % WG_THREADS; e < R * CH; e += WG_THREADS) {
    const int r = e / CH, ch = e % CH;
    const bool ok = row0 + r < t_pad;
    cp_async16(dst + SwzTile<R, D>::offset(r, ch),
               src + static_cast<size_t>(ok ? row0 + r : 0) * D + ch * 8, ok);
  }
}

// Entries row0 .. row0+R-1 of the (t_pad,) rows of lse and di by 4-byte
// cp.async (a head's rows are only 4-byte aligned); past t_pad they are 0.
template <int R>
__device__ __forceinline__ void issue_stats(float* ls, float* dis, const float* __restrict__ lse,
                                            const float* __restrict__ di, int row0, int t_pad) {
  for (int e = threadIdx.x; e < 2 * R; e += WG_THREADS) {
    const int i = e % R;
    const bool ok = row0 + i < t_pad;
    cp_async4((e < R ? ls : dis) + i, (e < R ? lse : di) + (ok ? row0 + i : 0), ok);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes are generic-proxy writes; wgmma reads through the async
// proxy, so each thread fences its landed copies before the block barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins register accesses to their place among the wgmma fence / wait
// instructions: the compiler may not move a read of an accumulator above
// the wait that completes it, nor a write of an operand below the fence;
// pinning a register A operand after the wait keeps its registers from
// being reused while the product still reads them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate (acc 0: D = A B, else
// D += A B). ss: A and B by descriptor, both K-major. rs: A from registers
// (this warp's 16-row m16n8k16 A fragment), B by descriptor, MN-major (the
// transpose bit set).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void rs(float (&d)[2][4], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[4][4], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[8][4], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[16][4], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
// acc (64 x N) = A . B^T, A a (64, D) tile and B an (N, D) tile, both
// contracted over D: S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T.
template <int N, int D>
__device__ __forceinline__ void wg_abt(float (&acc)[N / 8][4], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    Wgmma<N>::ss(acc, SwzTile<WG_ROWS, D>::kmajor(a, ks), SwzTile<N, D>::kmajor(b, ks), ks);
}

// acc (64 x D) += P . B, P (64 x 16 KS) in register A fragments and B an
// (16 KS, D) tile contracted over its rows: dQ += dS K, dV += P^T dO,
// dK += dS^T Q.
template <int D, int KS>
__device__ __forceinline__ void wg_av(float (&acc)[D / 8][4], const uint32_t (&pa)[KS][4],
                                      uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    Wgmma<D>::rs(acc, pa[ks], SwzTile<16 * KS, D>::mnmajor(b, ks), 1);
}

// The accumulator of a (64 x 16 KS) product rounded to bf16 as the A
// fragments of the next: 8-column tiles 2ks and 2ks + 1 make k-step ks.
template <int KS>
__device__ __forceinline__ void to_a(uint32_t (&a)[KS][4], const float (&x)[2 * KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    a[ks][0] = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
    a[ks][1] = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
    a[ks][2] = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// The bf16 forwards, K1 and K5: one warpgroup owns 64 query rows; K and V
// tiles of FWD_BK = 64 keys stream through a ring of cp.async stages, a
// stage holding a K tile, then a V tile, refilled one step after its own, so
// the ring loads STAGES - 1 steps ahead. The scores stay in registers: the S
// accumulator (32 f32 a thread) becomes P in place and, rounded to bf16, the
// register A operand of P V. Each tile's two products are waited for in
// turn: three blocks share an SM and overlap one block's softmax with
// another's products.
// ---------------------------------------------------------------------------
constexpr int FWD_BK = 64;
template <int D>
struct FwdPlan {
  static constexpr int QBYTES = SwzTile<WG_ROWS, D>::BYTES, KBYTES = SwzTile<FWD_BK, D>::BYTES;
  // 4 stages for K1 and 3 for K5 (one less at D 128): 72 and 57 KB with the
  // Q tile at D 64, so three blocks share an SM (two at D 128). On the H100
  // K1 took 6% longer with 3 stages, K5 7% longer with 4
  // (eav_tpu_torch/scripts/flash_variants.py).
  static constexpr int K1_STAGES = D == 128 ? 3 : 4, K5_STAGES = D == 128 ? 2 : 3;
  static constexpr size_t smem(int stages) { return 1024 + QBYTES + stages * 2 * KBYTES; }
};

// Key tile kt of K, and with with_v of V after it, into a ring stage.
template <int D>
__device__ __forceinline__ void issue_kv(unsigned char* stage, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, int kt, int t_pad,
                                         bool with_v) {
  issue_swz<FWD_BK, D>(stage, k, kt * FWD_BK, t_pad);
  if (with_v) issue_swz<FWD_BK, D>(stage + FwdPlan<D>::KBYTES, v, kt * FWD_BK, t_pad);
}

// s = Q K^T for the key tile at k0 (raw dot products), waited for; the keys
// at or past t_real set to -1e30 (only the last tile holds such keys).
template <int D>
__device__ __forceinline__ void fwd_scores(float (&s)[FWD_BK / 8][4], uint32_t q_sm,
                                           uint32_t k_sm, int k0, int t_real) {
  wgmma_fence();
  wg_abt<FWD_BK, D>(s, q_sm, k_sm);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  if (k0 + FWD_BK <= t_real) return;
  const int c = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < FWD_BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k0 + 8 * j + 2 * c + (i & 1) >= t_real) s[j][i] = NEG_INF;
}

// The causal diagonal tile (query tile q0, key tile k0 == q0): the keys past
// each of this thread's query rows set to -1e30. Every row keeps its own key,
// so its max stays finite.
static_assert(FWD_BK == WG_ROWS, "a causal query tile straddles one key tile");
__device__ __forceinline__ void causal_mask(float (&s)[FWD_BK / 8][4], int q0, int k0) {
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < FWD_BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k0 + 8 * j + 2 * c + (i & 1) > q0 + 16 * w + g + 8 * (i >> 1)) s[j][i] = NEG_INF;
}

// acc += P V for one key tile, waited for (acc is rescaled next and the
// stage refilled): P (the f32 probabilities in p) rounded to V's type as the
// register A operand, the row-major V tile read MN-major.
template <int D>
__device__ __forceinline__ void fwd_pv(float (&acc)[D / 8][4], const float (&p)[FWD_BK / 8][4],
                                       uint32_t v_sm) {
  uint32_t pa[FWD_BK / 16][4];
  to_a(pa, p);
  pin(pa);
  pin(acc);
  wgmma_fence();
  wg_av<D, FWD_BK / 16>(acc, pa, v_sm);
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
  pin(pa);
}

// The ring of a forward kernel over `steps` steps: step i brings key tile
// i (i - nk past nk) into stage i % ST as cp.async group i, its V tile too
// in the last nk steps (all of K1's; K5's second sweep). Group 0 also holds
// the Q tile, issued before.
template <int D, int ST>
struct FwdRing {
  unsigned char* ring;
  const bf16* k;
  const bf16* v;
  int t_pad, nk, steps;

  __device__ __forceinline__ unsigned char* stage(int i) const {
    return ring + (i % ST) * 2 * FwdPlan<D>::KBYTES;
  }
  __device__ __forceinline__ void issue(int i) const {
    if (i < steps) issue_kv<D>(stage(i), k, v, i < nk ? i : i - nk, t_pad, i >= steps - nk);
    cp_async_commit();
  }
  __device__ __forceinline__ void start() const {
    for (int t = 0; t < ST - 1; ++t) issue(t);
  }
  // waits for step i's tiles, refills step i - 1's stage; step i's K tile
  __device__ __forceinline__ uint32_t advance(int i) const {
    cp_async_wait<ST - 2>();  // this thread's copies of step i have landed
    fence_async_smem();
    __syncthreads();  // everyone's have, and step i - 1's products are done
    issue(i + ST - 1);
    return smem_u32(stage(i));
  }
};

// Max over the quad of lanes that share rows g and g + 8.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The forwards' epilogue: l summed over the quad, O = acc / max(l, 1e-30)
// and LSE = m scale + log max(l, 1e-30) for this thread's rows of the tile
// at q0 (m the raw row max, so m scale is the scaled scores' max).
template <int D>
__device__ __forceinline__ void fwd_store(bf16* __restrict__ o, float* __restrict__ lse_bh,
                                          const float (&acc)[D / 8][4], const float (&m)[2],
                                          const float (&l)[2], int q0, int t_pad, float scale) {
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / l_safe;
    const int row = q0 + 16 * w + g + 8 * r;
    if (c == 0 && row < t_pad) lse_bh[row] = m[r] * scale + logf(l_safe);
  }
  store_rows<D>(o, acc, q0 + 16 * w, t_pad, inv);
}

// K1: replaces _flash_kernel (eav_tpu/ops/pallas/attention.py:73). Block
// (64-query tile, bh), the (ceil(t_pad / 64), BH) grid of K3: 19 x 96 = 1824
// blocks at the AST shape. K and V tiles stream over the keys below t_real
// (later tiles would give p = 0, alpha = 1). 4 T^2 D BH FLOP, bound by
// operations. Per tile: S = Q K^T, the online softmax in registers (each
// thread holds rows g and g + 8 of its warp's 16, row maxima over the quad,
// exp2 with scale log2(e) folded in), acc rescaled by alpha, then acc +=
// bf16(P) V. l is this thread's share of the row sum over the unrounded P
// (alpha is the same over the quad), summed over the quad at the end.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WG_THREADS)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                int t_pad, int t_real, float scale) {
  using P = FwdPlan<D>;
  constexpr int NT = FWD_BK / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, q0 = qt * WG_ROWS;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const int nk_real = (t_real + FWD_BK - 1) / FWD_BK;
  const int nk = CAUSAL ? min(nk_real, qt + 1) : nk_real;  // causal: up to the diagonal tile
  const FwdRing<D, P::K1_STAGES> ring{Qs + P::QBYTES, k + base, v + base, t_pad, nk, nk};

  issue_swz<WG_ROWS, D>(Qs, q + base, q0, t_pad);
  ring.start();
  const float scale2 = scale * LOG2E;
  const uint32_t q_sm = smem_u32(Qs);

  // m: the raw row max so far of rows g and g + 8; every tile holds a real
  // key, so m is finite after the first
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[D / 8][4];
  zero(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t k_sm = ring.advance(kt);
    float s[NT][4];
    fwd_scores<D>(s, q_sm, k_sm, kt * FWD_BK, t_real);
    if (CAUSAL && kt == qt) causal_mask(s, q0, kt * FWD_BK);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f((m[r] - mx[r]) * scale2);
      m[r] = mx[r];
      mb[r] = mx[r] * scale2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = exp2f(fmaf(s[j][i], scale2, -mb[i >> 1]));
        l[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dt][i] *= alpha[i >> 1];
    fwd_pv<D>(acc, s, k_sm + P::KBYTES);
  }
  fwd_store<D>(o + base, lse + static_cast<size_t>(bh) * t_pad, acc, m, l, q0, t_pad, scale);
}

// K3: replaces _dq_kernel (eav_tpu/ops/pallas/attention.py:158). Block
// (64-query tile, bh); the Q and dO tiles stay, K and V tiles stream over
// the keys below t_real (tiles past it give dS = 0). 6 T^2 D BH FLOP, bound
// by operations.
// Key tile DQ_BK = 64: the S and dP accumulators (2 x 32 f32) beside dQ's
// (D / 2) keep a thread at 110-128 registers (D 16-64). The ring has 3
// stages (2 at D 128, where a stage is 32 KB): 65 KB with Q and dO at D 64,
// so three blocks share an SM (two at D 128).
// Grid: 64-query tiles, (ceil(t_pad / 64), BH) blocks. At the AST shape that
// is 19 x 96 = 1824 blocks, 4.6 waves of 3 x 132; the last tile holds 62 of
// 64 rows. 128-row tiles would halve the blocks but leave the tail tile half
// empty (1280 rows for 1214) and fit one block per SM.
constexpr int DQ_BK = 64;
template <int D>
struct DqPlan {
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int QBYTES = SwzTile<WG_ROWS, D>::BYTES, KBYTES = SwzTile<DQ_BK, D>::BYTES;
  static constexpr size_t SMEM = 1024 + 2 * QBYTES + STAGES * 2 * KBYTES;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WG_THREADS)
flash_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               bf16* __restrict__ dq, int t_pad, int t_real, float scale) {
  using P = DqPlan<D>;
  constexpr int ST = P::STAGES, NT = DQ_BK / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + P::QBYTES;
  unsigned char* ring = dOs + P::QBYTES;  // stage s: K tile, then V tile

  static_assert(DQ_BK == WG_ROWS, "a causal query tile straddles one key tile");
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, q0 = qt * WG_ROWS;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const int nk_real = (t_real + DQ_BK - 1) / DQ_BK;
  const int nk = CAUSAL ? min(nk_real, qt + 1) : nk_real;  // causal: up to the diagonal tile

  issue_swz<WG_ROWS, D>(Qs, q + base, q0, t_pad);
  issue_swz<WG_ROWS, D>(dOs, dout + base, q0, t_pad);
  for (int t = 0; t < ST - 1; ++t) {  // group t: key tile t (group 0 also Q and dO)
    if (t < nk) {
      issue_swz<DQ_BK, D>(ring + t * 2 * P::KBYTES, k + base, t * DQ_BK, t_pad);
      issue_swz<DQ_BK, D>(ring + t * 2 * P::KBYTES + P::KBYTES, v + base, t * DQ_BK, t_pad);
    }
    cp_async_commit();
  }
  // this thread's rows: 16w + g and 16w + g + 8
  float lse2[2], di_row[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * w + g + 8 * r;
    valid[r] = row < t_pad;
    const size_t at = static_cast<size_t>(bh) * t_pad + (valid[r] ? row : 0);
    lse2[r] = lse[at] * LOG2E;
    di_row[r] = di[at];
  }
  const float scale2 = scale * LOG2E;
  const uint32_t q_sm = smem_u32(Qs), do_sm = smem_u32(dOs);

  float acc[D / 8][4];
  zero(acc);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();  // this thread's copies of tile kt have landed
    fence_async_smem();
    __syncthreads();  // everyone's have, and tile kt - 1's slot is free
    const int next = kt + ST - 1;
    if (next < nk) {
      unsigned char* slot = ring + (next % ST) * 2 * P::KBYTES;
      issue_swz<DQ_BK, D>(slot, k + base, next * DQ_BK, t_pad);
      issue_swz<DQ_BK, D>(slot + P::KBYTES, v + base, next * DQ_BK, t_pad);
    }
    cp_async_commit();
    const int k0 = kt * DQ_BK;
    const uint32_t k_sm = smem_u32(ring + (kt % ST) * 2 * P::KBYTES), v_sm = k_sm + P::KBYTES;

    float s[NT][4], dp[NT][4];
    wgmma_fence();
    wg_abt<DQ_BK, D>(s, q_sm, k_sm);
    wgmma_commit();
    wg_abt<DQ_BK, D>(dp, do_sm, v_sm);
    wgmma_commit();
    wgmma_wait<1>();
    pin(s);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, key = k0 + 8 * j + 2 * c + (i & 1);
        const bool seen = !CAUSAL || key <= q0 + 16 * w + g + 8 * r;
        s[j][i] = valid[r] && key < t_real && seen ? exp2f(scale2 * s[j][i] - lse2[r]) : 0.f;
      }
    wgmma_wait<0>();
    pin(dp);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[j][i] = s[j][i] * (dp[j][i] - di_row[i >> 1]);
    uint32_t dsa[NT / 2][4];
    to_a(dsa, dp);  // dS rounded to Q's type
    pin(dsa);
    pin(acc);
    wgmma_fence();
    wg_av<D, NT / 2>(acc, dsa, k_sm);
    wgmma_commit();
    wgmma_wait<0>();  // the slot is reread by the next fill
    pin(acc);
    pin(dsa);
  }
  const float mul[2] = {scale, scale};
  store_rows<D>(dq + base, acc, q0 + 16 * w, t_pad, mul);
}

// K2: replaces _dkv_kernel (eav_tpu/ops/pallas/attention.py:113). Block
// (64-key tile, bh); the K and V tiles stay, Q, dO, lse and di stream over
// every query step up to t_pad. 8 T^2 D BH FLOP, bound by operations.
// Query step 64 below D 128: S^T and dP^T (2 x 32 f32) beside dK and dV
// (2 x D / 2) take 165 registers a thread at D 64. At D 128 dK and dV alone
// take 128 registers, so the step is 32 queries (209 registers). The ring
// holds 3 stages of (Q, dO, lse, di): 67.5 KB with K and V at D 64, so three
// blocks share an SM (two at D 128, 83 KB and 209 registers).
// Grid: 64-key tiles, the same 1824 blocks as K3 at the AST shape, for the
// same reason; a block's query loop runs over all of t_pad in 64-query steps.
template <int D>
struct DkvPlan {
  static constexpr int BQ = D == 128 ? 32 : 64;
  static constexpr int STAGES = 3;
  static constexpr int KBYTES = SwzTile<WG_ROWS, D>::BYTES, QBYTES = SwzTile<BQ, D>::BYTES;
  static constexpr size_t SMEM =
      1024 + 2 * KBYTES + STAGES * 2 * QBYTES + STAGES * 2 * BQ * sizeof(float);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WG_THREADS)
flash_dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int t_pad, int t_real,
                float scale) {
  using P = DkvPlan<D>;
  constexpr int BQ = P::BQ, ST = P::STAGES, NT = BQ / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + P::KBYTES;
  unsigned char* ring = Vs + P::KBYTES;  // stage s: Q tile, then dO tile
  float* stats = reinterpret_cast<float*>(ring + ST * 2 * P::QBYTES);  // stage s: lse, di

  const int bh = blockIdx.y, k0 = blockIdx.x * WG_ROWS;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * t_pad;
  const float* di_bh = di + static_cast<size_t>(bh) * t_pad;
  // causal: the query steps from the one holding this tile's first key on
  // (BQ divides WG_ROWS, so that step starts at k0)
  const int qbeg = CAUSAL ? k0 / BQ : 0;
  const int nq = (t_pad + BQ - 1) / BQ - qbeg;

  issue_swz<WG_ROWS, D>(Ks, k + base, k0, t_pad);
  issue_swz<WG_ROWS, D>(Vs, v + base, k0, t_pad);
  for (int t = 0; t < ST - 1; ++t) {  // group t: query step qbeg + t (group 0 also K and V)
    if (t < nq) {
      const int r0 = (qbeg + t) * BQ;
      issue_swz<BQ, D>(ring + t * 2 * P::QBYTES, q + base, r0, t_pad);
      issue_swz<BQ, D>(ring + t * 2 * P::QBYTES + P::QBYTES, dout + base, r0, t_pad);
      issue_stats<BQ>(stats + t * 2 * BQ, stats + t * 2 * BQ + BQ, lse_bh, di_bh, r0, t_pad);
    }
    cp_async_commit();
  }
  // this thread's keys: 16w + g and 16w + g + 8; keys at or past t_real get P = 0
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = k0 + 16 * w + g + 8 * r < t_real;
  const float scale2 = scale * LOG2E;
  const uint32_t k_sm = smem_u32(Ks), v_sm = smem_u32(Vs);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int qt = 0; qt < nq; ++qt) {
    cp_async_wait<ST - 2>();
    fence_async_smem();
    __syncthreads();
    const int next = qt + ST - 1;
    if (next < nq) {
      const int s = next % ST, r0 = (qbeg + next) * BQ;
      issue_swz<BQ, D>(ring + s * 2 * P::QBYTES, q + base, r0, t_pad);
      issue_swz<BQ, D>(ring + s * 2 * P::QBYTES + P::QBYTES, dout + base, r0, t_pad);
      issue_stats<BQ>(stats + s * 2 * BQ, stats + s * 2 * BQ + BQ, lse_bh, di_bh, r0, t_pad);
    }
    cp_async_commit();
    const int q0 = (qbeg + qt) * BQ, slot = qt % ST;
    const uint32_t q_sm = smem_u32(ring + slot * 2 * P::QBYTES), do_sm = q_sm + P::QBYTES;
    const float* Ls = stats + slot * 2 * BQ;
    const float* Dis = Ls + BQ;

    float st[NT][4], dpt[NT][4];
    wgmma_fence();
    wg_abt<BQ, D>(st, k_sm, q_sm);
    wgmma_commit();
    wg_abt<BQ, D>(dpt, v_sm, do_sm);
    wgmma_commit();
    wgmma_wait<1>();
    pin(st);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e;  // query within the step
        const bool q_ok = q0 + col < t_pad;
        const float l2 = Ls[col] * LOG2E;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool seen = !CAUSAL || k0 + 16 * w + g + 8 * r <= q0 + col;
          st[j][2 * r + e] =
              q_ok && key_ok[r] && seen ? exp2f(scale2 * st[j][2 * r + e] - l2) : 0.f;
        }
      }
    uint32_t pa[NT / 2][4];
    to_a(pa, st);  // P rounded to dO's type
    pin(pa);
    pin(dv_acc);
    wgmma_fence();
    wg_av<D, NT / 2>(dv_acc, pa, do_sm);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done (groups complete in order); dV runs on
    pin(dpt);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d_i = Dis[8 * j + 2 * c + e];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          dpt[j][2 * r + e] = st[j][2 * r + e] * (dpt[j][2 * r + e] - d_i);
      }
    uint32_t dsa[NT / 2][4];
    to_a(dsa, dpt);  // dS rounded to Q's type
    pin(dsa);
    pin(dk_acc);
    wgmma_fence();
    wg_av<D, NT / 2>(dk_acc, dsa, q_sm);
    wgmma_commit();
    wgmma_wait<0>();  // the slot is reread by the next fill
    pin(dv_acc);
    pin(dk_acc);
    pin(pa);
    pin(dsa);
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_rows<D>(dk + base, dk_acc, k0 + 16 * w, t_pad, mul);
  store_rows<D>(dv + base, dv_acc, k0 + 16 * w, t_pad, one);
}

// ===========================================================================
// K5: the one-pass forward (eav_flash_onepass)
// ===========================================================================
//
// Replaces _onepass_kernel (scripts/flash_onepass_experiment.py:25): the K1
// forward with a single K block, so the softmax is plain: one row max, one
// exp, one f32 sum of the unrounded P, no online rescaling. The TPU kernel
// holds a head's whole (T_pad x T_pad) f32 score tile in VMEM; at T 1214 that
// is 6.5 MB, far past the 227 KB of shared memory a Hopper block may have.
// What bounds it: the function's 4 T^2 D BH FLOP (operations, on 60 MB of
// operands at the AST shape); each block rereads its head's K and V from L2.
// Key tiles wholly past t_real are skipped (their P would be exactly 0).
//
// bf16 (flash_onepass_wgmma, at the end of this section) recomputes the
// scores in a second sweep instead of keeping them. float32 keeps them: a
// block owns a stripe of OP_ROWS = 32 query rows and keeps the stripe's
// whole score rows (32 x W f32, W = t_real rounded up to 64 keys: 156 KB at
// T 1214) in dynamic shared memory, in three phases:
//   1. S = scale Q K^T over 64-key tiles of K; keys >= t_real are set to -1e30;
//   2. per row m = max S, P = exp(S - m) written over S (f32, unrounded),
//      l = sum P, LSE = m + log max(l, 1e-30);
//   3. O = (P V) / max(l, 1e-30) over 64-key tiles of V.
// The stripe's rows are padded by 16 floats so that the stores of phase 1
// and loads of phase 3 are free of bank conflicts; FMA from tiles loaded in
// turn, 8 warps per block, one block per SM (the stripe takes most of its
// shared memory). The stripe bounds T: the launcher refuses a T whose stripe
// does not fit (the Python wrapper raises before that, from the same sizes).

constexpr int OP_ROWS = 32;          // query rows per block
constexpr int OP_KTILE = 64;         // keys per K or V tile
constexpr int OP_THREADS = 256;      // 8 warps
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB: the most a block may have

__device__ __host__ __forceinline__ int op_width(int t_real) {
  return (t_real + OP_KTILE - 1) / OP_KTILE * OP_KTILE;
}

// Phase 2 on the (OP_ROWS, width) stripe S with row stride lds; each warp
// owns OP_ROWS / 8 rows. P = exp(S - m) replaces S, max(l, 1e-30) goes to
// lsum and the LSE of rows below t_pad to lse_bh.
__device__ __forceinline__ void onepass_softmax(float* S, int lds, int width, float* lsum,
                                                float* __restrict__ lse_bh, int q0,
                                                int t_pad) {
  constexpr int RPW = OP_ROWS / (OP_THREADS / 32);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < RPW; ++i) {
    const int r = w * RPW + i;
    float* row = S + r * lds;
    float m = NEG_INF;
    for (int c = lane; c < width; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int c = lane; c < width; c += 32) {
      const float p = expf(row[c] - m);
      row[c] = p;
      l += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      const float l_safe = fmaxf(l, 1e-30f);
      lsum[r] = l_safe;
      if (q0 + r < t_pad) lse_bh[q0 + r] = m + logf(l_safe);
    }
  }
}

// K5, float32. Block (32-row stripe, bh); thread (ty, tx) owns stripe rows
// ty and ty+16, scores of keys tx+16j of each K tile, and output columns
// tx+16c.
template <int D>
__global__ void __launch_bounds__(OP_THREADS)
flash_onepass_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  int t_pad, int t_real, float scale) {
  constexpr int LD = D + 1, CJ = D / 16;
  const int width = op_width(t_real), lds = width + 16, nk = width / OP_KTILE;
  extern __shared__ float smem[];
  float* S = smem;                   // [OP_ROWS][lds]
  float* lsum = S + OP_ROWS * lds;   // [OP_ROWS]
  float* Qs = lsum + OP_ROWS;        // [OP_ROWS][LD]
  float* KV = Qs + OP_ROWS * LD;     // [OP_KTILE][LD]: a K tile, then a V tile

  const int bh = blockIdx.y, q0 = blockIdx.x * OP_ROWS;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D, OP_ROWS>(Qs, q + base, q0, t_pad);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * OP_KTILE;
    __syncthreads();  // the previous K tile is consumed
    load_tile<D>(KV, k + base, k0, t_pad);
    __syncthreads();
    float s[2][4] = {};
    tile_dot<D>(s, Qs, KV, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        S[(ty + 16 * i) * lds + key] = key < t_real ? scale * s[i][j] : NEG_INF;
      }
  }
  __syncthreads();
  onepass_softmax(S, lds, width, lsum, lse + static_cast<size_t>(bh) * t_pad, q0, t_pad);

  float acc[2][CJ] = {};
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * OP_KTILE;
    __syncthreads();  // P is complete; the previous V tile is consumed
    load_tile<D>(KV, v + base, k0, t_pad);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < OP_KTILE; ++kk) {
      float pv[2], vv[CJ];
#pragma unroll
      for (int i = 0; i < 2; ++i) pv[i] = S[(ty + 16 * i) * lds + k0 + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vv[c] = KV[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_pad) continue;
    const float l_safe = lsum[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      o[base + static_cast<size_t>(row) * D + tx + 16 * c] = acc[i][c] / l_safe;
  }
}

// K5, bf16: the same function without the stripe. K1's blocks, tiles and
// ring, with the score rows recomputed instead of kept:
//   sweep 1 streams K only: S = Q K^T, the exact row max m in registers;
//   sweep 2 streams K and V: S again (the same instructions on the same
//     tiles give the same f32 values), P = exp(S - m) with the final m, l
//     summed over the unrounded P, acc += bf16(P) V; neither acc nor l is
//     ever rescaled;
//   then O = acc / max(l, 1e-30) and LSE = m + log max(l, 1e-30).
// This is the TPU kernel's function, one max, one exp and one sum a row and
// no alpha, at 6 T^2 D BH FLOP against its 4 (Q K^T twice). Keeping the
// scores instead, as float32 does, takes 156 KB per 32 rows at T 1214 (one
// block an SM) and bounds T; recomputed, they need 57 KB (three blocks an
// SM) and any T fits. The ring runs on over both sweeps (2 nk steps), so
// sweep 2's first tiles load during sweep 1's last.
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
flash_onepass_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int t_pad, int t_real, float scale) {
  using P = FwdPlan<D>;
  constexpr int NT = FWD_BK / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  const int bh = blockIdx.y, q0 = blockIdx.x * WG_ROWS;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const int nk = (t_real + FWD_BK - 1) / FWD_BK;
  const FwdRing<D, P::K5_STAGES> ring{Qs + P::QBYTES, k + base, v + base, t_pad, nk, 2 * nk};

  issue_swz<WG_ROWS, D>(Qs, q + base, q0, t_pad);
  ring.start();
  const float scale2 = scale * LOG2E;
  const uint32_t q_sm = smem_u32(Qs);

  float m[2] = {NEG_INF, NEG_INF};  // raw row max of rows g and g + 8
  for (int kt = 0; kt < nk; ++kt) {
    float s[NT][4];
    fwd_scores<D>(s, q_sm, ring.advance(kt), kt * FWD_BK, t_real);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i >> 1] = fmaxf(m[i >> 1], s[j][i]);
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = quad_max(m[r]);
    mb[r] = m[r] * scale2;
  }

  float l[2] = {0.f, 0.f}, acc[D / 8][4];
  zero(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t k_sm = ring.advance(nk + kt);
    float s[NT][4];
    fwd_scores<D>(s, q_sm, k_sm, kt * FWD_BK, t_real);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = exp2f(fmaf(s[j][i], scale2, -mb[i >> 1]));
        l[i >> 1] += s[j][i];
      }
    fwd_pv<D>(acc, s, k_sm + P::KBYTES);
  }
  fwd_store<D>(o + base, lse + static_cast<size_t>(bh) * t_pad, acc, m, l, q0, t_pad, scale);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Sets the kernel's shared-memory allowance, launches it on a
// (ceil(t_pad / 64), bh) grid and returns the launch error.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int bh, int t_pad,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_pad + BLOCK - 1) / BLOCK, bh);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

constexpr size_t f32_tile(int d) { return static_cast<size_t>(BLOCK) * (d + 1); }
constexpr size_t f32_scores = static_cast<size_t>(BLOCK) * PLD;

template <int D, bool CAUSAL>
cudaError_t launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_pad, int t_real, float scale,
                       cudaStream_t stream) {
  if (dtype == 0)
    return launch(flash_fwd_f32<D, CAUSAL>, THREADS,
                  (3 * f32_tile(D) + f32_scores) * sizeof(float), bh, t_pad, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  static_cast<float*>(lse), t_pad, t_real, scale);
  return launch(flash_fwd_wgmma<D, CAUSAL>, WG_THREADS, FwdPlan<D>::smem(FwdPlan<D>::K1_STAGES), bh,
                t_pad, stream, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
                t_pad, t_real, scale);
}

template <int D, bool CAUSAL>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di, void* dk, void* dv,
                       int bh, int t_pad, int t_real, float scale, cudaStream_t stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dI = static_cast<const float*>(di);
  if (dtype == 0)
    return launch(flash_dkv_f32<D, CAUSAL>, THREADS,
                  (4 * f32_tile(D) + 2 * f32_scores + 2 * BLOCK) * sizeof(float), bh, t_pad,
                  stream, static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout), l, dI,
                  static_cast<float*>(dk), static_cast<float*>(dv), t_pad, t_real, scale);
  return launch(flash_dkv_wgmma<D, CAUSAL>, WG_THREADS, DkvPlan<D>::SMEM, bh, t_pad, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dI,
                static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_pad, t_real, scale);
}

template <int D, bool CAUSAL>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di, void* dq, int bh,
                      int t_pad, int t_real, float scale, cudaStream_t stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dI = static_cast<const float*>(di);
  if (dtype == 0)
    return launch(flash_dq_f32<D, CAUSAL>, THREADS,
                  (4 * f32_tile(D) + f32_scores + 2 * BLOCK) * sizeof(float), bh, t_pad,
                  stream, static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout), l, dI,
                  static_cast<float*>(dq), t_pad, t_real, scale);
  return launch(flash_dq_wgmma<D, CAUSAL>, WG_THREADS, DqPlan<D>::SMEM, bh, t_pad, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dI,
                static_cast<bf16*>(dq), t_pad, t_real, scale);
}

// Dynamic shared memory of the float32 K5 for a head dim and t_real (the
// kernel's carve-up above; ops/attention.py computes the same).
size_t onepass_smem_f32(int d, int t_real) {
  return sizeof(float) * (OP_ROWS * (op_width(t_real) + 16) + OP_ROWS + OP_ROWS * (d + 1) +
                          OP_KTILE * (d + 1));
}

// K5: float32 on a (ceil(t_pad / 32), bh) grid, refusing a stripe past
// SMEM_LIMIT; bf16 on K1's grid, any T.
template <int D>
cudaError_t launch_onepass(int dtype, const void* q, const void* k, const void* v, void* o,
                           void* lse, int bh, int t_pad, int t_real, float scale,
                           cudaStream_t stream) {
  if (dtype == 1)
    return launch(flash_onepass_wgmma<D>, WG_THREADS, FwdPlan<D>::smem(FwdPlan<D>::K5_STAGES),
                  bh, t_pad, stream, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
                  t_pad, t_real, scale);
  const size_t smem = onepass_smem_f32(D, t_real);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_onepass_f32<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_pad + OP_ROWS - 1) / OP_ROWS, bh);
  flash_onepass_f32<D><<<grid, OP_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), t_pad, t_real, scale);
  return cudaGetLastError();
}

// launcher<D>(dtype, args...) for the runtime head dim; dtype code 0 is
// float32, 1 bfloat16.
#define EAV_DISPATCH(LAUNCH, dtype, d, ...)                         \
  {                                                                 \
    if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;     \
    switch (d) {                                                    \
      case 16: return LAUNCH<16>(dtype, __VA_ARGS__);               \
      case 32: return LAUNCH<32>(dtype, __VA_ARGS__);               \
      case 64: return LAUNCH<64>(dtype, __VA_ARGS__);               \
      case 128: return LAUNCH<128>(dtype, __VA_ARGS__);             \
    }                                                               \
    return cudaErrorInvalidValue;                                   \
  }

// launcher<D, causal>(dtype, args...): EAV_DISPATCH with the causal flag.
#define EAV_DISPATCH_CAUSAL(LAUNCH, causal, dtype, d, ...)                    \
  {                                                                           \
    if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;               \
    switch (d) {                                                              \
      case 16: return causal ? LAUNCH<16, true>(dtype, __VA_ARGS__)           \
                             : LAUNCH<16, false>(dtype, __VA_ARGS__);         \
      case 32: return causal ? LAUNCH<32, true>(dtype, __VA_ARGS__)           \
                             : LAUNCH<32, false>(dtype, __VA_ARGS__);         \
      case 64: return causal ? LAUNCH<64, true>(dtype, __VA_ARGS__)           \
                             : LAUNCH<64, false>(dtype, __VA_ARGS__);         \
      case 128: return causal ? LAUNCH<128, true>(dtype, __VA_ARGS__)         \
                              : LAUNCH<128, false>(dtype, __VA_ARGS__);       \
    }                                                                         \
    return cudaErrorInvalidValue;                                             \
  }

cudaError_t fwd(int dtype, int d, const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int t_pad, int t_real, float scale, int causal,
                cudaStream_t stream) {
  EAV_DISPATCH_CAUSAL(launch_fwd, causal, dtype, d, q, k, v, o, lse, bh, t_pad, t_real,
                      scale, stream);
}

cudaError_t dkv(int dtype, int d, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* di, void* dk, void* dv,
                int bh, int t_pad, int t_real, float scale, int causal, cudaStream_t stream) {
  EAV_DISPATCH_CAUSAL(launch_dkv, causal, dtype, d, q, k, v, dout, lse, di, dk, dv, bh, t_pad,
                      t_real, scale, stream);
}

cudaError_t dq(int dtype, int d, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* di, void* dqp, int bh,
               int t_pad, int t_real, float scale, int causal, cudaStream_t stream) {
  EAV_DISPATCH_CAUSAL(launch_dq, causal, dtype, d, q, k, v, dout, lse, di, dqp, bh, t_pad,
                      t_real, scale, stream);
}

cudaError_t onepass(int dtype, int d, const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int t_pad, int t_real, float scale,
                    cudaStream_t stream) {
  EAV_DISPATCH(launch_onepass, dtype, d, q, k, v, o, lse, bh, t_pad, t_real, scale, stream);
}

}  // namespace

extern "C" {

int eav_flash_fwd(int device, int dtype, int d, const void* q, const void* k,
                  const void* v, void* o, void* lse, int bh, int t_pad, int t_real,
                  float scale, int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fwd(dtype, d, q, k, v, o, lse, bh, t_pad, t_real, scale, causal,
                              static_cast<cudaStream_t>(stream)));
}

int eav_flash_dkv(int device, int dtype, int d, const void* q, const void* k,
                  const void* v, const void* dout, const void* lse, const void* di,
                  void* dk, void* dv, int bh, int t_pad, int t_real, float scale, int causal,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dkv(dtype, d, q, k, v, dout, lse, di, dk, dv, bh, t_pad, t_real,
                              scale, causal, static_cast<cudaStream_t>(stream)));
}

int eav_flash_dq(int device, int dtype, int d, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse, const void* di,
                 void* dqp, int bh, int t_pad, int t_real, float scale, int causal,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dq(dtype, d, q, k, v, dout, lse, di, dqp, bh, t_pad, t_real,
                             scale, causal, static_cast<cudaStream_t>(stream)));
}

int eav_flash_onepass(int device, int dtype, int d, const void* q, const void* k,
                      const void* v, void* o, void* lse, int bh, int t_pad, int t_real,
                      float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(onepass(dtype, d, q, k, v, o, lse, bh, t_pad, t_real, scale,
                                  static_cast<cudaStream_t>(stream)));
}

const char* eav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
