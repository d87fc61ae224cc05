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
// scores, so exp() gives exactly 0 and no NaN appears. All products accumulate
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
// (dQ stays its own kernel, K3, so it is deterministic). Three designs:
//
// - bfloat16 backward, K2 and K3 (the training path's largest cost):
//   wgmma.mma_async products, FlashAttention-3 style, described at the
//   kernels below. Against the mma.sync kernels they replace, which waited
//   on synchronous loads behind barriers, stored operands transposed with
//   2-byte scalar stores, fed mma.sync from 32-bit shared loads and (K2)
//   stepped 32 queries at a time: tiles stream through a 3-stage cp.async
//   ring while the current one is multiplied; they sit in wgmma's canonical
//   swizzled layout, read through descriptors, and the transpose bit of the
//   bf16 wgmma reads a row-major tile as the MN-major operand, so nothing is
//   stored transposed; one warpgroup issues 64-row products; K2 steps 64
//   queries (32 at D 128).
// - bfloat16 forward, K1 and K5: tensor-core mma.sync.m16n8k16 products,
//   FlashAttention-2 style. A block of 4 warps owns 64 rows, each warp 16;
//   the scores a warp computes stay in its registers and are reused, rounded
//   to bf16, as the A operand of P.V, so P never touches shared memory. K1
//   stores V transposed when its tile is loaded; rows are padded by 8
//   elements, which makes the fragment loads free of bank conflicts.
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
template <int D>
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
  const int q0 = blockIdx.x * BLOCK;
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

  // tiles wholly past t_real would change nothing (p = 0, alpha = 1)
  const int nk = (t_real + BLOCK - 1) / BLOCK;
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
template <int D>
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
  for (int qt = 0; qt < nq; ++qt) {
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
        const float p = valid ? expf(scale * s[i][j] + bias[j] - Ls[r]) : 0.f;
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
template <int D>
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
  const int q0 = blockIdx.x * BLOCK;
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

  const int nk = (t_real + BLOCK - 1) / BLOCK;
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
        const float p = valid ? expf(scale * s[i][j] + bias[j] - Ls[r]) : 0.f;
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
// bfloat16 forward (K1 here, K5 below): mma.sync.m16n8k16, f32 accumulate
// ===========================================================================
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + c, g = lane / 4, c = lane % 4;
// each 32-bit register holds two consecutive bf16, the lower index first):
//   A (16x16, row-major): a0 (g, 2c..), a1 (g+8, 2c..), a2 (g, 8+2c..), a3 (g+8, 8+2c..)
//   B (16x8, col-major):  b0 (k 2c.., n g), b1 (k 8+2c.., n g)
//   C (16x8, f32):        c0 c1 (g, 2c, 2c+1), c2 c3 (g+8, 2c, 2c+1)
// The C fragments of two adjacent 8-column tiles are exactly the A fragment
// of one 16-deep step, which is how scores feed the next product.

typedef __nv_bfloat16 bf16;
constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows
constexpr int TILE = 64;          // rows of a Q or K/V tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to bf16 (round to nearest even) in one register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows row0 .. row0+ROWS-1 of a (t_pad, D) bf16 matrix into shared memory,
// row-major with stride LD, 16 bytes per thread and step, by a block of
// NTHREADS threads; rows at or past t_pad read as zero.
template <int ROWS, int D, int LD, int NTHREADS = MMA_THREADS>
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int t_pad) {
  constexpr int CHUNKS = D / 8;
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += NTHREADS) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t_pad)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// The same rows stored transposed: dst[col * LDT + r].
template <int ROWS, int D, int LDT>
__device__ __forceinline__ void load_bf16_t(bf16* dst, const bf16* __restrict__ src, int row0,
                                            int t_pad) {
  constexpr int CHUNKS = D / 8;
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += MMA_THREADS) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t_pad)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    const bf16* v = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * LDT + r] = v[i];
  }
}

// A fragments of rows r0 .. r0+15 of a row-major tile, one per 16-deep step of D.
template <int D, int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* tile, int r0) {
  const int g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* p = tile + (r0 + g) * LD + ks * 16 + 2 * c;
    a[ks][0] = ld_pair(p);
    a[ks][1] = ld_pair(p + 8 * LD);
    a[ks][2] = ld_pair(p + 8);
    a[ks][3] = ld_pair(p + 8 * LD + 8);
  }
}

// acc[nt] += A (16 x D, fragments a) . B^T for the 8*NT rows of B (row-major,
// stride LD): the product with B's rows as columns, e.g. Q K^T.
template <int D, int LD, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* b) {
  const int g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* p = b + (nt * 8 + g) * LD + ks * 16 + 2 * c;
      mma_bf16(acc[nt], a[ks], ld_pair(p), ld_pair(p + 8));
    }
}

// acc[dt] += P (16 x K, fragments pa over K / 16 steps) . V where V is given
// transposed (vt[d * LDT + k]): the (16 x D) result's D / 8 column tiles.
template <int D, int LDT, int KSTEPS>
__device__ __forceinline__ void mma_av(float (&acc)[D / 8][4], const uint32_t (&pa)[KSTEPS][4],
                                       const bf16* vt) {
  const int g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const bf16* p = vt + (dt * 8 + g) * LDT + ks * 16 + 2 * c;
      mma_bf16(acc[dt], pa[ks], ld_pair(p), ld_pair(p + 8));
    }
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
// K1, bf16. Block (64-row q tile, bh); warp w owns rows 16w..16w+15.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
              int t_pad, int t_real, float scale) {
  constexpr int LD = D + 8, LDT = TILE + 8, NT = TILE / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TILE][LD]
  bf16* Ks = Qs + TILE * LD;                      // [TILE][LD]
  bf16* Vt = Ks + TILE * LD;                      // [D][LDT], V transposed

  const int bh = blockIdx.y, q0 = blockIdx.x * TILE;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;

  load_bf16<TILE, D, LD>(Qs, q + base, q0, t_pad);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_a<D, LD>(qa, Qs, 16 * w);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DT][4];
  zero(acc);
  const int nk = (t_real + TILE - 1) / TILE;  // later tiles: p = 0, alpha = 1
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_bf16<TILE, D, LD>(Ks, k + base, k0, t_pad);
    load_bf16_t<TILE, D, LDT>(Vt, v + base, k0, t_pad);
    __syncthreads();

    float s[NT][4];
    zero(s);
    mma_abt<D, LD, NT>(s, qa, Ks);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * c + (i & 1);
        s[nt][i] = scale * s[nt][i] + (key < t_real ? 0.f : NEG_INF);
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = expf(s[nt][0] - m[0]), p1 = expf(s[nt][1] - m[0]);
      const float p2 = expf(s[nt][2] - m[1]), p3 = expf(s[nt][3] - m[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pa[nt / 2][2 * (nt % 2)] = pack_bf16(p0, p1);  // P rounded to V's type
      pa[nt / 2][2 * (nt % 2) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    mma_av<D, LDT, NT / 2>(acc, pa, Vt);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l_safe;
    const int row = q0 + 16 * w + g + 8 * r;
    if (c == 0 && row < t_pad) lse[static_cast<size_t>(bh) * t_pad + row] = m[r] + logf(l_safe);
  }
  store_rows<D>(o + base, acc, q0 + 16 * w, t_pad, inv);
}

// ===========================================================================
// bfloat16 backward (K2 dK/dV, K3 dQ): wgmma from swizzled shared memory
// ===========================================================================
//
// One consumer warpgroup (4 warps, 128 threads) per block owns 64 rows: keys
// in K2, queries in K3. Every product is a wgmma.mma_async m64nNk16 with f32
// accumulators; the accumulator's per-warp layout is that of mma.m16n8k16's
// C, stacked over the four warps (warp w holds rows 16w..16w+15), so the
// scores rounded to bf16 are directly the register A operand of the next
// product, as in the mma.sync kernels:
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
// current one is multiplied. Per step the warpgroup issues the two first
// products as two commit groups, turns S into P as soon as the first group
// is done (while dP still runs), starts the P product, turns dP into dS and
// starts the dS product, then waits for both before the ring slot is reused.

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
// cp.async; rows at or past t_pad are zero-filled.
template <int R, int D>
__device__ __forceinline__ void issue_swz(unsigned char* dst, const bf16* __restrict__ src,
                                          int row0, int t_pad) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < R * CH; e += WG_THREADS) {
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

template <int D>
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

  const int bh = blockIdx.y, q0 = blockIdx.x * WG_ROWS;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const int nk = (t_real + DQ_BK - 1) / DQ_BK;

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
        s[j][i] = valid[r] && key < t_real ? exp2f(scale2 * s[j][i] - lse2[r]) : 0.f;
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

template <int D>
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
  const int nq = (t_pad + BQ - 1) / BQ;

  issue_swz<WG_ROWS, D>(Ks, k + base, k0, t_pad);
  issue_swz<WG_ROWS, D>(Vs, v + base, k0, t_pad);
  for (int t = 0; t < ST - 1; ++t) {  // group t: query step t (group 0 also K and V)
    if (t < nq) {
      issue_swz<BQ, D>(ring + t * 2 * P::QBYTES, q + base, t * BQ, t_pad);
      issue_swz<BQ, D>(ring + t * 2 * P::QBYTES + P::QBYTES, dout + base, t * BQ, t_pad);
      issue_stats<BQ>(stats + t * 2 * BQ, stats + t * 2 * BQ + BQ, lse_bh, di_bh, t * BQ, t_pad);
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
      const int s = next % ST;
      issue_swz<BQ, D>(ring + s * 2 * P::QBYTES, q + base, next * BQ, t_pad);
      issue_swz<BQ, D>(ring + s * 2 * P::QBYTES + P::QBYTES, dout + base, next * BQ, t_pad);
      issue_stats<BQ>(stats + s * 2 * BQ, stats + s * 2 * BQ + BQ, lse_bh, di_bh, next * BQ,
                      t_pad);
    }
    cp_async_commit();
    const int q0 = qt * BQ, slot = qt % ST;
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
        for (int r = 0; r < 2; ++r)
          st[j][2 * r + e] = q_ok && key_ok[r] ? exp2f(scale2 * st[j][2 * r + e] - l2) : 0.f;
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
// The K1 forward with a single K block, so the softmax is plain: one row max,
// one exp, one f32 sum of the unrounded P, no online rescaling. The TPU kernel
// holds a head's whole (T_pad x T_pad) f32 score tile in VMEM; at T 1214 that
// is 6.5 MB, far past the 227 KB of shared memory a Hopper block may have. So
// a block here owns a stripe of OP_ROWS = 32 query rows and keeps the stripe's
// whole score rows (32 x W f32, W = t_real rounded up to 64 keys: 156 KB at
// T 1214) in dynamic shared memory, in three phases:
//   1. S = scale Q K^T over 64-key tiles of K; keys >= t_real are set to -1e30;
//   2. per row m = max S, P = exp(S - m) written over S (f32, unrounded),
//      l = sum P, LSE = m + log max(l, 1e-30);
//   3. O = (P V) / max(l, 1e-30) over 64-key tiles of V, P rounded to V's
//      type first.
// Key tiles wholly past t_real are skipped (their P would be exactly 0). The
// stripe's rows are padded (by 8 floats for bf16, 16 for float32) so that the
// fragment stores of phase 1 and loads of phase 3 are free of bank conflicts.
// bf16 goes through mma.sync.m16n8k16 as K1 does, with K and V tiles
// streamed through a cp.async ring; float32 through FMA from tiles loaded in
// turn. 8 warps per block, one block per SM (the stripe takes most of its
// shared memory).
// What bounds it: the same 4 T^2 D BH FLOP as K1 (operations, on 60 MB of
// operands at the AST shape); each block rereads its head's K and V from L2.
// The stripe bounds T: the launcher refuses a T whose stripe does not fit
// (the Python wrapper raises before that, from the same sizes).

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

// The two B fragments of one 16-deep step of an mma whose B (keys x 8
// columns) is stored row-major, keys as rows: rows p, p + LD, ... given by
// lanes 0-15 (keys 0-15 of the step); .trans hands each thread its column.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(p)));
}

constexpr int OP_STAGES = 3;  // K or V tiles in flight in the bf16 kernel's ring

// Rows k0 .. k0+63 of a (t_pad, D) bf16 matrix into a ring slot (row-major,
// stride LD) by cp.async; rows at or past t_pad are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void issue_tile(bf16* dst, const bf16* __restrict__ src, int k0,
                                           int t_pad) {
  constexpr int CHUNKS = D / 8;
  for (int e = threadIdx.x; e < OP_KTILE * CHUNKS; e += OP_THREADS) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    const bool ok = k0 + r < t_pad;
    cp_async16(dst + r * LD + c, src + static_cast<size_t>(ok ? k0 + r : 0) * D + c, ok);
  }
  cp_async_commit();
}

// K5, bf16. Block (32-row stripe, bh); warp w works on the stripe's 16-row
// half mt = w & 1: in phase 1 on keys 16 (w >> 1) .. +15 of each K tile, in
// phase 3 on the output column tiles dt = (w >> 1) + 4i. K and V tiles stream
// through a ring of OP_STAGES row-major slots filled by cp.async, so the next
// tiles load while the current one is used (and V's first tiles load during
// the softmax); the P V product reads V's B fragments with ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(OP_THREADS)
flash_onepass_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                  int t_pad, int t_real, float scale) {
  constexpr int LD = D + 8, DT = D / 8, DTW = (DT + 3) / 4;
  constexpr int KSTEPS = OP_KTILE / 16, SLOT = OP_KTILE * LD;
  const int width = op_width(t_real), lds = width + 8, nk = width / OP_KTILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);      // [OP_ROWS][lds]
  float* lsum = S + OP_ROWS * lds;                     // [OP_ROWS]
  bf16* Qs = reinterpret_cast<bf16*>(lsum + OP_ROWS);  // [OP_ROWS][LD]
  bf16* ring = Qs + OP_ROWS * LD;                      // [OP_STAGES][OP_KTILE][LD]

  const int bh = blockIdx.y, q0 = blockIdx.x * OP_ROWS;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int mt = w & 1, wq = w >> 1;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;

  // ring prologue: the first OP_STAGES - 1 K tiles (an empty group past nk
  // keeps the group count, and so the waits below, uniform)
  for (int t = 0; t < OP_STAGES - 1; ++t) {
    if (t < nk) issue_tile<D, LD>(ring + t * SLOT, k + base, t * OP_KTILE, t_pad);
    else cp_async_commit();
  }
  load_bf16<OP_ROWS, D, LD, OP_THREADS>(Qs, q + base, q0, t_pad);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_a<D, LD>(qa, Qs, 16 * mt);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<OP_STAGES - 2>();  // this thread's part of tile kt has landed
    __syncthreads();  // everyone's has, and every warp is done with tile kt - 1
    const int next = kt + OP_STAGES - 1;  // into tile kt - 1's slot
    if (next < nk) issue_tile<D, LD>(ring + (next % OP_STAGES) * SLOT, k + base, next * OP_KTILE, t_pad);
    else cp_async_commit();
    const int k0 = kt * OP_KTILE;
    float s[2][4];
    zero(s);
    mma_abt<D, LD, 2>(s, qa, ring + (kt % OP_STAGES) * SLOT + 16 * wq * LD);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + 16 * wq + nt * 8 + 2 * c;
        float2 val;
        val.x = key < t_real ? scale * s[nt][2 * r] : NEG_INF;
        val.y = key + 1 < t_real ? scale * s[nt][2 * r + 1] : NEG_INF;
        *reinterpret_cast<float2*>(S + (16 * mt + g + 8 * r) * lds + key) = val;
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // the scores are complete and the ring is free
  for (int t = 0; t < OP_STAGES - 1; ++t) {  // V's first tiles load during the softmax
    if (t < nk) issue_tile<D, LD>(ring + t * SLOT, v + base, t * OP_KTILE, t_pad);
    else cp_async_commit();
  }
  onepass_softmax(S, lds, width, lsum, lse + static_cast<size_t>(bh) * t_pad, q0, t_pad);

  float acc[DTW][4];
  zero(acc);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<OP_STAGES - 2>();
    __syncthreads();  // V tile kt is in, P is complete, tile kt - 1 is consumed
    const int next = kt + OP_STAGES - 1;
    if (next < nk) issue_tile<D, LD>(ring + (next % OP_STAGES) * SLOT, v + base, next * OP_KTILE, t_pad);
    else cp_async_commit();
    const int k0 = kt * OP_KTILE;
    const bf16* Vs = ring + (kt % OP_STAGES) * SLOT;  // [key][d]
    // A fragments of P (rows 16 mt + g, + 8; this tile's keys), rounded to bf16
    uint32_t pa[KSTEPS][4];
    const float* prow = S + (16 * mt + g) * lds + k0 + 2 * c;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const float* p = prow + ks * 16;
      const float2 a0 = *reinterpret_cast<const float2*>(p);
      const float2 a1 = *reinterpret_cast<const float2*>(p + 8 * lds);
      const float2 a2 = *reinterpret_cast<const float2*>(p + 8);
      const float2 a3 = *reinterpret_cast<const float2*>(p + 8 * lds + 8);
      pa[ks][0] = pack_bf16(a0.x, a0.y);
      pa[ks][1] = pack_bf16(a1.x, a1.y);
      pa[ks][2] = pack_bf16(a2.x, a2.y);
      pa[ks][3] = pack_bf16(a3.x, a3.y);
    }
#pragma unroll
    for (int i = 0; i < DTW; ++i) {
      const int dt = wq + 4 * i;
      if (dt >= DT) continue;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, Vs + (ks * 16 + (lane & 15)) * LD + dt * 8);
        mma_bf16(acc[i], pa[ks], b0, b1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * mt + g + 8 * r;
    if (row >= t_pad) continue;
    const float l_safe = lsum[16 * mt + g + 8 * r];
#pragma unroll
    for (int i = 0; i < DTW; ++i) {
      const int dt = wq + 4 * i;
      if (dt >= DT) continue;
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(row) * D + dt * 8 + 2 * c) =
          pack_bf16(acc[i][2 * r] / l_safe, acc[i][2 * r + 1] / l_safe);
    }
  }
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
constexpr size_t bf16_tile(int rows, int d) { return static_cast<size_t>(rows) * (d + 8); }

template <int D>
cudaError_t launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_pad, int t_real, float scale,
                       cudaStream_t stream) {
  if (dtype == 0)
    return launch(flash_fwd_f32<D>, THREADS,
                  (3 * f32_tile(D) + f32_scores) * sizeof(float), bh, t_pad, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  static_cast<float*>(lse), t_pad, t_real, scale);
  return launch(flash_fwd_mma<D>, MMA_THREADS,
                (2 * bf16_tile(TILE, D) + bf16_tile(D, TILE)) * sizeof(bf16), bh, t_pad,
                stream, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o),
                static_cast<float*>(lse), t_pad, t_real, scale);
}

template <int D>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di, void* dk, void* dv,
                       int bh, int t_pad, int t_real, float scale, cudaStream_t stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dI = static_cast<const float*>(di);
  if (dtype == 0)
    return launch(flash_dkv_f32<D>, THREADS,
                  (4 * f32_tile(D) + 2 * f32_scores + 2 * BLOCK) * sizeof(float), bh, t_pad,
                  stream, static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout), l, dI,
                  static_cast<float*>(dk), static_cast<float*>(dv), t_pad, t_real, scale);
  return launch(flash_dkv_wgmma<D>, WG_THREADS, DkvPlan<D>::SMEM, bh, t_pad, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dI,
                static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_pad, t_real, scale);
}

template <int D>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di, void* dq, int bh,
                      int t_pad, int t_real, float scale, cudaStream_t stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dI = static_cast<const float*>(di);
  if (dtype == 0)
    return launch(flash_dq_f32<D>, THREADS,
                  (4 * f32_tile(D) + f32_scores + 2 * BLOCK) * sizeof(float), bh, t_pad,
                  stream, static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout), l, dI,
                  static_cast<float*>(dq), t_pad, t_real, scale);
  return launch(flash_dq_wgmma<D>, WG_THREADS, DqPlan<D>::SMEM, bh, t_pad, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dI,
                static_cast<bf16*>(dq), t_pad, t_real, scale);
}

// Dynamic shared memory of K5 for a head dim and t_real (the sizes of the
// kernels' carve-ups above; ops/attention.py computes the same).
size_t onepass_smem(int dtype, int d, int t_real) {
  const size_t width = op_width(t_real);
  if (dtype == 0)
    return sizeof(float) * (OP_ROWS * (width + 16) + OP_ROWS + OP_ROWS * (d + 1) +
                            OP_KTILE * (d + 1));
  return sizeof(float) * (OP_ROWS * (width + 8) + OP_ROWS) +
         sizeof(bf16) * (OP_ROWS + OP_STAGES * OP_KTILE) * (d + 8);
}

// K5 on a (ceil(t_pad / 32), bh) grid; refuses a stripe past SMEM_LIMIT.
template <int D>
cudaError_t launch_onepass(int dtype, const void* q, const void* k, const void* v, void* o,
                           void* lse, int bh, int t_pad, int t_real, float scale,
                           cudaStream_t stream) {
  const size_t smem = onepass_smem(dtype, D, t_real);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const dim3 grid((t_pad + OP_ROWS - 1) / OP_ROWS, bh);
  cudaError_t err;
  if (dtype == 0) {
    err = allow_smem(flash_onepass_f32<D>, smem);
    if (err != cudaSuccess) return err;
    flash_onepass_f32<D><<<grid, OP_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), t_pad,
        t_real, scale);
  } else {
    err = allow_smem(flash_onepass_mma<D>, smem);
    if (err != cudaSuccess) return err;
    flash_onepass_mma<D><<<grid, OP_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), t_pad, t_real, scale);
  }
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

cudaError_t fwd(int dtype, int d, const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int t_pad, int t_real, float scale,
                cudaStream_t stream) {
  EAV_DISPATCH(launch_fwd, dtype, d, q, k, v, o, lse, bh, t_pad, t_real, scale, stream);
}

cudaError_t dkv(int dtype, int d, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* di, void* dk, void* dv,
                int bh, int t_pad, int t_real, float scale, cudaStream_t stream) {
  EAV_DISPATCH(launch_dkv, dtype, d, q, k, v, dout, lse, di, dk, dv, bh, t_pad, t_real,
               scale, stream);
}

cudaError_t dq(int dtype, int d, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* di, void* dqp, int bh,
               int t_pad, int t_real, float scale, cudaStream_t stream) {
  EAV_DISPATCH(launch_dq, dtype, d, q, k, v, dout, lse, di, dqp, bh, t_pad, t_real, scale,
               stream);
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
                  float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fwd(dtype, d, q, k, v, o, lse, bh, t_pad, t_real, scale,
                              static_cast<cudaStream_t>(stream)));
}

int eav_flash_dkv(int device, int dtype, int d, const void* q, const void* k,
                  const void* v, const void* dout, const void* lse, const void* di,
                  void* dk, void* dv, int bh, int t_pad, int t_real, float scale,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dkv(dtype, d, q, k, v, dout, lse, di, dk, dv, bh, t_pad, t_real,
                              scale, static_cast<cudaStream_t>(stream)));
}

int eav_flash_dq(int device, int dtype, int d, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse, const void* di,
                 void* dqp, int bh, int t_pad, int t_real, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dq(dtype, d, q, k, v, dout, lse, di, dqp, bh, t_pad, t_real,
                             scale, static_cast<cudaStream_t>(stream)));
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
