// Flash attention for Hopper (sm_90a): forward (K1), dK/dV (K2) and dQ (K3).
//
// These replace the three Pallas TPU kernels of eav_tpu/ops/pallas/attention.py:
//   K1 eav_flash_fwd  <- _flash_kernel (attention.py:73)
//   K2 eav_flash_dkv  <- _dkv_kernel   (attention.py:113)
//   K3 eav_flash_dq   <- _dq_kernel    (attention.py:158)
//
// Operands are head-major (BH, T_pad, D), row-major and contiguous, in float32
// or bfloat16. Keys at or beyond t_real are masked by adding -1e30 to their
// scores, so exp() gives exactly 0 and no NaN appears. All products accumulate
// in float32, and the softmax state (m, l, lse) is float32. The rounding points
// of the TPU kernels are kept: P is rounded to V's type before P.V and dS to
// Q's type before dS.K and dS^T.Q.
//
// What bounds them on the H100: at the AST shape (BH 96, T 1214, D 64) each
// kernel does 4-8 T^2 D BH = 3.6e10-7.2e10 FLOP on 60-90 MB of operands, so
// the bound is arithmetic, far above the card's ~295 FLOP/byte ridge, and the
// (T, T) scores never leave the SM. The TPU's sequential grid axis (the inner
// loop over K or Q blocks) becomes a loop inside each block, so blocks are
// independent and no atomics are needed. Two designs:
//
// - bfloat16 (the training path): tensor-core mma.sync.m16n8k16 products,
//   FlashAttention-2 style. A block of 4 warps owns 64 rows, each warp 16;
//   the scores a warp computes stay in its registers and are reused, rounded
//   to bf16, as the A operand of the next product (P.V, dS.K, P^T.dO,
//   dS^T.Q), so P and dS never touch shared memory. Operands whose product
//   needs them column-major are stored transposed when their tile is loaded.
//   Rows are padded by 8 elements, which makes the fragment loads free of
//   bank conflicts. No cp.async/TMA pipelining and no wgmma yet.
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

// Rows row0 .. row0+BLOCK-1 of a (t_pad, D) matrix into shared memory with
// row stride D + 1; rows at or past t_pad read as zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int t_pad) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < BLOCK * D; e += THREADS) {
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

// acc[i][j] += sum_d A[ty+16i][d] * B[tx+16j][d] for two (BLOCK, D) tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
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
// bfloat16: tensor-core kernels (mma.sync.m16n8k16, f32 accumulate)
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
constexpr int TILE = 64;          // rows of a Q or K/V tile (K2: keys per block)
constexpr int K2_QTILE = 32;      // query rows per step of K2 (keeps its registers < 255)

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
// row-major with stride LD, 16 bytes per thread and step; rows at or past
// t_pad read as zero.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int t_pad) {
  constexpr int CHUNKS = D / 8;
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += MMA_THREADS) {
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

// K3, bf16. Block (64-row q tile, bh); warp w owns rows 16w..16w+15.
//   S = Q K^T, dP = dO V^T, dS = P (dP - di), dQ += dS K (K transposed in smem)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dq, int t_pad, int t_real, float scale) {
  constexpr int LD = D + 8, LDT = TILE + 8, NT = TILE / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TILE][LD]
  bf16* dOs = Qs + TILE * LD;                     // [TILE][LD]
  bf16* Ks = dOs + TILE * LD;                     // [TILE][LD]
  bf16* Vs = Ks + TILE * LD;                      // [TILE][LD]
  bf16* Kt = Vs + TILE * LD;                      // [D][LDT], K transposed

  const int bh = blockIdx.y, q0 = blockIdx.x * TILE;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;

  load_bf16<TILE, D, LD>(Qs, q + base, q0, t_pad);
  load_bf16<TILE, D, LD>(dOs, dout + base, q0, t_pad);
  __syncthreads();
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D, LD>(qa, Qs, 16 * w);
  load_a<D, LD>(da, dOs, 16 * w);
  float row_lse[2], row_di[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * w + g + 8 * r;
    valid[r] = row < t_pad;
    const size_t at = static_cast<size_t>(bh) * t_pad + (valid[r] ? row : 0);
    row_lse[r] = lse[at];
    row_di[r] = di[at];
  }

  float acc[DT][4];
  zero(acc);
  const int nk = (t_real + TILE - 1) / TILE;  // later tiles: dS = 0
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_bf16<TILE, D, LD>(Ks, k + base, k0, t_pad);
    load_bf16<TILE, D, LD>(Vs, v + base, k0, t_pad);
    load_bf16_t<TILE, D, LDT>(Kt, k + base, k0, t_pad);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    mma_abt<D, LD, NT>(s, qa, Ks);
    mma_abt<D, LD, NT>(dp, da, Vs);
    uint32_t dsa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, key = k0 + nt * 8 + 2 * c + (i & 1);
        const float p = valid[r] ? expf(scale * s[nt][i] + (key < t_real ? 0.f : NEG_INF) - row_lse[r]) : 0.f;
        ds[i] = p * (dp[nt][i] - row_di[r]);
      }
      dsa[nt / 2][2 * (nt % 2)] = pack_bf16(ds[0], ds[1]);  // dS rounded to Q's type
      dsa[nt / 2][2 * (nt % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_av<D, LDT, NT / 2>(acc, dsa, Kt);
  }
  const float mul[2] = {scale, scale};
  store_rows<D>(dq + base, acc, q0 + 16 * w, t_pad, mul);
}

// K2, bf16. Block (64-key tile, bh); warp w owns keys 16w..16w+15 and works
// in the transposed orientation, keys x queries, over 32-query steps:
//   S^T = K Q^T, P^T = exp(S^T - lse), dV += P^T dO, dP^T = V dO^T,
//   dS^T = P^T (dP^T - di), dK += dS^T Q (dO and Q transposed in smem)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int t_pad, int t_real,
              float scale) {
  constexpr int LD = D + 8, BQ = K2_QTILE, LDT = BQ + 8, NT = BQ / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [TILE][LD]
  bf16* Vs = Ks + TILE * LD;                      // [TILE][LD]
  bf16* Qs = Vs + TILE * LD;                      // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                       // [BQ][LD]
  bf16* Qt = dOs + BQ * LD;                       // [D][LDT]
  bf16* dOt = Qt + D * LDT;                       // [D][LDT]
  float* Ls = reinterpret_cast<float*>(dOt + D * LDT);  // [BQ]
  float* Dis = Ls + BQ;                                 // [BQ]

  const int bh = blockIdx.y, k0 = blockIdx.x * TILE;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const size_t base = static_cast<size_t>(bh) * t_pad * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * t_pad;
  const float* di_bh = di + static_cast<size_t>(bh) * t_pad;

  load_bf16<TILE, D, LD>(Ks, k + base, k0, t_pad);
  load_bf16<TILE, D, LD>(Vs, v + base, k0, t_pad);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D, LD>(ka, Ks, 16 * w);
  load_a<D, LD>(va, Vs, 16 * w);
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) bias[r] = (k0 + 16 * w + g + 8 * r < t_real) ? 0.f : NEG_INF;

  float dk_acc[DT][4], dv_acc[DT][4];
  zero(dk_acc);
  zero(dv_acc);
  const int nq = (t_pad + BQ - 1) / BQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_bf16<BQ, D, LD>(Qs, q + base, q0, t_pad);
    load_bf16<BQ, D, LD>(dOs, dout + base, q0, t_pad);
    load_bf16_t<BQ, D, LDT>(Qt, q + base, q0, t_pad);
    load_bf16_t<BQ, D, LDT>(dOt, dout + base, q0, t_pad);
    for (int i = threadIdx.x; i < BQ; i += MMA_THREADS) {
      const bool ok = q0 + i < t_pad;
      Ls[i] = ok ? lse_bh[q0 + i] : 0.f;
      Dis[i] = ok ? di_bh[q0 + i] : 0.f;
    }
    __syncthreads();

    float st[NT][4], dpt[NT][4];
    zero(st);
    zero(dpt);
    mma_abt<D, LD, NT>(st, ka, Qs);
    mma_abt<D, LD, NT>(dpt, va, dOs);
    uint32_t pa[NT / 2][4], dsa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * c + (i & 1);  // query within the step
        p[i] = q0 + col < t_pad ? expf(scale * st[nt][i] + bias[i >> 1] - Ls[col]) : 0.f;
        ds[i] = p[i] * (dpt[nt][i] - Dis[col]);
      }
      pa[nt / 2][2 * (nt % 2)] = pack_bf16(p[0], p[1]);  // P rounded to dO's type
      pa[nt / 2][2 * (nt % 2) + 1] = pack_bf16(p[2], p[3]);
      dsa[nt / 2][2 * (nt % 2)] = pack_bf16(ds[0], ds[1]);  // dS rounded to Q's type
      dsa[nt / 2][2 * (nt % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_av<D, LDT, NT / 2>(dv_acc, pa, dOt);
    mma_av<D, LDT, NT / 2>(dk_acc, dsa, Qt);
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_rows<D>(dk + base, dk_acc, k0 + 16 * w, t_pad, mul);
  store_rows<D>(dv + base, dv_acc, k0 + 16 * w, t_pad, one);
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
  return launch(flash_dkv_mma<D>, MMA_THREADS,
                (2 * bf16_tile(TILE, D) + 2 * bf16_tile(K2_QTILE, D) +
                 2 * bf16_tile(D, K2_QTILE)) * sizeof(bf16) + 2 * K2_QTILE * sizeof(float),
                bh, t_pad, stream, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
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
  return launch(flash_dq_mma<D>, MMA_THREADS,
                (4 * bf16_tile(TILE, D) + bf16_tile(D, TILE)) * sizeof(bf16), bh, t_pad,
                stream, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dI,
                static_cast<bf16*>(dq), t_pad, t_real, scale);
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

const char* eav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
