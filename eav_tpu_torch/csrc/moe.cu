// The row passes of the mixture-of-experts layer (ops/moe.py) over its
// room, for Hopper (sm_90a): dispatch, the room's SwiGLU and the weighted
// combine, each with its backward.
//
// These replace no TPU kernel: the JAX package has no expert layer. They
// replace the room-wide PyTorch passes of ops/moe.py's first expert layer
// (a gather u[tok] whose backward accumulated with index_put, two
// torch.where masks, SwiGLU over every room row, the weighting and a bf16
// atomic index_add), which ran over all N·k rows of the room while one
// rank of expert parallelism holds only an eighth of them.
//
// The room: the N·k (token, expert) pairs sorted by held expert, the held
// pairs first. offs (int32, n_held) holds each held expert's end in it, so
// the held count is offs[n_held - 1]. Every kernel reads that count from
// device memory and stops there: no host sync, the grid fixed by the room's
// shape (persistent blocks striding rows up to the count), so a CUDA graph
// captured once reads each replay's own count. Rows at or past the count are
// neither read nor written. order[r] (int32) is the pair in room row r
// (pair p = token p / k, its (p % k)-th expert); slot[p] (int32) its
// inverse, the room row of pair p.
//
//   dispatch        x[r] = u[order[r] / k], r < count             a warp a row
//   dispatch_bwd    du[n] = sum_j dx[slot[n k + j]], held pairs     a warp a token
//   swiglu          h = silu(g) * up, rows < count                 a thread 16 bytes
//   swiglu_bwd      dg = silu'(g) * (dh * up), dup = silu(g) * dh   a thread 16 bytes
//   combine         out[n] = sum_j w[n, j] y[slot[n k + j]], held   a warp a token
//   combine_bwd     dy[slot] = w dout[n], dw[n, j] = <y[slot], dout[n]>;
//                   dw 0 for pairs not held                         a warp a token
//
// The reductions over a token's pairs (dispatch_bwd, combine) run in the
// order j = 0..k-1 in float32 and write each token's row once: no atomics,
// so every kernel is deterministic. The SwiGLU keeps the rounding points of
// PyTorch's silu and mul in the working type (silu(g) rounded before the
// product, dh * up rounded before silu_backward).
//
// What bounds them on the H100: bytes. Each moves the held rows once (and
// the tokens' rows once where a token is read or written), a few hundred MB
// a layer at LFM2-24B-A2B's shape, with a handful of FLOPs a byte. So every
// access is 16 bytes a thread, neighbouring lanes on neighbouring addresses,
// and enough warps are in flight to cover the memory's latency.
//
// Each extern "C" launcher takes raw pointers, sizes and a CUDA stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 8;  // 2,048 threads an SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back: the working type's rounding point
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// 16 bytes of T
template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
__device__ __forceinline__ Pack<T> load16(const T* p) {
  Pack<T> out;
  *reinterpret_cast<uint4*>(&out) = __ldg(reinterpret_cast<const uint4*>(p));
  return out;
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const Pack<T>& v) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&v);
}

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

__device__ __forceinline__ int held_count(const int* offs, int n_held) {
  return __ldg(offs + n_held - 1);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return (blockIdx.x * blockDim.x + threadIdx.x) >> 5; }
__device__ __forceinline__ int warp_count() { return (gridDim.x * blockDim.x) >> 5; }

template <typename T>
__global__ void __launch_bounds__(THREADS) dispatch_kernel(
    const T* __restrict__ u, const int* __restrict__ order, const int* __restrict__ offs,
    int n_held, int k, int width, T* __restrict__ x) {
  constexpr int V = Pack<T>::N;
  const int count = held_count(offs, n_held);
  for (int r = warp_id(); r < count; r += warp_count()) {
    const T* src = u + static_cast<size_t>(__ldg(order + r) / k) * width;
    T* dst = x + static_cast<size_t>(r) * width;
    for (int i = lane_id() * V; i < width; i += 32 * V) store16(dst + i, load16(src + i));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) dispatch_bwd_kernel(
    const T* __restrict__ dx, const int* __restrict__ slot, const int* __restrict__ offs,
    int n_held, int k, int tokens, int width, T* __restrict__ du) {
  constexpr int V = Pack<T>::N;
  const int count = held_count(offs, n_held);
  for (int n = warp_id(); n < tokens; n += warp_count()) {
    const int* pairs = slot + static_cast<size_t>(n) * k;
    for (int i = lane_id() * V; i < width; i += 32 * V) {
      float acc[V] = {};
      for (int j = 0; j < k; ++j) {
        const int s = __ldg(pairs + j);
        if (s >= count) continue;
        const Pack<T> d = load16(dx + static_cast<size_t>(s) * width + i);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += to_f(d.v[e]);
      }
      Pack<T> out;
#pragma unroll
      for (int e = 0; e < V; ++e) out.v[e] = from_f<T>(acc[e]);
      store16(du + static_cast<size_t>(n) * width + i, out);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) swiglu_kernel(
    const T* __restrict__ g, const T* __restrict__ up, const int* __restrict__ offs, int n_held,
    int width, T* __restrict__ h) {
  constexpr int V = Pack<T>::N;
  const size_t packs = static_cast<size_t>(held_count(offs, n_held)) * width / V;
  for (size_t p = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; p < packs;
       p += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const Pack<T> a = load16(g + p * V), b = load16(up + p * V);
    Pack<T> out;
#pragma unroll
    for (int e = 0; e < V; ++e)
      out.v[e] = from_f<T>(round_to<T>(silu(to_f(a.v[e]))) * to_f(b.v[e]));
    store16(h + p * V, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) swiglu_bwd_kernel(
    const T* __restrict__ dh, const T* __restrict__ g, const T* __restrict__ up,
    const int* __restrict__ offs, int n_held, int width, T* __restrict__ dg,
    T* __restrict__ dup) {
  constexpr int V = Pack<T>::N;
  const size_t packs = static_cast<size_t>(held_count(offs, n_held)) * width / V;
  for (size_t p = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; p < packs;
       p += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const Pack<T> d = load16(dh + p * V), a = load16(g + p * V), b = load16(up + p * V);
    Pack<T> out_g, out_up;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float gv = to_f(a.v[e]), dv = to_f(d.v[e]);
      const float sig = 1.0f / (1.0f + expf(-gv));
      const float gu = round_to<T>(dv * to_f(b.v[e]));  // silu_backward's incoming gradient
      out_g.v[e] = from_f<T>(gu * sig * (1.0f + gv * (1.0f - sig)));
      out_up.v[e] = from_f<T>(round_to<T>(silu(gv)) * dv);
    }
    store16(dg + p * V, out_g);
    store16(dup + p * V, out_up);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) combine_kernel(
    const T* __restrict__ y, const float* __restrict__ w, const int* __restrict__ slot,
    const int* __restrict__ offs, int n_held, int k, int tokens, int width,
    T* __restrict__ out) {
  constexpr int V = Pack<T>::N;
  const int count = held_count(offs, n_held);
  for (int n = warp_id(); n < tokens; n += warp_count()) {
    const size_t first = static_cast<size_t>(n) * k;
    for (int i = lane_id() * V; i < width; i += 32 * V) {
      float acc[V] = {};
      for (int j = 0; j < k; ++j) {
        const int s = __ldg(slot + first + j);
        if (s >= count) continue;
        const float wj = __ldg(w + first + j);
        const Pack<T> r = load16(y + static_cast<size_t>(s) * width + i);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += wj * to_f(r.v[e]);
      }
      Pack<T> o;
#pragma unroll
      for (int e = 0; e < V; ++e) o.v[e] = from_f<T>(acc[e]);
      store16(out + static_cast<size_t>(n) * width + i, o);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) combine_bwd_kernel(
    const T* __restrict__ dout, const T* __restrict__ y, const float* __restrict__ w,
    const int* __restrict__ slot, const int* __restrict__ offs, int n_held, int k, int tokens,
    int width, T* __restrict__ dy, float* __restrict__ dw) {
  constexpr int V = Pack<T>::N;
  const int count = held_count(offs, n_held);
  for (int n = warp_id(); n < tokens; n += warp_count()) {
    const size_t first = static_cast<size_t>(n) * k;
    const T* d = dout + static_cast<size_t>(n) * width;
    for (int j = 0; j < k; ++j) {
      const int s = __ldg(slot + first + j);
      if (s >= count) {  // the same for the whole warp
        if (lane_id() == 0) dw[first + j] = 0.0f;
        continue;
      }
      const float wj = __ldg(w + first + j);
      const T* row = y + static_cast<size_t>(s) * width;
      T* drow = dy + static_cast<size_t>(s) * width;
      float dot = 0.0f;
      for (int i = lane_id() * V; i < width; i += 32 * V) {
        const Pack<T> a = load16(d + i), r = load16(row + i);
        Pack<T> o;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float dv = to_f(a.v[e]);
          dot += to_f(r.v[e]) * dv;
          o.v[e] = from_f<T>(wj * dv);
        }
        store16(drow + i, o);
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, m);
      if (lane_id() == 0) dw[first + j] = dot;
    }
  }
}

// blocks for ``work`` items of ``per_block`` each, at most BLOCKS_PER_SM a
// multiprocessor: a fixed grid for a fixed shape, whatever the held count
int grid(int device, size_t work, int per_block) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t blocks = (work + per_block - 1) / per_block;
  const size_t most = static_cast<size_t>(sms) * BLOCKS_PER_SM;
  return static_cast<int>(blocks < 1 ? 1 : (blocks < most ? blocks : most));
}

template <template <typename> class Launch, typename... Args>
cudaError_t by_dtype(int dtype, Args... args) {
  if (dtype == 0) Launch<float>::run(args...);
  else if (dtype == 1) Launch<__nv_bfloat16>::run(args...);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
struct Dispatch {
  static void run(int device, const void* u, const void* order, const void* offs, int n_held,
                  int k, int rows, int width, void* x, cudaStream_t stream) {
    dispatch_kernel<T><<<grid(device, rows, WARPS), THREADS, 0, stream>>>(
        static_cast<const T*>(u), static_cast<const int*>(order), static_cast<const int*>(offs),
        n_held, k, width, static_cast<T*>(x));
  }
};

template <typename T>
struct DispatchBwd {
  static void run(int device, const void* dx, const void* slot, const void* offs, int n_held,
                  int k, int tokens, int width, void* du, cudaStream_t stream) {
    dispatch_bwd_kernel<T><<<grid(device, tokens, WARPS), THREADS, 0, stream>>>(
        static_cast<const T*>(dx), static_cast<const int*>(slot), static_cast<const int*>(offs),
        n_held, k, tokens, width, static_cast<T*>(du));
  }
};

template <typename T>
struct SwiGLU {
  static void run(int device, const void* g, const void* up, const void* offs, int n_held,
                  int rows, int width, void* h, cudaStream_t stream) {
    const size_t packs = static_cast<size_t>(rows) * width / Pack<T>::N;
    swiglu_kernel<T><<<grid(device, packs, THREADS), THREADS, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(up), static_cast<const int*>(offs),
        n_held, width, static_cast<T*>(h));
  }
};

template <typename T>
struct SwiGLUBwd {
  static void run(int device, const void* dh, const void* g, const void* up, const void* offs,
                  int n_held, int rows, int width, void* dg, void* dup, cudaStream_t stream) {
    const size_t packs = static_cast<size_t>(rows) * width / Pack<T>::N;
    swiglu_bwd_kernel<T><<<grid(device, packs, THREADS), THREADS, 0, stream>>>(
        static_cast<const T*>(dh), static_cast<const T*>(g), static_cast<const T*>(up),
        static_cast<const int*>(offs), n_held, width, static_cast<T*>(dg),
        static_cast<T*>(dup));
  }
};

template <typename T>
struct Combine {
  static void run(int device, const void* y, const void* w, const void* slot, const void* offs,
                  int n_held, int k, int tokens, int width, void* out, cudaStream_t stream) {
    combine_kernel<T><<<grid(device, tokens, WARPS), THREADS, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const float*>(w), static_cast<const int*>(slot),
        static_cast<const int*>(offs), n_held, k, tokens, width, static_cast<T*>(out));
  }
};

template <typename T>
struct CombineBwd {
  static void run(int device, const void* dout, const void* y, const void* w, const void* slot,
                  const void* offs, int n_held, int k, int tokens, int width, void* dy, void* dw,
                  cudaStream_t stream) {
    combine_bwd_kernel<T><<<grid(device, tokens, WARPS), THREADS, 0, stream>>>(
        static_cast<const T*>(dout), static_cast<const T*>(y), static_cast<const float*>(w),
        static_cast<const int*>(slot), static_cast<const int*>(offs), n_held, k, tokens, width,
        static_cast<T*>(dy), static_cast<float*>(dw));
  }
};

}  // namespace

extern "C" {

int eav_moe_dispatch(int device, int dtype, const void* u, const void* order, const void* offs,
                     int n_held, int k, int rows, int width, void* x, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(by_dtype<Dispatch>(dtype, device, u, order, offs, n_held, k, rows,
                                             width, x, static_cast<cudaStream_t>(stream)));
}

int eav_moe_dispatch_bwd(int device, int dtype, const void* dx, const void* slot,
                         const void* offs, int n_held, int k, int tokens, int width, void* du,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(by_dtype<DispatchBwd>(dtype, device, dx, slot, offs, n_held, k,
                                                tokens, width, du,
                                                static_cast<cudaStream_t>(stream)));
}

int eav_moe_swiglu(int device, int dtype, const void* g, const void* up, const void* offs,
                   int n_held, int rows, int width, void* h, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(by_dtype<SwiGLU>(dtype, device, g, up, offs, n_held, rows, width, h,
                                           static_cast<cudaStream_t>(stream)));
}

int eav_moe_swiglu_bwd(int device, int dtype, const void* dh, const void* g, const void* up,
                       const void* offs, int n_held, int rows, int width, void* dg, void* dup,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(by_dtype<SwiGLUBwd>(dtype, device, dh, g, up, offs, n_held, rows,
                                              width, dg, dup,
                                              static_cast<cudaStream_t>(stream)));
}

int eav_moe_combine(int device, int dtype, const void* y, const void* w, const void* slot,
                    const void* offs, int n_held, int k, int tokens, int width, void* out,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(by_dtype<Combine>(dtype, device, y, w, slot, offs, n_held, k, tokens,
                                            width, out, static_cast<cudaStream_t>(stream)));
}

int eav_moe_combine_bwd(int device, int dtype, const void* dout, const void* y, const void* w,
                        const void* slot, const void* offs, int n_held, int k, int tokens,
                        int width, void* dy, void* dw, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(by_dtype<CombineBwd>(dtype, device, dout, y, w, slot, offs, n_held, k,
                                               tokens, width, dy, dw,
                                               static_cast<cudaStream_t>(stream)));
}

const char* eav_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
