// Segment-walk sparse optimizer apply for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_segwalk.py
// `_segwalk_kernel` (called through `segwalk_apply`).  Over an update
// stream sorted by row id, each distinct row's run of gradient rows is
// summed and the row is updated once, in place:
//
//   sgd:            t -= lr * S
//   adagrad_dedup:  a += S * S;       t -= lr * S * rsqrt(a + eps)
//   adagrad_sq:     a += sum(g * g);  t -= lr * S * rsqrt(a + eps)
//
// with S the f32 sum of the run's gradient rows in ascending stream
// position.  The wrapper (ops/segwalk.py) sorts the stream (a stable
// torch sort) and cuts it into segments: segment s covers sorted
// positions [starts[s], ends[s]) of one valid row id, and gidx[p] names
// the gradient row of position p (a compact per-(sample, bag) row, or
// the occurrence itself).  Rows no segment names are never touched, so
// they stay bitwise unchanged (the TPU kernel's input_output_aliases
// contract).
//
// Arithmetic: every product, sum and difference is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc cannot contract `a + S*S`
// or `t - lr*S*r` into an FMA (the hazard `_rounded_square` guards in the
// JAX package); rsqrt is 1 / sqrt with both correctly rounded
// (__fsqrt_rn, __fdiv_rn), which the plain PyTorch version computes the
// same way.  A bf16 table is read up to f32, updated in f32 and rounded
// once, to nearest even, at the store.  The accumulator is f32.
//
// What bounds it: device-memory bytes.  The least traffic is the sorted
// ids and gradient-row indices, the compact gradient rows, and one read
// and one write of the table row (and accumulator row) of each distinct
// id; a handful of flops per element.  The TPU kernel's lane packing,
// pair fetch, SMEM sideband and DMA parity protocol fed the TPU's 512 B
// bursts and (8, 128) tiles; on Hopper a 32 B sector is the unit of a
// random read, so rows stay in natural [rows, w] layout.
//
// Design (simple and deterministic, no atomics): a group of `tpr`
// threads owns one segment; each thread holds V consecutive columns of
// the row (16 B of f32 when the width allows).  The group walks its
// segment's gradient rows in ascending position, then reads, updates and
// writes the table row and the accumulator row once.  A long segment
// (a hot id) serialises on its one group: the walk's loads are unrolled
// so several rows are in flight, but the time of the whole apply is at
// least that of the longest segment.  Splitting long segments across
// groups is later work.
//
// Plain C interface, loaded with ctypes.  The launch goes on the stream
// the caller passes (PyTorch's current stream); the function does not
// synchronise, allocates nothing, and returns the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kSgd = 0;
constexpr int kAdagradDedup = 1;
constexpr int kAdagradSq = 2;

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V, int OP>
__global__ void __launch_bounds__(kBlock)
    segwalk_apply_kernel(const int32_t* __restrict__ sid,
                         const int32_t* __restrict__ gidx,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ ends,
                         const float* __restrict__ grads,
                         T* __restrict__ table, float* __restrict__ acc,
                         int64_t segments, int w, int tpr, float lr,
                         float eps) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t s = g / tpr;
  if (s >= segments) return;
  const int lane = static_cast<int>(g - s * tpr);
  const int32_t begin = starts[s];
  const int32_t end = ends[s];
  const int64_t row = sid[begin];
  for (int c = lane * V; c < w; c += tpr * V) {
    float sum[V];
    float sq[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sum[k] = 0.0f;
      sq[k] = 0.0f;
    }
#pragma unroll 4
    for (int32_t p = begin; p < end; ++p) {
      const int64_t r = __ldg(gidx + p);
      const Vec<float, V> x =
          *reinterpret_cast<const Vec<float, V>*>(grads + r * w + c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sum[k] = __fadd_rn(sum[k], x.v[k]);
        if (OP == kAdagradSq) {
          sq[k] = __fadd_rn(sq[k], __fmul_rn(x.v[k], x.v[k]));
        }
      }
    }
    const int64_t off = row * w + c;
    Vec<T, V> t = *reinterpret_cast<const Vec<T, V>*>(table + off);
    if (OP == kSgd) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        t.v[k] = from_f32<T>(
            __fsub_rn(to_f32(t.v[k]), __fmul_rn(lr, sum[k])));
      }
    } else {
      Vec<float, V> a = *reinterpret_cast<const Vec<float, V>*>(acc + off);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float add =
            OP == kAdagradDedup ? __fmul_rn(sum[k], sum[k]) : sq[k];
        a.v[k] = __fadd_rn(a.v[k], add);
        const float scale =
            __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a.v[k], eps)));
        t.v[k] = from_f32<T>(__fsub_rn(
            to_f32(t.v[k]), __fmul_rn(__fmul_rn(lr, sum[k]), scale)));
      }
      *reinterpret_cast<Vec<float, V>*>(acc + off) = a;
    }
    *reinterpret_cast<Vec<T, V>*>(table + off) = t;
  }
}

template <typename T, int V>
cudaError_t launch(const int32_t* sid, const int32_t* gidx,
                   const int32_t* starts, const int32_t* ends,
                   const float* grads, T* table, float* acc,
                   int64_t segments, int w, int op, float lr, float eps,
                   cudaStream_t stream) {
  int tpr = (w + V - 1) / V;
  if (tpr > 32) tpr = 32;
  const int64_t threads = segments * tpr;
  const unsigned blocks =
      static_cast<unsigned>((threads + kBlock - 1) / kBlock);
  switch (op) {
    case kSgd:
      segwalk_apply_kernel<T, V, kSgd><<<blocks, kBlock, 0, stream>>>(
          sid, gidx, starts, ends, grads, table, acc, segments, w, tpr, lr,
          eps);
      break;
    case kAdagradDedup:
      segwalk_apply_kernel<T, V, kAdagradDedup>
          <<<blocks, kBlock, 0, stream>>>(sid, gidx, starts, ends, grads,
                                          table, acc, segments, w, tpr, lr,
                                          eps);
      break;
    case kAdagradSq:
      segwalk_apply_kernel<T, V, kAdagradSq><<<blocks, kBlock, 0, stream>>>(
          sid, gidx, starts, ends, grads, table, acc, segments, w, tpr, lr,
          eps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Widest vector (4 elements at most: 16 B of f32) that divides the width
// and matches the alignment of the table, accumulator and gradient rows.
template <typename T>
int vector_width(const void* table, const void* acc, const void* grads,
                 int w) {
  int v = 4;
  while (v > 1 &&
         (w % v != 0 ||
          reinterpret_cast<uintptr_t>(table) % (v * sizeof(T)) != 0 ||
          reinterpret_cast<uintptr_t>(acc) % (v * sizeof(float)) != 0 ||
          reinterpret_cast<uintptr_t>(grads) % (v * sizeof(float)) != 0)) {
    v /= 2;
  }
  return v;
}

template <typename T>
cudaError_t dispatch(const int32_t* sid, const int32_t* gidx,
                     const int32_t* starts, const int32_t* ends,
                     const float* grads, T* table, float* acc,
                     int64_t segments, int w, int op, float lr, float eps,
                     cudaStream_t stream) {
  switch (vector_width<T>(table, acc, grads, w)) {
    case 4:
      return launch<T, 4>(sid, gidx, starts, ends, grads, table, acc,
                          segments, w, op, lr, eps, stream);
    case 2:
      return launch<T, 2>(sid, gidx, starts, ends, grads, table, acc,
                          segments, w, op, lr, eps, stream);
    default:
      return launch<T, 1>(sid, gidx, starts, ends, grads, table, acc,
                          segments, w, op, lr, eps, stream);
  }
}

}  // namespace

// sid: [n] int32 sorted row ids; gidx: [n] int32 gradient row of each
// sorted position; starts / ends: [segments] int32 position ranges of the
// valid segments; grads: [m, w] f32; table: [rows, w] f32 (table_bf16 ==
// 0) or bf16, updated in place; acc: [rows, w] f32, updated in place
// (null for sgd).  op: 0 sgd, 1 adagrad_dedup, 2 adagrad_sq.  All
// contiguous, on the current device.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int segwalk_apply(const void* sid, const void* gidx,
                             const void* starts, const void* ends,
                             const void* grads, void* table, void* acc,
                             long long segments, int w, int table_bf16,
                             int op, float lr, float eps, void* stream) {
  if (segments <= 0) return 0;
  const auto* i = static_cast<const int32_t*>(sid);
  const auto* x = static_cast<const int32_t*>(gidx);
  const auto* b = static_cast<const int32_t*>(starts);
  const auto* e = static_cast<const int32_t*>(ends);
  const auto* g = static_cast<const float*>(grads);
  auto* a = static_cast<float*>(acc);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      table_bf16
          ? dispatch(i, x, b, e, g, static_cast<__nv_bfloat16*>(table), a,
                     segments, w, op, lr, eps, s)
          : dispatch(i, x, b, e, g, static_cast<float*>(table), a, segments,
                     w, op, lr, eps, s);
  return static_cast<int>(err);
}
