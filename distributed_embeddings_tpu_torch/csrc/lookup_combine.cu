// Fused gather-combine embedding lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_lookup.py
// `_dense_lookup_kernel` (called through `_dense_lookup_sum`), together
// with the `mean` tail `dense_lookup` applies after it:
//
//   out[m, :] = sum_{j < h, 0 <= ids[m, j] < rows} table[ids[m, j], :]
//
// accumulated in f32 with the j sum in ascending order; `mean` divides by
// the number of valid ids (at least 1).  Ids outside [0, rows) are
// padding: they contribute nothing and are never dereferenced, so a row
// with no valid id is zero.  The table is f32 or bf16, stored in natural
// row-major [rows, w] layout; any width is served.
//
// What bounds it: device-memory bytes.  Each valid id costs one random
// row read of w * itemsize bytes (32 or 64 B at the widths of the
// synthetic tiny model) and adds w floats: about 0.25 flop per byte,
// two to three orders of magnitude below the card's compute-to-bandwidth
// ratio.  The TPU kernel's lane packing, pair fetch and stripes were
// remedies for the TPU's 512 B HBM burst and (8, 128) tiling; on Hopper a
// 32 B sector is the unit of a random read, so natural layout wastes
// nothing at w * itemsize >= 32 B.
//
// Design: a group of `tpr` threads owns one output row.  Each thread
// loads V consecutive elements of the row at once (16 B: V = 4 for f32,
// 8 for bf16, when the width and the table's alignment allow it), so a
// row read is a few full-sector vector loads, neighbouring threads read
// neighbouring addresses, and the output row is written once with vector
// stores.  Narrow widths put many rows in one warp (16 rows per warp at
// w = 8 f32), which keeps many independent row reads in flight per SM;
// the ids of a row are read by every thread of its group and are served
// by L1 after the first.  Nothing is staged in shared memory: every byte
// is read once and used once.
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

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kBlock)
    lookup_combine_kernel(const int32_t* __restrict__ ids,
                          const T* __restrict__ table,
                          float* __restrict__ out, int64_t m, int h,
                          int64_t rows, int w, int tpr, int mean) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t r = g / tpr;
  if (r >= m) return;
  const int lane = static_cast<int>(g - r * tpr);
  const int32_t* row_ids = ids + r * h;
  float* out_row = out + r * static_cast<int64_t>(w);
  for (int c = lane * V; c < w; c += tpr * V) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    int count = 0;
    for (int j = 0; j < h; ++j) {
      const int32_t id = __ldg(row_ids + j);
      if (id < 0 || id >= rows) continue;
      ++count;
      const Vec<T, V> x = *reinterpret_cast<const Vec<T, V>*>(
          table + static_cast<int64_t>(id) * w + c);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += to_f32(x.v[k]);
    }
    if (mean) {
      const float d = static_cast<float>(count > 1 ? count : 1);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = acc[k] / d;
    }
    Vec<float, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.v[k] = acc[k];
    *reinterpret_cast<Vec<float, V>*>(out_row + c) = o;
  }
}

template <typename T, int V>
cudaError_t launch(const int32_t* ids, const T* table, float* out, int64_t m,
                   int h, int64_t rows, int w, int mean,
                   cudaStream_t stream) {
  int tpr = (w + V - 1) / V;
  if (tpr > 32) tpr = 32;
  const int64_t threads = m * tpr;
  const int64_t blocks = (threads + kBlock - 1) / kBlock;
  lookup_combine_kernel<T, V><<<static_cast<unsigned>(blocks), kBlock, 0,
                                stream>>>(ids, table, out, m, h, rows, w, tpr,
                                          mean);
  return cudaGetLastError();
}

// Widest vector (16 B at most) that divides the width and matches the
// alignment of the table and output pointers.
template <typename T>
int vector_width(const void* table, const void* out, int w) {
  int v = 16 / static_cast<int>(sizeof(T));
  while (v > 1 &&
         (w % v != 0 ||
          reinterpret_cast<uintptr_t>(table) % (v * sizeof(T)) != 0 ||
          reinterpret_cast<uintptr_t>(out) % (v * sizeof(float)) != 0)) {
    v /= 2;
  }
  return v;
}

template <typename T>
cudaError_t dispatch(const int32_t* ids, const T* table, float* out,
                     int64_t m, int h, int64_t rows, int w, int mean,
                     cudaStream_t stream) {
  switch (vector_width<T>(table, out, w)) {
    case 8:
      return launch<T, 8>(ids, table, out, m, h, rows, w, mean, stream);
    case 4:
      return launch<T, 4>(ids, table, out, m, h, rows, w, mean, stream);
    case 2:
      return launch<T, 2>(ids, table, out, m, h, rows, w, mean, stream);
    default:
      return launch<T, 1>(ids, table, out, m, h, rows, w, mean, stream);
  }
}

}  // namespace

// ids: [m, h] int32; table: [rows, w] f32 (table_bf16 == 0) or bf16;
// out: [m, w] f32.  All contiguous, on the current device.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lookup_combine(const void* ids, const void* table, void* out,
                              long long m, int h, long long rows, int w,
                              int table_bf16, int mean, void* stream) {
  if (m <= 0) return 0;
  const auto* i = static_cast<const int32_t*>(ids);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      table_bf16 ? dispatch(i, static_cast<const __nv_bfloat16*>(table), o,
                            m, h, rows, w, mean, s)
                 : dispatch(i, static_cast<const float*>(table), o, m, h,
                            rows, w, mean, s);
  return static_cast<int>(err);
}
