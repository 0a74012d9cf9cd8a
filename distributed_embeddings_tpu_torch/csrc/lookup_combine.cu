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
// Two arms of one kernel, chosen by the `splits` pointer:
//
// - dense (splits == nullptr): row m's ids are ids[m * h .. m * h + h),
//   the padded [M, h] layout the distributed runtime routes;
// - row offsets (CSR): row m's ids are ids[splits[m] .. splits[m + 1]),
//   the capacity-padded CSR of a RaggedBatch (`h` is then the capacity
//   of `ids`, and no row reads past it).  This arm stands in for the JAX
//   package's XLA `_ragged_combine` (ops/embedding_lookup.py), which
//   gathers [nnz_cap, w] rows and segment-sums them; the reference runs
//   the same function in its CUDA kernel EmbeddingLookUpVariableHot,
//   which reads CSR directly, as this arm does.  Positions at or after
//   splits[M] (capacity padding) are never read.
//
// Everything else is shared: the same vector loads, f32 accumulation in
// ascending position order, `mean`'s max(count, 1) divisor and an
// all-zero row where a row has no valid id.
//
// The dequantizing arm (quantized table storage, docs/design.md §12):
// the table is an int8 or float8_e4m3 payload with one f32 power-of-two
// scale per row (`scale`, [rows]), and each valid id adds
//
//   payload[id, :] * scale[id]
//
// converted to f32 exactly and multiplied with __fmul_rn, then added
// with __fadd_rn, so the compiler never contracts the two into an FMA
// (the product is exact for a power-of-two scale, so a fused add would
// round the same; the intrinsics make the order of roundings the plain
// version's by construction).  It stands in for the JAX package's XLA
// `_fused_lookup` `scale` branch (parallel/dist_embedding.py), which
// gathers [.., h, w] rows, multiplies and sums; the Pallas kernel never
// had a dequantizing arm.  One byte per element: the vector is V = 8
// elements (8 B, the bf16 arm's geometry; see vector_width), one scale
// load per valid id, read by every thread of the row's group and served
// by L1 after the first.  It halves to a
// quarter the bytes each looked-up row costs beside bf16 / f32, and the
// f32 output dominates what is left.
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
#include <cuda_fp8.h>
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

template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <>
__device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);  // every e4m3 value is exact in f32
}

// one-byte payloads are quantized: they carry a per-row scale
template <typename T>
constexpr bool kScaled = sizeof(T) == 1;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kBlock)
    lookup_combine_kernel(const int32_t* __restrict__ ids,
                          const int32_t* __restrict__ splits,
                          const T* __restrict__ table,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int64_t m, int64_t h,
                          int64_t rows, int w, int tpr, int mean) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t r = g / tpr;
  if (r >= m) return;
  const int lane = static_cast<int>(g - r * tpr);
  const int32_t* row_ids;
  int64_t n;
  if (splits == nullptr) {
    row_ids = ids + r * h;
    n = h;
  } else {
    // clamped to the capacity h, so malformed splits never read past it
    int64_t lo = __ldg(splits + r), hi = __ldg(splits + r + 1);
    lo = lo < 0 ? 0 : (lo > h ? h : lo);
    hi = hi < lo ? lo : (hi > h ? h : hi);
    row_ids = ids + lo;
    n = hi - lo;
  }
  float* out_row = out + r * static_cast<int64_t>(w);
  for (int c = lane * V; c < w; c += tpr * V) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    int count = 0;
    for (int64_t j = 0; j < n; ++j) {
      const int32_t id = __ldg(row_ids + j);
      if (id < 0 || id >= rows) continue;
      ++count;
      const Vec<T, V> x = *reinterpret_cast<const Vec<T, V>*>(
          table + static_cast<int64_t>(id) * w + c);
      if constexpr (kScaled<T>) {
        const float s = __ldg(scale + id);
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(to_f32(x.v[k]), s));
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += to_f32(x.v[k]);
      }
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
cudaError_t launch(const int32_t* ids, const int32_t* splits, const T* table,
                   const float* scale, float* out, int64_t m, int64_t h,
                   int64_t rows, int w, int mean, cudaStream_t stream) {
  int tpr = (w + V - 1) / V;
  if (tpr > 32) tpr = 32;
  const int64_t threads = m * tpr;
  const int64_t blocks = (threads + kBlock - 1) / kBlock;
  lookup_combine_kernel<T, V><<<static_cast<unsigned>(blocks), kBlock, 0,
                                stream>>>(ids, splits, table, scale, out, m,
                                          h, rows, w, tpr, mean);
  return cudaGetLastError();
}

// Widest vector that divides the width and matches the alignment of the
// table and output pointers: 16 B of table elements, and at most 8
// elements.  A one-byte payload at 16 elements would give each thread a
// 64 B output row piece, stored as four 16 B stores at a 64 B stride
// across the warp (half-used sectors on every store): the DLRM's int8
// lookup ran at 46 % of its bound that way (0.624 ms against 0.285 on an
// H100), so one-byte payloads take the bf16 geometry, 8 elements.
template <typename T>
int vector_width(const void* table, const void* out, int w) {
  int v = 16 / static_cast<int>(sizeof(T));
  if (v > 8) v = 8;
  while (v > 1 &&
         (w % v != 0 ||
          reinterpret_cast<uintptr_t>(table) % (v * sizeof(T)) != 0 ||
          reinterpret_cast<uintptr_t>(out) % (v * sizeof(float)) != 0)) {
    v /= 2;
  }
  return v;
}

template <typename T>
cudaError_t dispatch(const int32_t* ids, const int32_t* splits,
                     const void* table_ptr, const float* scale, float* out,
                     int64_t m, int64_t h, int64_t rows, int w, int mean,
                     cudaStream_t stream) {
  const auto* table = static_cast<const T*>(table_ptr);
  switch (vector_width<T>(table, out, w)) {
    case 8:
      if constexpr (sizeof(T) <= 2)
        return launch<T, 8>(ids, splits, table, scale, out, m, h, rows, w,
                            mean, stream);
      return cudaErrorInvalidValue;
    case 4:
      return launch<T, 4>(ids, splits, table, scale, out, m, h, rows, w,
                          mean, stream);
    case 2:
      return launch<T, 2>(ids, splits, table, scale, out, m, h, rows, w,
                          mean, stream);
    default:
      return launch<T, 1>(ids, splits, table, scale, out, m, h, rows, w,
                          mean, stream);
  }
}

}  // namespace

// Dense arm (splits == NULL): ids [m, h] int32.  Row-offsets arm: ids
// [h] int32 (the CSR values, h their capacity), splits [m + 1] int32.
// table: [rows, w] of table_kind 0 f32, 1 bf16, 2 int8 or 3 float8_e4m3
// (the last two dequantize with scale [rows] f32, which they require);
// out: [m, w] f32.  All contiguous, on the current device.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lookup_combine(const void* ids, const void* splits,
                              const void* table, const void* scale,
                              void* out, long long m, long long h,
                              long long rows, int w, int table_kind,
                              int mean, void* stream) {
  if (m <= 0) return 0;
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* sp = static_cast<const int32_t*>(splits);
  const auto* sc = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if ((table_kind >= 2) != (sc != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (table_kind) {
    case 0:
      err = dispatch<float>(i, sp, table, sc, o, m, h, rows, w, mean, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(i, sp, table, sc, o, m, h, rows, w, mean,
                                    s);
      break;
    case 2:
      err = dispatch<int8_t>(i, sp, table, sc, o, m, h, rows, w, mean, s);
      break;
    case 3:
      err = dispatch<__nv_fp8_e4m3>(i, sp, table, sc, o, m, h, rows, w, mean,
                                    s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
