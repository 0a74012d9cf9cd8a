// Fused gather-combine embedding lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_lookup.py
// `_dense_lookup_kernel` (called through `_dense_lookup_sum`), together
// with the `mean` tail `dense_lookup` applies after it:
//
//   out[m, :] = sum_{j < h, 0 <= ids[m, j] < rows} table[ids[m, j], :]
//
// accumulated in f32 as a left fold over the bag's positions in
// ascending order (the order of both plain versions, so both kernels
// are bit-exact against them at every hotness); `mean` divides by the number
// of valid ids (at least 1).  Ids outside [0, rows) are padding: they
// contribute nothing and are never dereferenced, so a row with no valid
// id is zero.  The table is f32 or bf16, stored in natural row-major
// [rows, w] layout; any width is served.
//
// Two layouts of the ids, chosen by the `splits` pointer:
//
// - dense (splits == nullptr): row m's ids are ids[m * h .. m * h + h),
//   the padded [M, h] layout the distributed runtime routes;
// - row offsets (CSR): row m's ids are ids[splits[m] .. splits[m + 1]),
//   clamped to [0, h] and cut at splits[M], the capacity-padded CSR of
//   a RaggedBatch (`h` is the capacity of `ids`, and no row reads past
//   it).  This layout stands in for the JAX package's XLA
//   `_ragged_combine` (ops/embedding_lookup.py), which gathers
//   [nnz_cap, w] rows and segment-sums them; the reference runs the same
//   function in its CUDA kernel EmbeddingLookUpVariableHot, which reads
//   CSR directly, as this does.  Positions at or after splits[M]
//   (capacity padding) are never read.
//
// The dequantizing payloads (quantized table storage, docs/design.md
// §12): the table is an int8 or float8_e4m3 payload with one f32
// power-of-two scale per row (`scale`, [rows]), and each valid id adds
//
//   payload[id, :] * scale[id]
//
// converted to f32 exactly and multiplied with __fmul_rn, then added
// with __fadd_rn, so the compiler never contracts the two into an FMA
// (the product is exact for a power-of-two scale; the intrinsics make
// the order of roundings the plain version's by construction).  It
// stands in for the JAX package's XLA `_fused_lookup` `scale` branch
// (parallel/dist_embedding.py); the Pallas kernel never had one.
//
// What bounds it (H100, 3.35 TB/s device memory, 50 MB L2):
//
// - multi-hot bags: the L2 traffic of rows repeated within a bag and
//   across neighbouring bags.  The ids are power-law (models/
//   synthetic.py), so a bag of 30 ids names the same hot rows again and
//   again: Small V3's [327680, 30] lookup on a 4.2 MB table gathers
//   315 MB of rows that all sit in L2, against about 64 MB of ids,
//   output and distinct rows;
// - hotness 1: the f32 output write (872 MB of the DLRM lookup's
//   1027 MB), and the latency of one dependent id -> row chain.
//
// Design: two kernels behind the one entry point, chosen by the shape.
//
// - Hotness 1, dense (direct_one_kernel): a thread group owns
//   kOneHotRows = 2 output rows.  A warp loads its rows' ids once as one
//   coalesced vector and hands them out with __shfl_sync, then issues
//   both row loads before any store.  Output stores are streaming
//   (__stcs, evict-first), so the output stream does not evict the
//   table's rows from L2, and a table of at most kKeepTableBytes is read
//   with an L2 evict-last policy.
// - Multi-hot and CSR bags (direct_multi_kernel): a group of `tpr`
//   threads owns one bag and walks its ids in order, each thread adding
//   V columns of each valid row (16 B vectors where the width and the
//   alignment allow).  Narrow widths put many bags in one warp, which
//   keeps many independent row reads in flight per SM.
//
// A third design, multi-hot bags summed from each chunk's distinct rows
// staged once in shared memory (cp.async copies, an open-addressing slot
// table), was built and measured on an H100 and ran slower than
// direct_multi_kernel at every shape the port runs; PERF.md §6 has its
// times.  Each chunk was a chain of dependent steps separated by block
// barriers, and it cost more than the L2 reads it saved.
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
constexpr int kWarps = kBlock / 32;
// output rows a thread group owns at hotness 1, all their row loads
// issued before any store
constexpr int kOneHotRows = 2;
constexpr int64_t kKeepTableBytes = 16ll << 20;  // a third of L2

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

template <int B>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<1> {
  using type = unsigned char;
};

// One V-wide piece of a table row from device memory: read-only path,
// with the L2 evict-last policy when `keep` (a small table).
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_row(const T* p, bool keep,
                                              uint64_t policy) {
  constexpr int B = static_cast<int>(sizeof(T)) * V;
  using R = typename Raw<B>::type;
  R raw;
  if constexpr (B == 16) {
    if (keep) {
      asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
          : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
          : "l"(p), "l"(policy));
    } else {
      raw = __ldg(reinterpret_cast<const R*>(p));
    }
  } else if constexpr (B == 8) {
    if (keep) {
      asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
          : "=r"(raw.x), "=r"(raw.y)
          : "l"(p), "l"(policy));
    } else {
      raw = __ldg(reinterpret_cast<const R*>(p));
    }
  } else if constexpr (B == 4) {
    if (keep) {
      asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
          : "=r"(raw)
          : "l"(p), "l"(policy));
    } else {
      raw = __ldg(reinterpret_cast<const R*>(p));
    }
  } else {
    raw = __ldg(reinterpret_cast<const R*>(p));
  }
  Vec<T, V> x;
  *reinterpret_cast<R*>(&x) = raw;
  return x;
}

// V f32 outputs, streaming (evict-first): the output is written once and
// never read here, so it should not displace the table's rows in L2.
template <int V>
__device__ __forceinline__ void store_out(float* p, const float* a) {
  if constexpr (V == 8) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(a[4], a[5], a[6], a[7]));
  } else if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
  } else {
    __stcs(p, a[0]);
  }
}

// acc += x (a plain table), or acc += x * s with the plain version's two
// roundings (a quantized one)
template <typename T, int V>
__device__ __forceinline__ void add_row(float* acc, const Vec<T, V>& x,
                                        float s) {
  if constexpr (kScaled<T>) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(to_f32(x.v[k]), s));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += to_f32(x.v[k]);
  }
}

template <int V>
__device__ __forceinline__ void finish(float* acc, int count, int mean) {
  if (mean) {
    const float d = static_cast<float>(count > 1 ? count : 1);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = acc[k] / d;
  }
}

// A CSR row's [lo, hi), clamped to the capacity h and cut at splits[m],
// so malformed splits never read past the capacity nor count capacity
// padding (the plain version's rule).
__device__ __forceinline__ void csr_range(const int32_t* splits, int64_t r,
                                          int64_t h, int64_t m, int64_t* lo,
                                          int64_t* hi) {
  auto clamp = [h](int64_t x) { return x < 0 ? 0 : (x > h ? h : x); };
  const int64_t a = clamp(__ldg(splits + r));
  const int64_t end = clamp(__ldg(splits + m));
  int64_t b = clamp(__ldg(splits + r + 1));
  b = b < end ? b : end;
  *lo = a;
  *hi = b < a ? a : b;
}

// ------------------------------------------------------------ kernels

// Hotness 1, dense: R rows a group, all R row loads issued before any
// store.  A warp owns gpw * R consecutive bags: group g of the warp owns
// bags base + k * gpw + g (k < R), so a warp's k-th stores are one
// contiguous run of output rows.
template <typename T, int V, int R>
__global__ void __launch_bounds__(kBlock)
    direct_one_kernel(const int32_t* __restrict__ ids,
                      const T* __restrict__ table,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int64_t m, int64_t rows, int w,
                      int tpr, int gpw, int keep) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
  const int64_t base = warp * gpw * R;
  if (base >= m) return;  // uniform across the warp
  const int gi = lane / tpr;  // the lane's group in its warp
  const int li = lane - gi * tpr;
  const bool active = gi < gpw;
  const int g = active ? gi : 0;
  uint64_t policy = 0;
  if (keep) asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                : "=l"(policy));
  // the warp's gpw * R ids, one coalesced load, handed out by shuffles
  int32_t reg[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = i * 32 + lane;
    reg[i] = (s < gpw * R && base + s < m) ? __ldg(ids + base + s) : -1;
  }
  int64_t bag[R];
  int32_t id[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    bag[k] = base + k * gpw + g;
    const int s = k * gpw + g;
    int32_t v = -1;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int32_t t = __shfl_sync(0xffffffffu, reg[i], s & 31);
      if (i == (s >> 5)) v = t;
    }
    id[k] = active && bag[k] < m && v >= 0 && v < rows ? v : -1;
  }
  if (!active) return;
  float sc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    sc[k] = 0.0f;
    if constexpr (kScaled<T>) {
      if (id[k] >= 0) sc[k] = __ldg(scale + id[k]);
    }
  }
  for (int c = li * V; c < w; c += tpr * V) {
    Vec<T, V> x[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (id[k] >= 0)
        x[k] = load_row<T, V>(table + static_cast<int64_t>(id[k]) * w + c,
                              keep, policy);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (bag[k] >= m) continue;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
      if (id[k] >= 0) add_row<T, V>(acc, x[k], sc[k]);
      // a mean of one id divides by 1: exact, left out
      store_out<V>(out + bag[k] * w + c, acc);
    }
  }
}

// Multi-hot or CSR: a group of tpr threads owns one bag and walks its
// ids in order, each thread adding V columns of each valid row.
template <typename T, int V>
__global__ void __launch_bounds__(kBlock)
    direct_multi_kernel(const int32_t* __restrict__ ids,
                        const int32_t* __restrict__ splits,
                        const T* __restrict__ table,
                        const float* __restrict__ scale,
                        float* __restrict__ out, int64_t m, int64_t h,
                        int64_t rows, int w, int tpr, int mean) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t r = g / tpr;
  if (r >= m) return;
  const int lane = static_cast<int>(g - r * tpr);
  int64_t lo, n;
  if (splits == nullptr) {
    lo = r * h;
    n = h;
  } else {
    int64_t hi;
    csr_range(splits, r, h, m, &lo, &hi);
    n = hi - lo;
  }
  const int32_t* bag = ids + lo;
  float* out_row = out + r * static_cast<int64_t>(w);
  for (int c = lane * V; c < w; c += tpr * V) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    int count = 0;
    for (int64_t j = 0; j < n; ++j) {
      const int32_t id = __ldg(bag + j);
      if (id < 0 || id >= rows) continue;
      ++count;
      const Vec<T, V> x = *reinterpret_cast<const Vec<T, V>*>(
          table + static_cast<int64_t>(id) * w + c);
      add_row<T, V>(acc, x, kScaled<T> ? __ldg(scale + id) : 0.0f);
    }
    finish<V>(acc, count, mean);
    Vec<float, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.v[k] = acc[k];
    *reinterpret_cast<Vec<float, V>*>(out_row + c) = o;
  }
}

// ------------------------------------------------------------ host side

// Widest vector of V elements that divides the width and matches the
// table's and the output's alignment: 16 B of table elements, and at
// most 8 elements.  A one-byte payload at 16 elements would give each
// thread a 64 B output row piece, stored as four 16 B stores at a 64 B
// stride across the warp (half-used sectors on every store): the DLRM's
// int8 lookup ran at 46 % of its bound that way (0.624 ms against 0.285
// on an H100), so one-byte payloads take the bf16 geometry, 8 elements.
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

template <typename T, int V>
cudaError_t launch(const int32_t* ids, const int32_t* splits,
                   const T* table, const float* scale, float* out, int64_t m,
                   int64_t h, int64_t rows, int w, int mean,
                   cudaStream_t stream) {
  const int vectors = (w + V - 1) / V;
  const int tpr = vectors < 32 ? vectors : 32;
  if (splits == nullptr && h == 1) {
    const int gpw = 32 / tpr;
    const int keep =
        rows * w * static_cast<int64_t>(sizeof(T)) <= kKeepTableBytes;
    const int64_t warps = (m + gpw * kOneHotRows - 1) / (gpw * kOneHotRows);
    direct_one_kernel<T, V, kOneHotRows>
        <<<static_cast<unsigned>((warps + kWarps - 1) / kWarps), kBlock, 0,
           stream>>>(ids, table, scale, out, m, rows, w, tpr, gpw, keep);
  } else {
    const int64_t threads = m * tpr;
    direct_multi_kernel<T, V>
        <<<static_cast<unsigned>((threads + kBlock - 1) / kBlock), kBlock, 0,
           stream>>>(ids, splits, table, scale, out, m, h, rows, w, tpr,
                     mean);
  }
  return cudaGetLastError();
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

// Dense layout (splits == NULL): ids [m, h] int32.  Row offsets: ids [h]
// int32 (the CSR values, h their capacity), splits [m + 1] int32.
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
