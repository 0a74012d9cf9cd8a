// Segment-walk sparse optimizer apply for Hopper (sm_90a): a chunked
// segmented reduction over the sorted update stream.
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_segwalk.py
// `_segwalk_kernel` (called through `segwalk_apply`).  Over an update
// stream sorted by row id, each distinct row's run of gradient rows is
// summed and the row is updated once, in place:
//
//   sgd:            t -= lr * S
//   adagrad_dedup:  a += S * S;       t -= lr * S * rsqrt(a + eps)
//   adagrad_sq:     a += sum(g * g);  t -= lr * S * rsqrt(a + eps)
//   add:            t += S
//
// `add` (no learning rate, no accumulator) is the backward of the lookup
// kernel: the wrapper zero-fills a table-shaped gradient and adds each
// distinct row's summed cotangent rows into it, the port's counterpart of
// the JAX lookup's VJP `_dl_bwd` (distributed_embeddings_tpu/ops/
// pallas_lookup.py, an XLA segment_sum).  It is `sgd` at lr = -1, bit for
// bit: -1 * S is exact and t - (-S) rounds as t + S does.
//
// The wrapper (ops/segwalk.py) sorts the stream (a stable torch sort):
// sorted position p holds row id sid[p] and gradient row gidx[p] (a
// compact per-(sample, bag) row, or the occurrence itself).  A segment is
// the run of positions of one id; ids outside [0, rows) are padding and
// after the sort sit only at the two ends of the stream.  Rows no segment
// names are never touched, so they stay bitwise unchanged (the TPU
// kernel's input_output_aliases contract).
//
// Summation order, the contract this kernel and the plain PyTorch version
// (ops/segwalk.py `_apply_plain`) share.  C is the chunk length
// (ops/segwalk.py CHUNK, passed in by the wrapper; it depends on nothing
// else).  Chunk k is the sorted positions [k*C, (k+1)*C).  A segment's
// partial in a chunk is the left fold, from +0, of its gradient rows in
// that chunk in ascending position; its sum S is the left fold, from +0,
// of its partials in ascending chunk order.  For adagrad_sq the sum of
// squares follows the same order.  A segment that lies inside one chunk
// is thus the plain left fold of its positions.
//
// Arithmetic: every product, sum and difference is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc cannot contract `a + S*S`
// or `t - lr*S*r` into an FMA (the hazard `_rounded_square` guards in the
// JAX package); rsqrt is 1 / sqrt with both correctly rounded
// (__fsqrt_rn, __fdiv_rn), which the plain PyTorch version computes the
// same way.  A bf16 table is read up to f32, updated in f32 and rounded
// once, to nearest even, at the store.  The accumulator is f32.
//
// Design: two passes, no atomics, the same result on every run, and
// grids sized from the stream length alone (the host reads nothing back).
//
// - Pass 1 (`chunk_pass`), one block per chunk, keeps the TPU kernel's
//   tiles.  The block loads the chunk's ids and gradient-row indices
//   coalesced into shared memory, finds the run heads by comparing
//   neighbouring ids (a ballot and a prefix count), then gathers the
//   chunk's gradient rows into shared memory, kUnroll 16-byte loads in
//   flight per thread, in column tiles of up to 32 columns.  One thread
//   per (run, 4 columns) folds the run from shared memory.  A run that
//   starts and ends inside the chunk is applied at once: one read and
//   one write of its table row (and accumulator row).  A run that
//   crosses the chunk's first or last boundary leaves its partial (and
//   squares) in a [chunks, 2, w] f32 buffer: slot 0 for a run that
//   continues a segment begun in an earlier chunk, slot 1 for the run
//   that begins one.  A chunk inside one run writes its whole partial
//   once, into slot 0.
// - Pass 2 (`merge_pass`), one warp per chunk.  Only a chunk in which a
//   boundary-crossing valid segment begins does work: it finds the
//   segment's last position by binary search over the sorted ids, folds
//   its slot-1 partial and the slot-0 partials of the following chunks
//   in ascending order, and applies the segment once.
//
// The TPU kernel carries the run that crosses a tile boundary to the next
// grid step in scratch memory; Hopper's blocks run in no order, so the
// second pass takes the carry's place.  A hot id of L positions costs
// about C shared-memory adds in each of its L / C chunks, in parallel,
// plus L / C partial loads in pass 2: no thread walks all L positions.
//
// What bounds it: device-memory bytes.  The sorted ids and indices are
// read coalesced; the gradient rows are gathered in 32 B or 64 B sectors
// (w8, w16 f32); each distinct row of the table (and accumulator) is read
// and written once, at random (64 B rows of the 4.5 GB w16 table); a
// handful of flops per element.  The TPU kernel's lane packing, pair
// fetch, SMEM sideband and DMA parity protocol fed the TPU's 512 B bursts
// and (8, 128) tiles; on Hopper a 32 B sector is the unit of a random
// read, so rows stay in natural [rows, w] layout.
//
// Plain C interface, loaded with ctypes.  Both launches go on the stream
// the caller passes (PyTorch's current stream); the function does not
// synchronise, allocates nothing (the wrapper allocates the partials),
// and returns the cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kTile = 32;   // columns of a chunk's rows staged at once
constexpr int kUnroll = 4;  // gradient-row loads in flight per thread
constexpr int kSgd = 0;
constexpr int kAdagradDedup = 1;
constexpr int kAdagradSq = 2;
constexpr int kAdd = 3;

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

template <int V>
__device__ __forceinline__ Vec<float, V> load_f32(const float* p) {
  return *reinterpret_cast<const Vec<float, V>*>(p);
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[V]) {
  Vec<float, V> v;
#pragma unroll
  for (int k = 0; k < V; ++k) v.v[k] = x[k];
  *reinterpret_cast<Vec<float, V>*>(p) = v;
}

// sum += x (and sq += x * x for adagrad_sq), each op rounded on its own.
template <int V, int OP>
__device__ __forceinline__ void fold(float (&sum)[V], float (&sq)[V],
                                     const Vec<float, V>& x) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sum[k] = __fadd_rn(sum[k], x.v[k]);
    if (OP == kAdagradSq) sq[k] = __fadd_rn(sq[k], __fmul_rn(x.v[k], x.v[k]));
  }
}

// Adds partial `x` (and squares `xq`) into sum (and sq).
template <int V, int OP>
__device__ __forceinline__ void merge(float (&sum)[V], float (&sq)[V],
                                      const float* x, const float* xq) {
  const Vec<float, V> s = load_f32<V>(x);
#pragma unroll
  for (int k = 0; k < V; ++k) sum[k] = __fadd_rn(sum[k], s.v[k]);
  if (OP == kAdagradSq) {
    const Vec<float, V> q = load_f32<V>(xq);
#pragma unroll
    for (int k = 0; k < V; ++k) sq[k] = __fadd_rn(sq[k], q.v[k]);
  }
}

// The update of V columns of one row at element offset `off`.
template <typename T, int V, int OP>
__device__ __forceinline__ void apply_row(T* table, float* acc, int64_t off,
                                          const float (&sum)[V],
                                          const float (&sq)[V], float lr,
                                          float eps) {
  Vec<T, V> t = *reinterpret_cast<const Vec<T, V>*>(table + off);
  if (OP == kSgd) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      t.v[k] = from_f32<T>(__fsub_rn(to_f32(t.v[k]), __fmul_rn(lr, sum[k])));
    }
  } else if (OP == kAdd) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      t.v[k] = from_f32<T>(__fadd_rn(to_f32(t.v[k]), sum[k]));
    }
  } else {
    Vec<float, V> a = load_f32<V>(acc + off);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float add =
          OP == kAdagradDedup ? __fmul_rn(sum[k], sum[k]) : sq[k];
      a.v[k] = __fadd_rn(a.v[k], add);
      const float scale = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a.v[k], eps)));
      t.v[k] = from_f32<T>(__fsub_rn(
          to_f32(t.v[k]), __fmul_rn(__fmul_rn(lr, sum[k]), scale)));
    }
    *reinterpret_cast<Vec<float, V>*>(acc + off) = a;
  }
  *reinterpret_cast<Vec<T, V>*>(table + off) = t;
}

// Pass 1: block b folds the runs of chunk b.  Dynamic shared memory:
// the staged gradient rows [chunk, min(w, kTile)] f32, then the chunk's
// ids, gradient-row indices and run heads (chunk + 1), int32.
// part: [chunks, 2, w] partial sums, then (adagrad_sq) as many squares.
template <typename T, int V, int OP>
__global__ void __launch_bounds__(kBlock)
    chunk_pass(const int32_t* __restrict__ sid,
               const int32_t* __restrict__ gidx,
               const float* __restrict__ grads, T* __restrict__ table,
               float* __restrict__ acc, float* __restrict__ part, int64_t n,
               int64_t rows, int w, int chunk, float lr, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = min(w, kTile);
  float* g_s = reinterpret_cast<float*>(smem);
  int32_t* sid_s = reinterpret_cast<int32_t*>(g_s + chunk * tile);
  int32_t* gidx_s = sid_s + chunk;
  int32_t* run_s = gidx_s + chunk;
  __shared__ int warp_heads[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk;
  const int len = n - begin < chunk ? static_cast<int>(n - begin) : chunk;
  for (int p = t; p < len; p += kBlock) {
    sid_s[p] = sid[begin + p];
    gidx_s[p] = gidx[begin + p];
  }
  __syncthreads();

  // run heads: run_s[r] is the first local position of run r
  int runs = 0;
  for (int p0 = 0; p0 < len; p0 += kBlock) {
    const int p = p0 + t;
    const bool head = p < len && (p == 0 || sid_s[p] != sid_s[p - 1]);
    const unsigned mask = __ballot_sync(0xffffffffu, head);
    if (lane == 0) warp_heads[warp] = __popc(mask);
    __syncthreads();
    int before = runs;
    int total = runs;
    for (int k = 0; k < kWarps; ++k) {
      const int c = warp_heads[k];
      if (k < warp) before += c;
      total += c;
    }
    if (head) run_s[before + __popc(mask & ((1u << lane) - 1u))] = p;
    runs = total;
    __syncthreads();
  }
  if (t == 0) run_s[runs] = len;
  __syncthreads();

  // does the first run continue a segment of the previous chunk, the
  // last one into the next chunk?
  const bool head_crosses = begin > 0 && sid[begin - 1] == sid_s[0];
  const bool tail_crosses =
      begin + len < n && sid[begin + len] == sid_s[len - 1];
  const int64_t sq_part = static_cast<int64_t>(gridDim.x) * 2 * w;

  for (int c0 = 0; c0 < w; c0 += kTile) {
    const int wt = min(kTile, w - c0);
    const int nv = wt / V;  // vectors of V columns per row in this tile
    const int items = len * nv;
    // stage the tile's columns of the chunk's gradient rows
    for (int i0 = t; i0 < items; i0 += kBlock * kUnroll) {
      Vec<float, V> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kBlock;
        if (i < items) {
          const int p = i / nv;
          const int j = i - p * nv;
          x[u] = load_f32<V>(grads + static_cast<int64_t>(gidx_s[p]) * w +
                             c0 + j * V);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kBlock;
        if (i < items) {
          const int p = i / nv;
          const int j = i - p * nv;
          *reinterpret_cast<Vec<float, V>*>(g_s + p * wt + j * V) = x[u];
        }
      }
    }
    __syncthreads();
    // fold each valid run: one thread per (run, vector of columns)
    for (int i = t; i < runs * nv; i += kBlock) {
      const int r = i / nv;
      const int j = i - r * nv;
      const int s = run_s[r];
      const int e = run_s[r + 1];
      const int32_t id = sid_s[s];
      if (id < 0 || id >= rows) continue;
      float sum[V];
      float sq[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sum[k] = 0.0f;
        sq[k] = 0.0f;
      }
      for (int p = s; p < e; ++p) {
        fold<V, OP>(sum, sq, load_f32<V>(g_s + p * wt + j * V));
      }
      const int c = c0 + j * V;
      const bool crosses_left = r == 0 && head_crosses;
      const bool crosses_right = r == runs - 1 && tail_crosses;
      if (crosses_left || crosses_right) {
        const int64_t off =
            (static_cast<int64_t>(blockIdx.x) * 2 + (crosses_left ? 0 : 1)) *
                w + c;
        store_f32<V>(part + off, sum);
        if (OP == kAdagradSq) store_f32<V>(part + sq_part + off, sq);
      } else {
        apply_row<T, V, OP>(table, acc, static_cast<int64_t>(id) * w + c, sum,
                            sq, lr, eps);
      }
    }
    __syncthreads();
  }
}

// Pass 2: warp k merges and applies the segment that begins in chunk k
// and crosses its last boundary, if there is one.
template <typename T, int V, int OP>
__global__ void __launch_bounds__(kBlock)
    merge_pass(const int32_t* __restrict__ sid,
               const float* __restrict__ part, T* __restrict__ table,
               float* __restrict__ acc, int64_t n, int64_t rows, int w,
               int chunk, int64_t chunks, float lr, float eps) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= chunks) return;
  const int64_t next = (k + 1) * chunk;  // first position of chunk k + 1
  if (next >= n) return;
  const int32_t id = sid[next - 1];
  if (id < 0 || id >= rows || sid[next] != id) return;  // no crossing
  const int64_t begin = k * chunk;
  if (begin > 0 && sid[begin - 1] == id) return;  // begun in an earlier chunk
  // the segment's last position: sid[lo] == id, sid[hi] != id (or hi == n)
  int64_t lo = next;
  int64_t hi = n;
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (sid[mid] == id) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int64_t last = lo / chunk;
  const int64_t sq_part = chunks * 2 * w;
  for (int c = lane * V; c < w; c += 32 * V) {
    float sum[V];
    float sq[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      sum[q] = 0.0f;
      sq[q] = 0.0f;
    }
    const int64_t tail = (k * 2 + 1) * w + c;
    merge<V, OP>(sum, sq, part + tail, part + sq_part + tail);
#pragma unroll 8
    for (int64_t j = k + 1; j <= last; ++j) {
      const int64_t head = j * 2 * w + c;
      merge<V, OP>(sum, sq, part + head, part + sq_part + head);
    }
    apply_row<T, V, OP>(table, acc, static_cast<int64_t>(id) * w + c, sum, sq,
                        lr, eps);
  }
}

template <typename T, int V, int OP>
cudaError_t launch_op(const int32_t* sid, const int32_t* gidx,
                      const float* grads, T* table, float* acc, float* part,
                      int64_t n, int64_t rows, int w, int chunk, float lr,
                      float eps, cudaStream_t stream) {
  const int64_t chunks = (n + chunk - 1) / chunk;
  const size_t smem =
      static_cast<size_t>(chunk) * (w < kTile ? w : kTile) * sizeof(float) +
      (3 * static_cast<size_t>(chunk) + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_pass<T, V, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chunk_pass<T, V, OP><<<static_cast<unsigned>(chunks), kBlock, smem,
                         stream>>>(sid, gidx, grads, table, acc, part, n,
                                   rows, w, chunk, lr, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks < 2) return err;
  merge_pass<T, V, OP>
      <<<static_cast<unsigned>((chunks + kWarps - 1) / kWarps), kBlock, 0,
         stream>>>(sid, part, table, acc, n, rows, w, chunk, chunks, lr,
                   eps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch(const int32_t* sid, const int32_t* gidx,
                   const float* grads, T* table, float* acc, float* part,
                   int64_t n, int64_t rows, int w, int chunk, int op,
                   float lr, float eps, cudaStream_t stream) {
  switch (op) {
    case kSgd:
      return launch_op<T, V, kSgd>(sid, gidx, grads, table, acc, part, n,
                                   rows, w, chunk, lr, eps, stream);
    case kAdagradDedup:
      return launch_op<T, V, kAdagradDedup>(sid, gidx, grads, table, acc,
                                            part, n, rows, w, chunk, lr, eps,
                                            stream);
    case kAdagradSq:
      return launch_op<T, V, kAdagradSq>(sid, gidx, grads, table, acc, part,
                                         n, rows, w, chunk, lr, eps, stream);
    case kAdd:
      return launch_op<T, V, kAdd>(sid, gidx, grads, table, acc, part, n,
                                   rows, w, chunk, lr, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Widest vector (4 elements at most: 16 B of f32) that divides the width
// and matches the alignment of the table, accumulator, gradient rows and
// partials.
template <typename T>
int vector_width(const void* table, const void* acc, const void* grads,
                 const void* part, int w) {
  int v = 4;
  while (v > 1 &&
         (w % v != 0 ||
          reinterpret_cast<uintptr_t>(table) % (v * sizeof(T)) != 0 ||
          reinterpret_cast<uintptr_t>(acc) % (v * sizeof(float)) != 0 ||
          reinterpret_cast<uintptr_t>(grads) % (v * sizeof(float)) != 0 ||
          reinterpret_cast<uintptr_t>(part) % (v * sizeof(float)) != 0)) {
    v /= 2;
  }
  return v;
}

template <typename T>
cudaError_t dispatch(const int32_t* sid, const int32_t* gidx,
                     const float* grads, T* table, float* acc, float* part,
                     int64_t n, int64_t rows, int w, int chunk, int op,
                     float lr, float eps, cudaStream_t stream) {
  switch (vector_width<T>(table, acc, grads, part, w)) {
    case 4:
      return launch<T, 4>(sid, gidx, grads, table, acc, part, n, rows, w,
                          chunk, op, lr, eps, stream);
    case 2:
      return launch<T, 2>(sid, gidx, grads, table, acc, part, n, rows, w,
                          chunk, op, lr, eps, stream);
    default:
      return launch<T, 1>(sid, gidx, grads, table, acc, part, n, rows, w,
                          chunk, op, lr, eps, stream);
  }
}

}  // namespace

// sid: [n] int32 sorted row ids; gidx: [n] int32 gradient row of each
// sorted position; grads: [m, w] f32; table: [rows, w] f32 (table_bf16 ==
// 0) or bf16, updated in place; acc: [rows, w] f32, updated in place
// (null for sgd and add); part: [ceil(n / chunk), 2, w] f32 scratch,
// twice that for adagrad_sq.  op: 0 sgd, 1 adagrad_dedup, 2 adagrad_sq,
// 3 add (lr unused).  All
// contiguous, on the current device.  Launches pass 1, then (more than
// one chunk) pass 2.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int segwalk_apply(const void* sid, const void* gidx,
                             const void* grads, void* table, void* acc,
                             void* part, long long n, long long rows, int w,
                             int chunk, int table_bf16, int op, float lr,
                             float eps, void* stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* i = static_cast<const int32_t*>(sid);
  const auto* x = static_cast<const int32_t*>(gidx);
  const auto* g = static_cast<const float*>(grads);
  auto* a = static_cast<float*>(acc);
  auto* p = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      table_bf16
          ? dispatch(i, x, g, static_cast<__nv_bfloat16*>(table), a, p, n,
                     rows, w, chunk, op, lr, eps, s)
          : dispatch(i, x, g, static_cast<float*>(table), a, p, n, rows, w,
                     chunk, op, lr, eps, s);
  return static_cast<int>(err);
}
