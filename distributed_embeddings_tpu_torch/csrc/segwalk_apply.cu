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
//   adam:           k += 1;  m = b1 * m + (1 - b1) * S;
//                   v = b2 * v + (1 - b2) * S * S;
//                   t += -lr * (m / (1 - b1^k)) / (sqrt(v / (1 - b2^k)) + eps)
//
// `adam` is lazy Adam (the JAX package's SparseAdam, parallel/sparse.py
// `row_updates`, an XLA apply there): only the rows the stream names
// advance their moments m, v (f32, [rows, w]) and their step count k
// (int32, [rows]).  Its update is rounded to the table's dtype BEFORE the
// add, as `table.at[ids].add(delta.astype(table.dtype))` does there, so a
// bf16 table rounds twice (the other ops round once).  The count of a row
// is read by every thread that updates a column of it and written once,
// after all of them have read it (pass 1: after the block's last column
// tile; pass 2: after a __syncwarp).
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
// once, to nearest even, at the store.  Adam's bias corrections take
// powf(b, k) of the f32 count and its scalars come in as the JAX package
// forms them (1 - b1 in double, then f32).
//
// Two arms of the TPU kernel, template parameters here (the TPU kernel's
// pallas_segwalk.py:232-236 and :321-330):
// - the gradient stream G may be bf16 (stream_dtype='bfloat16': the
//   wrapper rounds each compact gradient row to bf16 once).  Its rows are
//   read as bf16 and up-cast to f32 once per element when they are staged;
//   sums and sums of squares stay f32 in the same chunk order, so they
//   equal the f32 stream's on the rounded rows, bit for bit.
// - the Adagrad accumulator A may be bf16 (accum_dtype='bfloat16'): read
//   up to f32, S*S (or the summed squares) added in f32, the scale taken
//   from that UNROUNDED f32 value, and the value rounded once, to nearest
//   even, at the store (sparse.py `row_updates` of the JAX package: "the
//   update this step uses the EXACT f32 running value").  This kernel
//   serves it on an f32 table too (the JAX Pallas kernel serves it only on
//   a bf16 table and its XLA apply the rest, with this arithmetic).
// Only the combinations that exist are compiled: a bf16 A with the Adagrad
// ops, a bf16 G with sgd and the Adagrad ops.
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
// (w8, w16 f32; half as many bytes for a bf16 stream); each distinct row
// of the table (and accumulator, or Adam's two moments and count) is read
// and written once, at random (64 B rows of the 4.5 GB w16 table); a
// handful of flops per element.  The TPU kernel's lane packing, pair
// fetch, SMEM sideband and DMA parity protocol fed the TPU's 512 B bursts
// and (8, 128) tiles; on Hopper a 32 B sector is the unit of a random
// read, so rows stay in natural [rows, w] layout.
//
// Plain C interface, loaded with ctypes, one entry point; the dtypes come
// as flags.  Both launches go on the stream the caller passes (PyTorch's
// current stream); the function does not synchronise, allocates nothing
// (the wrapper allocates the partials), and returns the cudaError_t of
// the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kTile = 32;   // columns of a chunk's rows staged at once
constexpr int kUnroll = 4;  // gradient-row loads in flight per thread
constexpr int kSgd = 0;
constexpr int kAdagradDedup = 1;
constexpr int kAdagradSq = 2;
constexpr int kAdd = 3;
constexpr int kAdam = 4;

template <typename X>
constexpr bool is_bf16() {
  return sizeof(X) == 2;
}

// The (stream, accumulator, op) combinations that exist.
template <typename G, typename A, int OP>
constexpr bool supported() {
  const bool adagrad = OP == kAdagradDedup || OP == kAdagradSq;
  return (!is_bf16<A>() || adagrad) && (!is_bf16<G>() || adagrad ||
                                         OP == kSgd);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename X>
__device__ __forceinline__ X from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename X, int V>
struct alignas(sizeof(X) * V) Vec {
  X v[V];
};

// V elements of type X at p, up-cast to f32.
template <int V, typename X>
__device__ __forceinline__ Vec<float, V> load_f32(const X* p) {
  const Vec<X, V> x = *reinterpret_cast<const Vec<X, V>*>(p);
  Vec<float, V> y;
#pragma unroll
  for (int k = 0; k < V; ++k) y.v[k] = to_f32(x.v[k]);
  return y;
}

// V f32 values stored at p as type X, each rounded once to nearest even.
template <int V, typename X>
__device__ __forceinline__ void store_as(X* p, const float (&x)[V]) {
  Vec<X, V> v;
#pragma unroll
  for (int k = 0; k < V; ++k) v.v[k] = from_f32<X>(x[k]);
  *reinterpret_cast<Vec<X, V>*>(p) = v;
}

// The rows an apply updates in place: the table, the Adagrad accumulator
// (or Adam's first moment m), Adam's second moment v and its per-row step
// count (null where the op has none).
template <typename T, typename A>
struct Rows {
  T* table;
  A* acc;
  float* acc2;
  int32_t* count;
};

struct Hyper {
  float lr;
  float eps;
  float b1;
  float b2;
  float omb1;  // 1 - b1, formed in double
  float omb2;  // 1 - b2, formed in double
};

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

// The update of V columns of one row at element offset `off`; `step` is
// the row's Adam step count after this step (adam only).
template <typename T, typename A, int V, int OP>
__device__ __forceinline__ void apply_row(const Rows<T, A>& r, int64_t off,
                                          const float (&sum)[V],
                                          const float (&sq)[V],
                                          const Hyper& h, float step) {
  const Vec<float, V> t = load_f32<V>(r.table + off);
  float out[V];
  if constexpr (OP == kSgd) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[k] = __fsub_rn(t.v[k], __fmul_rn(h.lr, sum[k]));
    }
  } else if constexpr (OP == kAdd) {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = __fadd_rn(t.v[k], sum[k]);
  } else if constexpr (OP == kAdam) {
    float m[V];
    float v[V];
    const Vec<float, V> m0 = load_f32<V>(r.acc + off);
    const Vec<float, V> v0 = load_f32<V>(r.acc2 + off);
    const float bc1 = __fsub_rn(1.0f, powf(h.b1, step));
    const float bc2 = __fsub_rn(1.0f, powf(h.b2, step));
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = __fadd_rn(__fmul_rn(h.b1, m0.v[k]), __fmul_rn(h.omb1, sum[k]));
      v[k] = __fadd_rn(__fmul_rn(h.b2, v0.v[k]),
                       __fmul_rn(__fmul_rn(h.omb2, sum[k]), sum[k]));
      const float mhat = __fdiv_rn(m[k], bc1);
      const float vhat = __fdiv_rn(v[k], bc2);
      const float delta = __fdiv_rn(__fmul_rn(-h.lr, mhat),
                                    __fadd_rn(__fsqrt_rn(vhat), h.eps));
      // the update at the table's dtype, then the add
      out[k] = __fadd_rn(t.v[k], to_f32(from_f32<T>(delta)));
    }
    store_as<V>(r.acc + off, m);
    store_as<V>(r.acc2 + off, v);
  } else {
    const Vec<float, V> a0 = load_f32<V>(r.acc + off);
    float a[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float add =
          OP == kAdagradDedup ? __fmul_rn(sum[k], sum[k]) : sq[k];
      // the scale from the unrounded f32 value; a bf16 A rounds at the store
      a[k] = __fadd_rn(a0.v[k], add);
      const float scale = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a[k], h.eps)));
      out[k] = __fsub_rn(t.v[k], __fmul_rn(__fmul_rn(h.lr, sum[k]), scale));
    }
    store_as<V>(r.acc + off, a);
  }
  store_as<V>(r.table + off, out);
}

// Pass 1: block b folds the runs of chunk b.  Dynamic shared memory:
// the staged gradient rows [chunk, min(w, kTile)] f32, then the chunk's
// ids, gradient-row indices and run heads (chunk + 1), int32.
// part: [chunks, 2, w] partial sums, then (adagrad_sq) as many squares.
template <typename T, typename G, typename A, int V, int OP>
__global__ void __launch_bounds__(kBlock)
    chunk_pass(const int32_t* __restrict__ sid,
               const int32_t* __restrict__ gidx,
               const G* __restrict__ grads, Rows<T, A> rows_out,
               float* __restrict__ part, int64_t n, int64_t rows, int w,
               int chunk, Hyper h) {
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
    // stage the tile's columns of the chunk's gradient rows, up-cast to f32
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
        store_as<V>(part + off, sum);
        if (OP == kAdagradSq) store_as<V>(part + sq_part + off, sq);
      } else {
        const float step =
            OP == kAdam ? static_cast<float>(rows_out.count[id] + 1) : 0.0f;
        apply_row<T, A, V, OP>(rows_out, static_cast<int64_t>(id) * w + c,
                               sum, sq, h, step);
      }
    }
    __syncthreads();
  }
  if constexpr (OP == kAdam) {
    // every column of the rows applied here has read its count
    for (int r = t; r < runs; r += kBlock) {
      const int32_t id = sid_s[run_s[r]];
      const bool crosses =
          (r == 0 && head_crosses) || (r == runs - 1 && tail_crosses);
      if (id >= 0 && id < rows && !crosses) rows_out.count[id] += 1;
    }
  }
}

// Pass 2: warp k merges and applies the segment that begins in chunk k
// and crosses its last boundary, if there is one.
template <typename T, typename A, int V, int OP>
__global__ void __launch_bounds__(kBlock)
    merge_pass(const int32_t* __restrict__ sid,
               const float* __restrict__ part, Rows<T, A> rows_out,
               int64_t n, int64_t rows, int w, int chunk, int64_t chunks,
               Hyper h) {
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
  const int32_t count = OP == kAdam ? rows_out.count[id] : 0;
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
    apply_row<T, A, V, OP>(rows_out, static_cast<int64_t>(id) * w + c, sum,
                           sq, h, static_cast<float>(count + 1));
  }
  if constexpr (OP == kAdam) {
    __syncwarp();  // every lane has read the count
    if (lane == 0) rows_out.count[id] = count + 1;
  }
}

template <typename T, typename G, typename A, int V, int OP>
cudaError_t launch_op(const int32_t* sid, const int32_t* gidx, const G* grads,
                      const Rows<T, A>& r, float* part, int64_t n,
                      int64_t rows, int w, int chunk, const Hyper& h,
                      cudaStream_t stream) {
  const int64_t chunks = (n + chunk - 1) / chunk;
  const size_t smem =
      static_cast<size_t>(chunk) * (w < kTile ? w : kTile) * sizeof(float) +
      (3 * static_cast<size_t>(chunk) + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_pass<T, G, A, V, OP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chunk_pass<T, G, A, V, OP><<<static_cast<unsigned>(chunks), kBlock, smem,
                               stream>>>(sid, gidx, grads, r, part, n, rows,
                                         w, chunk, h);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks < 2) return err;
  merge_pass<T, A, V, OP>
      <<<static_cast<unsigned>((chunks + kWarps - 1) / kWarps), kBlock, 0,
         stream>>>(sid, part, r, n, rows, w, chunk, chunks, h);
  return cudaGetLastError();
}

template <typename T, typename G, typename A, int V, int OP>
cudaError_t launch_if(const int32_t* sid, const int32_t* gidx, const G* grads,
                      const Rows<T, A>& r, float* part, int64_t n,
                      int64_t rows, int w, int chunk, const Hyper& h,
                      cudaStream_t stream) {
  if constexpr (supported<G, A, OP>()) {
    return launch_op<T, G, A, V, OP>(sid, gidx, grads, r, part, n, rows, w,
                                     chunk, h, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, typename G, typename A, int V>
cudaError_t launch(const int32_t* sid, const int32_t* gidx, const G* grads,
                   const Rows<T, A>& r, float* part, int64_t n, int64_t rows,
                   int w, int chunk, int op, const Hyper& h,
                   cudaStream_t stream) {
  switch (op) {
    case kSgd:
      return launch_if<T, G, A, V, kSgd>(sid, gidx, grads, r, part, n, rows,
                                         w, chunk, h, stream);
    case kAdagradDedup:
      return launch_if<T, G, A, V, kAdagradDedup>(sid, gidx, grads, r, part,
                                                  n, rows, w, chunk, h,
                                                  stream);
    case kAdagradSq:
      return launch_if<T, G, A, V, kAdagradSq>(sid, gidx, grads, r, part, n,
                                               rows, w, chunk, h, stream);
    case kAdd:
      return launch_if<T, G, A, V, kAdd>(sid, gidx, grads, r, part, n, rows,
                                         w, chunk, h, stream);
    case kAdam:
      return launch_if<T, G, A, V, kAdam>(sid, gidx, grads, r, part, n, rows,
                                          w, chunk, h, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Widest vector (4 elements at most: 16 B of f32) that divides the width
// and matches the alignment of every row operand at its own element size.
template <typename T, typename G, typename A>
int vector_width(const Rows<T, A>& r, const G* grads, const float* part,
                 int w) {
  int v = 4;
  while (v > 1 &&
         (w % v != 0 || !aligned(r.table, v * sizeof(T)) ||
          !aligned(r.acc, v * sizeof(A)) ||
          !aligned(r.acc2, v * sizeof(float)) ||
          !aligned(grads, v * sizeof(G)) ||
          !aligned(part, v * sizeof(float)))) {
    v /= 2;
  }
  return v;
}

template <typename T, typename G, typename A>
cudaError_t dispatch(const void* sid, const void* gidx, const void* grads,
                     void* table, void* acc, void* acc2, void* count,
                     void* part, int64_t n, int64_t rows, int w, int chunk,
                     int op, const Hyper& h, cudaStream_t stream) {
  const auto* i = static_cast<const int32_t*>(sid);
  const auto* x = static_cast<const int32_t*>(gidx);
  const auto* g = static_cast<const G*>(grads);
  const Rows<T, A> r{static_cast<T*>(table), static_cast<A*>(acc),
                     static_cast<float*>(acc2), static_cast<int32_t*>(count)};
  auto* p = static_cast<float*>(part);
  switch (vector_width<T, G, A>(r, g, p, w)) {
    case 4:
      return launch<T, G, A, 4>(i, x, g, r, p, n, rows, w, chunk, op, h,
                                stream);
    case 2:
      return launch<T, G, A, 2>(i, x, g, r, p, n, rows, w, chunk, op, h,
                                stream);
    default:
      return launch<T, G, A, 1>(i, x, g, r, p, n, rows, w, chunk, op, h,
                                stream);
  }
}

template <typename T, typename G>
cudaError_t by_accumulator(int acc_bf16, const void* sid, const void* gidx,
                           const void* grads, void* table, void* acc,
                           void* acc2, void* count, void* part, int64_t n,
                           int64_t rows, int w, int chunk, int op,
                           const Hyper& h, cudaStream_t stream) {
  return acc_bf16 ? dispatch<T, G, bf16>(sid, gidx, grads, table, acc, acc2,
                                         count, part, n, rows, w, chunk, op,
                                         h, stream)
                  : dispatch<T, G, float>(sid, gidx, grads, table, acc, acc2,
                                          count, part, n, rows, w, chunk, op,
                                          h, stream);
}

template <typename T>
cudaError_t by_stream(int grads_bf16, int acc_bf16, const void* sid,
                      const void* gidx, const void* grads, void* table,
                      void* acc, void* acc2, void* count, void* part,
                      int64_t n, int64_t rows, int w, int chunk, int op,
                      const Hyper& h, cudaStream_t stream) {
  return grads_bf16
             ? by_accumulator<T, bf16>(acc_bf16, sid, gidx, grads, table,
                                       acc, acc2, count, part, n, rows, w,
                                       chunk, op, h, stream)
             : by_accumulator<T, float>(acc_bf16, sid, gidx, grads, table,
                                        acc, acc2, count, part, n, rows, w,
                                        chunk, op, h, stream);
}

}  // namespace

// sid: [n] int32 sorted row ids; gidx: [n] int32 gradient row of each
// sorted position; grads: [m, w] f32 (grads_bf16 == 0) or bf16; table:
// [rows, w] f32 (table_bf16 == 0) or bf16, updated in place; acc: [rows,
// w], updated in place: the Adagrad accumulator, f32 (acc_bf16 == 0) or
// bf16, or Adam's first moment (f32); acc2: Adam's second moment [rows, w]
// f32; count: Adam's step counts [rows] int32 (acc for the Adagrad ops
// and adam, acc2 and count for adam, null otherwise); part: [ceil(n /
// chunk), 2, w] f32 scratch, twice that for adagrad_sq.  op: 0 sgd, 1
// adagrad_dedup, 2 adagrad_sq, 3 add (lr unused), 4 adam (b1, b2 and 1 -
// b1, 1 - b2 used by it alone).  All contiguous, on the current device.
// Launches pass 1, then (more than one chunk) pass 2.  Returns the
// cudaError_t of the launches (0 on success; cudaErrorInvalidValue for a
// combination of dtypes and op that does not exist).
extern "C" int segwalk_apply(const void* sid, const void* gidx,
                             const void* grads, void* table, void* acc,
                             void* acc2, void* count, void* part,
                             long long n, long long rows, int w, int chunk,
                             int table_bf16, int grads_bf16, int acc_bf16,
                             int op, float lr, float eps, float b1, float b2,
                             float omb1, float omb2, void* stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{lr, eps, b1, b2, omb1, omb2};
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      table_bf16 ? by_stream<bf16>(grads_bf16, acc_bf16, sid, gidx, grads,
                                   table, acc, acc2, count, part, n, rows, w,
                                   chunk, op, h, s)
                 : by_stream<float>(grads_bf16, acc_bf16, sid, gidx, grads,
                                    table, acc, acc2, count, part, n, rows, w,
                                    chunk, op, h, s);
  return static_cast<int>(err);
}
