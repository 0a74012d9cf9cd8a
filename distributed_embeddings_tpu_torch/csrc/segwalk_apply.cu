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
// after all of them have read it (in a chunk: after the block's last
// column tile; in a merge: after a __syncwarp).
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
//   staged as bf16 and up-cast to f32 once per element where they are
//   folded; sums and sums of squares stay f32 in the same chunk order, so
//   they equal the f32 stream's on the rounded rows, bit for bit.
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
// A third arm is the port's own, for the host-DRAM cold tier
// (parallel/coldtier.py): two sources.  Rows [0, res) of the apply live in
// the table and accumulator, rows [res, rows) in the batch's fetch buffers
// (tail_table / tail_acc at row - res).  The wrapper remaps the stream's
// tail ids monotonically, so the sorted stream, its chunks and every sum
// are those of one [rows, w] table, and apply_row only picks the base
// pointer of the row it updates: head and tail come out bit for bit as
// the one table's rows would, and the resident head is never copied.
// sgd, add and the Adagrad ops take it (lazy Adam's count has no tail).
//
// Design: one launch, no atomic read-modify-writes, the same result on
// every run, a grid sized without reading the device, and work that
// follows the stream's VALID positions, not its length.
//
// Padding ids (outside [0, rows)) sort to the two ends of the stream, so
// the valid positions are one range [lo, hi).  On the padded streams of
// the hot cache, the cold tier and the hot dense trainer that range is a
// small share of the stream (1.7 % of 9m's w8 table gradient, 9 % of
// dlrm-tier's apply).  A grid of one block per chunk spent most of its
// time launching blocks that staged padding rows and then skipped them.
//
// - The grid is persistent: min(chunks, the blocks the card holds at
//   once at this kernel's occupancy), launched cooperatively so that all
//   of them are resident together.  Block b takes the chunks b, b + G,
//   b + 2G, ... (G the grid), so a contiguous range of chunks lands on
//   distinct blocks.
// - The valid range is found on the device, per chunk, with no search
//   and no host read.  A block loads its first chunk's ids and row
//   indices at once; for each of its other chunks it first reads the
//   chunk's first and last id (a chunk holds valid positions iff its
//   last id is >= 0 and its first < rows), all in the same round of
//   loads.  A block whose chunks are all padding exits after that round.
//   In the two chunks that hold lo and hi the valid positions are found
//   from the ids; the row indices of a loaded chunk's padding positions
//   may be read with the ids (one load), their gradient rows never.
// - Each chunk with valid positions keeps the TPU kernel's tiles.  The
//   block loads the chunk's ids and gradient-row indices (and those of
//   the kExt + 1 positions after it) coalesced into shared memory, finds
//   the run heads of [lo, hi) in it by comparing neighbouring ids (a
//   ballot and a prefix count), then copies the valid positions'
//   gradient rows into shared memory in column tiles of up to 32
//   columns, every copy of a tile in flight at once (cp.async: no
//   registers held; a bf16 stream stays bf16 there and is read up to f32
//   where it is folded).  One thread per (run, 4 columns) folds the run
//   from shared memory.  A run that starts and ends inside the chunk is
//   applied at once: one read and one write of its table row (and
//   accumulator row).  So is a segment begun in the chunk that ends at
//   most kExt positions into the next: its rows there are staged too,
//   folded as that chunk's partial, and the two partials added in chunk
//   order from +0, as a merge would; the next chunk's block sees from
//   the ids that its first run was taken.  A longer run that crosses the
//   chunk's first or last boundary leaves its partial (and squares) in a
//   [chunks, 2, w] f32 buffer: slot 0 for a run that continues a segment
//   begun in an earlier chunk (the chunk's flag is set, after a fence,
//   once the block's last chunk is done: one wait for the stores, not
//   one a chunk), slot 1 for the run that begins one.  A chunk inside one
//   run writes its whole partial once, into slot 0.
// - After its last chunk, a block merges each long segment that begins
//   in one of its chunks, one warp a segment: the warp finds the
//   segment's last chunk from the ids at the following chunks' starts
//   (kMergeUnroll * 32 at a time), waits for those chunks' flags
//   (relaxed loads, then a fence), folds the slot-1 partial and the
//   slot-0 partials in ascending chunk order (a row narrower than the
//   warp is loaded by groups of lanes, several chunks a load), applies
//   the segment once and clears the flags it read.  Every flag a launch
//   sets is read and cleared by exactly one merge, so the flags buffer
//   (int32, one a chunk, zeroed once by the wrapper and kept per device
//   and stream) is all zero between launches.  A block waits only after
//   its own flags are set, and the cooperative launch keeps every block
//   resident, so every flag it waits for is set; a flag still unset
//   after seconds faults the launch rather than hanging it.  Merging in
//   the same launch overlaps the merges with the other blocks' walks.
//
// The TPU kernel carries the run that crosses a tile boundary to the next
// grid step in scratch memory; Hopper's blocks run in no order, so the
// flagged partials take the carry's place.  A hot id of L positions costs
// about C shared-memory adds in each of its L / C chunks, in parallel,
// plus L / C partial loads in its merge: no thread walks all L positions.
//
// What bounds it: device-memory bytes of the valid positions.  Their
// sorted ids and indices are read coalesced (padding costs two id loads
// a chunk, and a block's first chunk's ids); the gradient rows they name
// are gathered in 32 B or 64 B sectors (w8, w16 f32; half as many bytes
// for a bf16 stream); each distinct row of the table (and accumulator,
// or Adam's two moments and count) is read and written once, at random
// (64 B rows of the 4.5 GB w16 table); a handful of flops per element.
// On a short valid range (a few hundred chunks) the chain of dependent
// loads sets the time: the probe, the ids, the gradient rows, the table
// rows; only a segment longer than kExt across a chunk's end adds its
// partials and a wait.  The TPU kernel's lane packing, pair fetch, SMEM
// sideband and DMA parity protocol fed the TPU's 512 B bursts and (8,
// 128) tiles; on Hopper a 32 B sector is the unit of a random read, so
// rows stay in natural [rows, w] layout.
//
// Plain C interface, loaded with ctypes, one entry point; the dtypes come
// as flags.  The launch goes on the stream the caller passes (PyTorch's
// current stream); the function does not synchronise, allocates nothing
// (the wrapper allocates the partials and the flags), and returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// blocks an SM holds at least: caps the kernel at 64 registers a thread,
// the chunk walk's own need (the merge code, inlined into the same
// kernel, would otherwise raise every instance's count and cut the
// blocks in flight a fifth or more on dense streams)
constexpr int kMinBlocks = 4;
constexpr int kTile = 32;   // columns of a chunk's rows staged at once
// chunks' ids, flags and partials a merging lane has in flight
constexpr int kMergeUnroll = 4;
// polls of a chunk's flag before a merge gives up (over a second of
// __nanosleep(64))
constexpr int64_t kMaxSpins = int64_t{1} << 25;
// a segment begun in a chunk that runs at most kExt positions into the
// next is folded and applied whole by the chunk's block (kExt + 1 ids
// past the chunk fit one warp's ballot)
constexpr int kExt = 31;
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
// count (null where the op has none).  Two sources (the cold tier's arm):
// rows [0, res) live in `table` / `acc`, rows [res, rows) in `tail_table`
// / `tail_acc` at row - res; res == rows (no tail) otherwise.
template <typename T, typename A>
struct Rows {
  T* table;
  A* acc;
  float* acc2;
  int32_t* count;
  T* tail_table;
  A* tail_acc;
  int64_t res;
};

// The tail of a two-source apply (the untyped pointers of Rows' tail).
struct Tail {
  void* table;
  void* acc;
  int64_t res;
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

// Copies V elements of type X from device memory at src into shared
// memory at dst without passing through registers (cp.async, 4, 8 or 16
// bytes), or through registers where the copy is 2 bytes.  The copies
// land at cp_async_wait().
template <int V, typename X>
__device__ __forceinline__ void stage_async(X* dst, const X* src) {
  constexpr int kBytes = V * sizeof(X);
  if constexpr (kBytes >= 4) {
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(to),
                 "l"(src), "n"(kBytes)
                 : "memory");
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// V f32 values at p, read from L2 (ld.global.cg): a partial another
// block wrote in this launch, never a stale line of this SM's L1.
template <int V>
__device__ __forceinline__ Vec<float, V> load_cg(const float* p) {
  Vec<float, V> y;
  if constexpr (V == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    y.v[0] = x.x;
    y.v[1] = x.y;
    y.v[2] = x.z;
    y.v[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = __ldcg(reinterpret_cast<const float2*>(p));
    y.v[0] = x.x;
    y.v[1] = x.y;
  } else {
    y.v[0] = __ldcg(p);
  }
  return y;
}

// A chunk's flag: set (a relaxed store after a device-scope fence) once
// its slot-0 partial is written; the merge that folds it reads it
// relaxed and fences before it reads the partial.
__device__ __forceinline__ void store_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Adds partial `x` (and squares `xq`) into sum (and sq).
template <int V, int OP>
__device__ __forceinline__ void merge(float (&sum)[V], float (&sq)[V],
                                      const float* x, const float* xq) {
  const Vec<float, V> s = load_cg<V>(x);
#pragma unroll
  for (int k = 0; k < V; ++k) sum[k] = __fadd_rn(sum[k], s.v[k]);
  if (OP == kAdagradSq) {
    const Vec<float, V> q = load_cg<V>(xq);
#pragma unroll
    for (int k = 0; k < V; ++k) sq[k] = __fadd_rn(sq[k], q.v[k]);
  }
}

// The update of V columns [c, c + V) of row `id` of a [rows, w] apply;
// `step` is the row's Adam step count after this step (adam only).  A row
// at or past `res` is addressed in the tail (table and accumulator), at
// row id - res: the arithmetic is the same either way.
template <typename T, typename A, int V, int OP>
__device__ __forceinline__ void apply_row(const Rows<T, A>& r, int64_t id,
                                          int w, int c,
                                          const float (&sum)[V],
                                          const float (&sq)[V],
                                          const Hyper& h, float step) {
  const bool in_tail = id >= r.res;
  const int64_t off = (in_tail ? id - r.res : id) * w + c;
  T* const table = in_tail ? r.tail_table : r.table;
  A* const acc = in_tail ? r.tail_acc : r.acc;
  const Vec<float, V> t = load_f32<V>(table + off);
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
    const Vec<float, V> m0 = load_f32<V>(acc + off);
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
    store_as<V>(acc + off, m);
    store_as<V>(r.acc2 + off, v);
  } else {
    const Vec<float, V> a0 = load_f32<V>(acc + off);
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
    store_as<V>(acc + off, a);
  }
  store_as<V>(table + off, out);
}

template <typename T, typename G, typename A, int V, int OP>
struct Walk {
  const int32_t* __restrict__ sid;
  const int32_t* __restrict__ gidx;
  const G* __restrict__ grads;
  Rows<T, A> rows_out;
  float* part;  // written and read in this launch: no __restrict__
  int* flags;
  int n;  // positions: the wrapper refuses 2^31 or more
  int chunks;
  int64_t rows;
  int w;
  int chunk;
  Hyper h;

  // Loads chunk c's ids and row indices, and those of the kExt + 1
  // positions after it, into sid_s ([chunk + kExt + 1]) and gidx_s
  // ([chunk + kExt]); ctx[0..2] get the ids at the chunk's first position
  // - 1, the previous chunk's first position and that position - 1 (-1
  // where there is none).  No barrier.
  __device__ __forceinline__ void load_chunk(int c, int32_t* sid_s,
                                             int32_t* gidx_s,
                                             int32_t* ctx) const {
    const int t = threadIdx.x;
    const int begin = c * chunk;
    const int len = min(chunk, n - begin);
    const int ext = min(kExt + 1, n - begin - len);
    const int idx_end = len + min(ext, kExt);
    for (int p = t; p < len + ext; p += kBlock) {
      sid_s[p] = sid[begin + p];
      if (p < idx_end) gidx_s[p] = gidx[begin + p];
    }
    if (t == 0) {
      ctx[0] = begin > 0 ? sid[begin - 1] : -1;
      ctx[1] = begin >= chunk ? sid[begin - chunk] : -1;
      ctx[2] = begin > chunk ? sid[begin - chunk - 1] : -1;
    }
  }

  // The runs of chunk c's valid positions, after load_chunk and a
  // barrier.  A run that starts and ends in the chunk is applied here;
  // so is a segment begun here that ends at most kExt positions into the
  // next chunk (its rows there are staged too, and that chunk's block
  // skips its first run); a longer crossing run leaves a partial (slot 0
  // and bit `mbit` of `publish`, slot 1 and bit `mbit` of `merges`).  Shared
  // memory: the staged gradient rows g_s [chunk + kExt, min(w, kTile)]
  // (of the stream's type), the short tail's partial ext_s [2, kTile]
  // f32 and the run heads run_s [chunk + 1].
  __device__ __forceinline__ void chunk_runs(int c, const int32_t* sid_s,
                                             const int32_t* gidx_s,
                                             const int32_t* ctx, G* g_s,
                                             float* ext_s, int32_t* run_s,
                                             int* warp_heads,
                                             unsigned* merges,
                                             unsigned* publish,
                                             int mbit) const {
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int begin = c * chunk;
    const int len = min(chunk, n - begin);
    const int ext = min(kExt + 1, n - begin - len);
    // [va, vb): the chunk's valid positions (counted only in a chunk
    // that holds padding)
    int va = 0;
    int vb = len;
    if (!(sid_s[0] >= 0 && sid_s[len - 1] < rows)) {
      int below = 0;
      int above = 0;
      for (int p0 = 0; p0 < len; p0 += kBlock) {
        const int p = p0 + t;
        const int32_t s = p < len ? sid_s[p] : 0;
        below += __syncthreads_count(p < len && s < 0);
        above += __syncthreads_count(p < len && s >= rows);
      }
      va = below;
      vb = len - above;
      if (va >= vb) return;  // all padding (uniform: no barrier skipped)
    }

    // run heads: run_s[r] is the first local position of run r
    int runs = 0;
    for (int p0 = va; p0 < vb; p0 += kBlock) {
      const int p = p0 + t;
      const bool head = p < vb && (p == va || sid_s[p] != sid_s[p - 1]);
      const unsigned mask = __ballot_sync(0xffffffffu, head);
      if (lane == 0) warp_heads[warp] = __popc(mask);
      __syncthreads();
      int before = runs;
      int total = runs;
      for (int k = 0; k < kWarps; ++k) {
        const int cnt = warp_heads[k];
        if (k < warp) before += cnt;
        total += cnt;
      }
      if (head) run_s[before + __popc(mask & ((1u << lane) - 1u))] = p;
      runs = total;
      __syncthreads();
    }
    if (t == 0) run_s[runs] = vb;
    __syncthreads();

    const int32_t first = sid_s[va];
    const int32_t last = sid_s[vb - 1];
    const bool head_crosses = va == 0 && ctx[0] == first;
    const bool tail_crosses = vb == len && ext > 0 && sid_s[len] == last;
    // the first run, begun in the previous chunk and ending at most kExt
    // positions into this one, is that chunk's block's
    const bool head_taken =
        head_crosses && run_s[1] - run_s[0] <= kExt &&
        !(runs == 1 && tail_crosses) &&
        !(ctx[1] == first && ctx[2] == first);
    // the last run, begun here: the positions of its segment past the
    // chunk's end (kExt + 1 stands for more)
    const bool began_here = !(runs == 1 && head_crosses);
    int tail_ext = 0;
    if (tail_crosses && began_here) {
      const unsigned other = __ballot_sync(
          0xffffffffu, lane >= ext || sid_s[len + lane] != last);
      tail_ext = other ? __ffs(other) - 1 : kExt + 1;
    }
    const bool tail_short = tail_crosses && began_here && tail_ext <= kExt;
    const bool tail_partial = tail_crosses && !tail_short;
    if (tail_partial && began_here && t == 0) {
      merges[mbit >> 5] |= 1u << (mbit & 31);  // merged after the walk
    }

    const int r0 = head_taken ? 1 : 0;
    const int sa = run_s[r0];
    const int in_chunk = vb - sa;  // staged rows of the chunk itself
    const int stage_rows = in_chunk + (tail_short ? tail_ext : 0);
    const int64_t sq_part = static_cast<int64_t>(chunks) * 2 * w;
    for (int c0 = 0; c0 < w; c0 += kTile) {
      const int wt = min(kTile, w - c0);
      const int nv = wt / V;  // vectors of V columns per row in this tile
      // stage the tile's columns of the gradient rows of positions
      // [sa, vb) and of the short tail's positions past the chunk (local
      // position p at g_s row p), all copies in flight at once
      const int staged = stage_rows * nv;
      for (int i = t; i < staged; i += kBlock) {
        const int q = i / nv;
        const int p = q < in_chunk ? sa + q : len + q - in_chunk;
        const int j = i - q * nv;
        stage_async<V>(g_s + p * wt + j * V,
                       grads + static_cast<int64_t>(gidx_s[p]) * w + c0 +
                           j * V);
      }
      cp_async_wait();
      __syncthreads();
      if (tail_short) {
        // the short tail's partial past the chunk, from +0
        if (t < nv) {
          float sum[V];
          float sq[V];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            sum[k] = 0.0f;
            sq[k] = 0.0f;
          }
          for (int p = len; p < len + tail_ext; ++p) {
            fold<V, OP>(sum, sq, load_f32<V>(g_s + p * wt + t * V));
          }
          store_as<V>(ext_s + t * V, sum);
          if (OP == kAdagradSq) store_as<V>(ext_s + kTile + t * V, sq);
        }
        __syncthreads();
      }
      // fold each run: one thread per (run, vector of columns)
      const int items = (runs - r0) * nv;
      for (int i = t; i < items; i += kBlock) {
        const int r = r0 + i / nv;
        const int j = i - (r - r0) * nv;
        const int s = run_s[r];
        const int e = run_s[r + 1];
        const int32_t id = sid_s[s];
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
        const int col = c0 + j * V;
        const bool last_run = r == runs - 1;
        if (last_run && tail_short) {
          // the two partials in chunk order from +0, a merge's arithmetic
          const Vec<float, V> x = load_f32<V>(ext_s + j * V);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            sum[k] = __fadd_rn(__fadd_rn(0.0f, sum[k]), x.v[k]);
          }
          if (OP == kAdagradSq) {
            const Vec<float, V> y = load_f32<V>(ext_s + kTile + j * V);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              sq[k] = __fadd_rn(__fadd_rn(0.0f, sq[k]), y.v[k]);
            }
          }
        }
        const bool crosses_left = r == 0 && head_crosses;
        if (crosses_left || (last_run && tail_partial)) {
          const int64_t off =
              (static_cast<int64_t>(c) * 2 + (crosses_left ? 0 : 1)) * w +
              col;
          store_as<V>(part + off, sum);
          if (OP == kAdagradSq) store_as<V>(part + sq_part + off, sq);
        } else {
          const float step =
              OP == kAdam ? static_cast<float>(rows_out.count[id] + 1) : 0.0f;
          apply_row<T, A, V, OP>(rows_out, id, w, col, sum, sq, h, step);
        }
      }
      __syncthreads();
    }
    if (head_crosses && !head_taken && t == 0) {
      publish[mbit >> 5] |= 1u << (mbit & 31);  // flagged after the walk
    }
    if constexpr (OP == kAdam) {
      // every column of the rows applied here has read its count
      for (int r = r0 + t; r < runs; r += kBlock) {
        const int32_t id = sid_s[run_s[r]];
        const bool partial = (r == 0 && head_crosses) ||
                             (r == runs - 1 && tail_partial);
        if (!partial) rows_out.count[id] += 1;
      }
    }
    __syncthreads();  // the shared buffers are the next chunk's
  }

  // One warp: the segment that begins in chunk k and runs more than kExt
  // positions into the next.  Its chunks' ids, flags and partials are
  // read kMergeUnroll a lane at a time, and a row of partials narrower
  // than the warp takes a group of lanes, so a segment over many chunks
  // costs a few round trips; the partials are folded in ascending chunk
  // order (shuffled to the first group's lanes).
  __device__ __forceinline__ void merge_segment(int k) const {
    const int lane = threadIdx.x & 31;
    const int32_t id = sid[k * chunk + chunk - 1];
    const int64_t sq_part = static_cast<int64_t>(chunks) * 2 * w;
    // its last chunk: the following chunks that start with id (a prefix
    // of them, in chunk order j = base + u * 32 + lane)
    int last = k;
    for (int base = k + 1;; base += 32 * kMergeUnroll) {
      unsigned starts = 0;
#pragma unroll
      for (int u = 0; u < kMergeUnroll; ++u) {
        const int j = base + u * 32 + lane;
        if (j < chunks && sid[j * chunk] == id) starts |= 1u << u;
      }
      bool more = true;
#pragma unroll
      for (int u = 0; u < kMergeUnroll; ++u) {
        if (more) {
          const unsigned m = __ballot_sync(0xffffffffu, (starts >> u) & 1u);
          last += __popc(m);
          more = m == 0xffffffffu;
        }
      }
      if (!more) break;
    }
    // each of them has set its flag (every block is resident and sets
    // its flags before it waits; a flag still unset after seconds is a
    // broken invariant, and the launch faults, not hangs); then a fence,
    // so that the partials are read after the flags
    for (int base = k + 1; base <= last; base += 32 * kMergeUnroll) {
      int seen[kMergeUnroll];
#pragma unroll
      for (int u = 0; u < kMergeUnroll; ++u) {
        const int j = base + u * 32 + lane;
        seen[u] = j <= last ? load_relaxed(flags + j) : 1;
      }
#pragma unroll
      for (int u = 0; u < kMergeUnroll; ++u) {
        const int j = base + u * 32 + lane;
        for (int64_t spins = 0; seen[u] == 0; ++spins) {
          if (spins > kMaxSpins) __trap();
          __nanosleep(64);
          seen[u] = load_relaxed(flags + j);
        }
      }
    }
    __threadfence();
    __syncwarp();
    const int32_t count = OP == kAdam ? rows_out.count[id] : 0;
    // column slabs of up to 32 vectors; a slab of `lanes` vectors gives
    // each of `groups` lane groups one chunk's partial row a load
    for (int c0 = 0; c0 < w; c0 += 32 * V) {
      const int lanes = min(32, (w - c0) / V);
      const int groups = 32 / lanes;
      const int g = lane / lanes;
      const int col = c0 + (lane - g * lanes) * V;
      float sum[V];
      float sq[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        sum[q] = 0.0f;
        sq[q] = 0.0f;
      }
      if (g == 0) {
        const int64_t tail = (static_cast<int64_t>(k) * 2 + 1) * w + col;
        merge<V, OP>(sum, sq, part + tail, part + sq_part + tail);
      }
      // (half as many in flight with the squares beside the sums)
      constexpr int kU = OP == kAdagradSq ? kMergeUnroll / 2 : kMergeUnroll;
      for (int base = k + 1; base <= last; base += kU * groups) {
        Vec<float, V> x[kU] = {};
        Vec<float, V> xq[kU] = {};
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = base + u * groups + g;
          if (g < groups && j <= last) {
            const int64_t head = static_cast<int64_t>(j) * 2 * w + col;
            x[u] = load_cg<V>(part + head);
            if (OP == kAdagradSq) xq[u] = load_cg<V>(part + sq_part + head);
          }
        }
        // in chunk order: j = base + u * groups + e
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          for (int e = 0; e < groups && base + u * groups + e <= last; ++e) {
            const int from = e * lanes + (lane % lanes);
#pragma unroll
            for (int q = 0; q < V; ++q) {
              sum[q] = __fadd_rn(sum[q], __shfl_sync(0xffffffffu, x[u].v[q],
                                                     from));
              if (OP == kAdagradSq) {
                sq[q] = __fadd_rn(sq[q], __shfl_sync(0xffffffffu,
                                                     xq[u].v[q], from));
              }
            }
          }
        }
      }
      if (g == 0) {
        apply_row<T, A, V, OP>(rows_out, id, w, col, sum, sq, h,
                               static_cast<float>(count + 1));
      }
    }
    // the flags read here are zero again for the next launch
    for (int j = k + 1 + lane; j <= last; j += 32) flags[j] = 0;
    if constexpr (OP == kAdam) {
      __syncwarp();  // every lane has read the count
      if (lane == 0) rows_out.count[id] = count + 1;
    }
  }
};

// Block b walks the chunks b, b + G, ... (G = gridDim.x) in rounds of
// kBlock: its first chunk loaded at once, the others after a probe of
// their end ids; then it sets its chunks' flags and merges the long
// crossing segments begun in its chunks.  Dynamic shared memory: the
// short tail's partial, the staged rows, the chunk's ids and row indices
// and the run heads (Walk::chunk_runs), then `rounds * kWarps` merge
// words and as many flag words.
template <typename T, typename G, typename A, int V, int OP>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    segwalk_kernel(Walk<T, G, A, V, OP> wk, int rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = wk.chunk;
  const int tile = min(wk.w, kTile);
  float* ext_s = reinterpret_cast<float*>(smem);
  G* g_s = reinterpret_cast<G*>(ext_s + 2 * kTile);
  int32_t* sid_s = reinterpret_cast<int32_t*>(
      smem + 2 * kTile * sizeof(float) +
      ((chunk + kExt) * tile * sizeof(G) + 3) / 4 * 4);
  int32_t* gidx_s = sid_s + chunk + kExt + 1;
  int32_t* run_s = gidx_s + chunk + kExt;
  unsigned* merges = reinterpret_cast<unsigned*>(run_s + chunk + 1);
  unsigned* publish = merges + rounds * kWarps;
  __shared__ int32_t ctx[3];
  __shared__ int warp_heads[kWarps];
  __shared__ unsigned active[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int grid = gridDim.x;
  const int b = blockIdx.x;
  // this block's chunks: b + i * grid for i < mine (mine >= 1)
  const int mine = (wk.chunks - b + grid - 1) / grid;
  for (int i = t; i < 2 * rounds * kWarps; i += kBlock) merges[i] = 0;
  for (int r = 0; r < rounds; ++r) {
    // probe: does the chunk hold a valid position (its last id >= 0 and
    // its first < rows)?
    const int i = r * kBlock + t;
    bool live = false;
    if (i > 0 && i < mine) {
      const int begin = (b + i * grid) * chunk;
      const int end = min(begin + chunk, wk.n);
      live = wk.sid[end - 1] >= 0 && wk.sid[begin] < wk.rows;
    }
    if (r == 0) wk.load_chunk(b, sid_s, gidx_s, ctx);
    const unsigned a = __ballot_sync(0xffffffffu, live);
    if (lane == 0) active[warp] = a;
    __syncthreads();
    if (r == 0) {
      wk.chunk_runs(b, sid_s, gidx_s, ctx, g_s, ext_s, run_s, warp_heads,
                    merges, publish, 0);
      __syncthreads();
    }
    for (int q = 0; q < kWarps; ++q) {
      unsigned m = active[q];
      while (m) {
        const int bit = __ffs(m) - 1;
        m &= m - 1;
        const int ci = r * kBlock + q * 32 + bit;
        wk.load_chunk(b + ci * grid, sid_s, gidx_s, ctx);
        __syncthreads();
        wk.chunk_runs(b + ci * grid, sid_s, gidx_s, ctx, g_s, ext_s, run_s,
                      warp_heads, merges, publish, ci);
        __syncthreads();
      }
    }
  }
  // every partial of this block's chunks is written (each chunk ended at
  // a barrier): set the slot-0 flags, one fence and then plain stores a
  // word of them, once for the whole walk; then merge, one warp a segment
  // (a block never waits before its own flags are out)
  for (int i = t; i < rounds * kWarps; i += kBlock) {
    unsigned m = publish[i];
    if (m) __threadfence();
    while (m) {
      const int bit = __ffs(m) - 1;
      m &= m - 1;
      store_relaxed(wk.flags + b + (i * 32 + bit) * grid, 1);
    }
  }
  int idx = 0;
  for (int r = 0; r < rounds; ++r) {
    for (int q = 0; q < kWarps; ++q) {
      unsigned m = merges[r * kWarps + q];
      while (m) {
        const int bit = __ffs(m) - 1;
        m &= m - 1;
        if (idx++ % kWarps == warp) {
          wk.merge_segment(b + (r * kBlock + q * 32 + bit) * grid);
        }
      }
    }
  }
}

// Blocks of `kernel` an SM holds at `smem` bytes of dynamic shared
// memory on the current device (the occupancy query, cached).
int blocks_per_sm(const void* kernel, size_t smem, int device,
                  cudaError_t* err) {
  struct Entry {
    const void* kernel;
    size_t smem;
    int device;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.kernel == kernel && e.smem == smem && e.device == device) {
      return e.blocks;
    }
  }
  int blocks = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                       kBlock, smem);
  if (*err != cudaSuccess) return 0;
  if (used < 64) cache[used++] = Entry{kernel, smem, device, blocks};
  return blocks;
}

template <typename T, typename G, typename A, int V, int OP>
cudaError_t launch_op(const int32_t* sid, const int32_t* gidx, const G* grads,
                      const Rows<T, A>& r, float* part, int* flags, int64_t n,
                      int64_t rows, int w, int chunk, const Hyper& h,
                      cudaStream_t stream) {
  const int chunks = static_cast<int>((n + chunk - 1) / chunk);
  const void* kernel =
      reinterpret_cast<const void*>(&segwalk_kernel<T, G, A, V, OP>);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return err;
  // the short tail's partial (f32), the staged rows (of the stream's
  // type; a multiple of 4 bytes), the chunk's ids and row indices and the
  // run heads (int32)
  const size_t base =
      2 * kTile * sizeof(float) +
      (static_cast<size_t>(chunk + kExt) * (w < kTile ? w : kTile) *
           sizeof(G) + 3) / 4 * 4 +
      (2 * static_cast<size_t>(chunk + kExt) + chunk + 2) * sizeof(int32_t);
  // the grid the card holds at once, and the rounds of kBlock chunks a
  // block walks (their merge and flag words are shared memory too)
  int rounds = 1;
  int grid = 1;
  size_t smem = 0;
  for (;;) {
    smem = base + 2 * static_cast<size_t>(rounds) * kWarps * sizeof(unsigned);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    const int per_sm = blocks_per_sm(kernel, smem, device, &err);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    grid = std::min(chunks, sms * per_sm);
    const int per_block = (chunks + grid - 1) / grid;
    const int need = (per_block + kBlock - 1) / kBlock;
    if (need <= rounds) break;
    rounds = need;
  }
  Walk<T, G, A, V, OP> wk{sid,   gidx,   grads, r, part, flags,
                          static_cast<int>(n), chunks, rows, w, chunk, h};
  void* args[] = {&wk, &rounds};
  // cooperative: every block resident at once, so a merge's wait for
  // another block's flags always ends
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)),
                                    dim3(kBlock), args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the launch never ran: clear it
    return err;
  }
  return cudaGetLastError();
}

template <typename T, typename G, typename A, int V, int OP>
cudaError_t launch_if(const int32_t* sid, const int32_t* gidx, const G* grads,
                      const Rows<T, A>& r, float* part, int* flags, int64_t n,
                      int64_t rows, int w, int chunk, const Hyper& h,
                      cudaStream_t stream) {
  if constexpr (supported<G, A, OP>()) {
    return launch_op<T, G, A, V, OP>(sid, gidx, grads, r, part, flags, n,
                                     rows, w, chunk, h, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, typename G, typename A, int V>
cudaError_t launch(const int32_t* sid, const int32_t* gidx, const G* grads,
                   const Rows<T, A>& r, float* part, int* flags, int64_t n,
                   int64_t rows, int w, int chunk, int op, const Hyper& h,
                   cudaStream_t stream) {
  switch (op) {
    case kSgd:
      return launch_if<T, G, A, V, kSgd>(sid, gidx, grads, r, part, flags, n,
                                         rows, w, chunk, h, stream);
    case kAdagradDedup:
      return launch_if<T, G, A, V, kAdagradDedup>(sid, gidx, grads, r, part,
                                                  flags, n, rows, w, chunk,
                                                  h, stream);
    case kAdagradSq:
      return launch_if<T, G, A, V, kAdagradSq>(sid, gidx, grads, r, part,
                                               flags, n, rows, w, chunk, h,
                                               stream);
    case kAdd:
      return launch_if<T, G, A, V, kAdd>(sid, gidx, grads, r, part, flags, n,
                                         rows, w, chunk, h, stream);
    case kAdam:
      return launch_if<T, G, A, V, kAdam>(sid, gidx, grads, r, part, flags, n,
                                          rows, w, chunk, h, stream);
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
          !aligned(r.tail_table, v * sizeof(T)) ||
          !aligned(r.tail_acc, v * sizeof(A)) ||
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
                     const Tail& tl, void* part, int* flags, int64_t n,
                     int64_t rows, int w, int chunk, int op, const Hyper& h,
                     cudaStream_t stream) {
  const auto* i = static_cast<const int32_t*>(sid);
  const auto* x = static_cast<const int32_t*>(gidx);
  const auto* g = static_cast<const G*>(grads);
  const Rows<T, A> r{static_cast<T*>(table),     static_cast<A*>(acc),
                     static_cast<float*>(acc2),    static_cast<int32_t*>(count),
                     static_cast<T*>(tl.table),    static_cast<A*>(tl.acc),
                     tl.res};
  auto* p = static_cast<float*>(part);
  switch (vector_width<T, G, A>(r, g, p, w)) {
    case 4:
      return launch<T, G, A, 4>(i, x, g, r, p, flags, n, rows, w, chunk, op,
                                h, stream);
    case 2:
      return launch<T, G, A, 2>(i, x, g, r, p, flags, n, rows, w, chunk, op,
                                h, stream);
    default:
      return launch<T, G, A, 1>(i, x, g, r, p, flags, n, rows, w, chunk, op,
                                h, stream);
  }
}

template <typename T, typename G>
cudaError_t by_accumulator(int acc_bf16, const void* sid, const void* gidx,
                           const void* grads, void* table, void* acc,
                           void* acc2, void* count, const Tail& tl,
                           void* part, int* flags, int64_t n, int64_t rows,
                           int w, int chunk, int op, const Hyper& h,
                           cudaStream_t stream) {
  return acc_bf16 ? dispatch<T, G, bf16>(sid, gidx, grads, table, acc, acc2,
                                         count, tl, part, flags, n, rows, w,
                                         chunk, op, h, stream)
                  : dispatch<T, G, float>(sid, gidx, grads, table, acc, acc2,
                                          count, tl, part, flags, n, rows, w,
                                          chunk, op, h, stream);
}

template <typename T>
cudaError_t by_stream(int grads_bf16, int acc_bf16, const void* sid,
                      const void* gidx, const void* grads, void* table,
                      void* acc, void* acc2, void* count, const Tail& tl,
                      void* part, int* flags, int64_t n, int64_t rows, int w,
                      int chunk, int op, const Hyper& h,
                      cudaStream_t stream) {
  return grads_bf16
             ? by_accumulator<T, bf16>(acc_bf16, sid, gidx, grads, table,
                                       acc, acc2, count, tl, part, flags, n,
                                       rows, w, chunk, op, h, stream)
             : by_accumulator<T, float>(acc_bf16, sid, gidx, grads, table,
                                        acc, acc2, count, tl, part, flags, n,
                                        rows, w, chunk, op, h, stream);
}

}  // namespace

// sid: [n] int32 sorted row ids; gidx: [n] int32 gradient row of each
// sorted position; grads: [m, w] f32 (grads_bf16 == 0) or bf16; table:
// [rows, w] f32 (table_bf16 == 0) or bf16, updated in place; acc: [rows,
// w], updated in place: the Adagrad accumulator, f32 (acc_bf16 == 0) or
// bf16, or Adam's first moment (f32); acc2: Adam's second moment [rows, w]
// f32; count: Adam's step counts [rows] int32 (acc for the Adagrad ops
// and adam, acc2 and count for adam, null otherwise); tail_table,
// tail_acc, res: the cold tier's two-source arm, rows [res, rows) of the
// table and accumulator at tail_table / tail_acc row - res (res == rows
// and null tails otherwise; sgd, add and the Adagrad ops); part: [ceil(n /
// chunk), 2, w] f32 scratch, twice that for adagrad_sq; flags: [>= ceil(n
// / chunk)] int32, all zero, and all zero again when the launch ends (one
// buffer a stream: two launches in flight at once must not share it).
// op: 0 sgd, 1 adagrad_dedup, 2 adagrad_sq, 3 add (lr unused), 4 adam
// (b1, b2 and 1 - b1, 1 - b2 used by it alone).  All contiguous, on the
// current device; n < 2^31.  One cooperative launch.  Returns its
// cudaError_t (0 on success; cudaErrorInvalidValue for a combination of
// dtypes and op that does not exist or a stream too long).
extern "C" int segwalk_apply(const void* sid, const void* gidx,
                             const void* grads, void* table, void* acc,
                             void* acc2, void* count, void* tail_table,
                             void* tail_acc, long long res, void* part,
                             void* flags, long long n, long long rows, int w,
                             int chunk, int table_bf16, int grads_bf16,
                             int acc_bf16, int op, float lr, float eps,
                             float b1, float b2, float omb1, float omb2,
                             void* stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || w <= 0 || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (res < 0 || res > rows || (res < rows && tail_table == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{lr, eps, b1, b2, omb1, omb2};
  const Tail tl{tail_table, tail_acc, res};
  auto s = static_cast<cudaStream_t>(stream);
  auto* f = static_cast<int*>(flags);
  const cudaError_t err =
      table_bf16 ? by_stream<bf16>(grads_bf16, acc_bf16, sid, gidx, grads,
                                   table, acc, acc2, count, tl, part, f, n,
                                   rows, w, chunk, op, h, s)
                 : by_stream<float>(grads_bf16, acc_bf16, sid, gidx, grads,
                                    table, acc, acc2, count, tl, part, f, n,
                                    rows, w, chunk, op, h, s);
  return static_cast<int>(err);
}
