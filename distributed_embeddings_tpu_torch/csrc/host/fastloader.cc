// Native raw-binary Criteo batch loader: the port's own copy of
// distributed_embeddings_tpu/cc/fastloader.cc (the same source, built by
// the port's utils/nativebuild.py with g++ into the git-ignored build/).
//
// The reference's split-binary file format (label.bin bool,
// numerical.bin fp16, cat_<i>.bin int8/16/32 by vocabulary size); batch
// assembly (pread, dtype widening bool->f32, f16->f32, intN->int32, and
// the data-parallel slice) happens in native code on a background
// prefetch thread, so the Python training loop only copies ready
// int32/f32 buffers to the device.  Exposed through a plain C ABI loaded
// with ctypes (utils/fastloader.py); no Python.h dependency.
//
// Threading model: one prefetch thread per loader filling a bounded ring
// of decoded batches ahead of the consumer; `det_loader_get` blocks until
// its batch is ready.  Random access outside the ring falls back to a
// synchronous read.

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// fp16 (IEEE binary16) -> fp32, bit manipulation (no F16C requirement).
inline float HalfToFloat(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {        // subnormal: normalise
      int shift = 0;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((127 - 15 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1F) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

struct DecodedBatch {
  int64_t idx = -1;
  bool error = false;  // decode failed; idx says which batch
  std::vector<float> labels;      // [rows]
  std::vector<float> numerical;   // [rows * num_numerical]
  std::vector<int32_t> cats;      // [n_cats * cat_rows]
};

struct Loader {
  int label_fd = -1;
  int numerical_fd = -1;
  std::vector<int> cat_fds;
  std::vector<int> cat_itemsize;  // bytes per element of each cat file

  int64_t batch_size = 0;
  int num_numerical = 0;
  int64_t num_batches = 0;
  int64_t last_batch_rows = 0;  // rows in the final (possibly short) batch

  // data-parallel slice [offset, offset+lbs) of each batch; -1 = whole
  int64_t offset = -1;
  int64_t lbs = -1;
  bool slice_labels = true;  // reference skips the label slice on valid
  bool slice_cats = false;   // dp_input

  // prefetch
  int prefetch_depth = 0;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::deque<DecodedBatch> ring;
  int64_t next_to_read = 0;   // next idx the worker will decode
  // Bumped on every ring.clear() (random seek); the worker drops results
  // claimed under an older generation so a stale in-flight batch can never
  // land after the clear and break the ring's monotonic order.
  int64_t generation = 0;
  std::atomic<bool> stop{false};

  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    if (worker.joinable()) worker.join();
    if (label_fd >= 0) close(label_fd);
    if (numerical_fd >= 0) close(numerical_fd);
    for (int fd : cat_fds) close(fd);
  }

  int64_t RowsOf(int64_t idx) const {
    return idx == num_batches - 1 ? last_batch_rows : batch_size;
  }

  // Strict: every request must be fully in-bounds (file sizes are
  // cross-validated at open, and the final batch's row count already
  // accounts for the short tail), so a short read means truncation or
  // mismatch and is an error rather than silent zero-fill.
  bool ReadRaw(int fd, void* dst, int64_t bytes, int64_t off) const {
    auto* p = static_cast<uint8_t*>(dst);
    int64_t got = 0;
    while (got < bytes) {
      ssize_t n = pread(fd, p + got, bytes - got, off + got);
      if (n < 0) return false;
      if (n == 0) break;
      got += n;
    }
    return got == bytes;
  }

  bool Decode(int64_t idx, DecodedBatch* out) {
    const int64_t rows = RowsOf(idx);
    out->idx = idx;
    // labels: bool bytes -> f32 column
    {
      std::vector<uint8_t> raw(rows);
      if (!ReadRaw(label_fd, raw.data(), rows, idx * batch_size)) return false;
      int64_t lo = 0, n = rows;
      if (offset >= 0 && slice_labels) {
        lo = offset;
        n = std::min<int64_t>(lbs, rows - lo);
      }
      out->labels.resize(n > 0 ? n : 0);
      for (int64_t i = 0; i < (int64_t)out->labels.size(); ++i)
        out->labels[i] = raw[lo + i] ? 1.0f : 0.0f;
    }
    // numerical: fp16 -> f32
    if (numerical_fd >= 0) {
      const int64_t elems = rows * num_numerical;
      std::vector<uint16_t> raw(elems);
      if (!ReadRaw(numerical_fd, raw.data(), elems * 2,
                   idx * batch_size * num_numerical * 2))
        return false;
      int64_t lo = 0, n = rows;
      if (offset >= 0) {
        lo = offset;
        n = std::min<int64_t>(lbs, rows - lo);
      }
      if (n < 0) n = 0;
      out->numerical.resize(n * num_numerical);
      const uint16_t* src = raw.data() + lo * num_numerical;
      for (int64_t i = 0; i < (int64_t)out->numerical.size(); ++i)
        out->numerical[i] = HalfToFloat(src[i]);
    } else {
      out->numerical.clear();
    }
    // categoricals: intN -> int32, one stripe per table
    const int64_t cat_lo = (offset >= 0 && slice_cats) ? offset : 0;
    const int64_t cat_rows =
        (offset >= 0 && slice_cats)
            ? std::max<int64_t>(0, std::min<int64_t>(lbs, rows - cat_lo))
            : rows;
    out->cats.resize((int64_t)cat_fds.size() * cat_rows);
    for (size_t c = 0; c < cat_fds.size(); ++c) {
      const int isz = cat_itemsize[c];
      std::vector<uint8_t> raw(rows * isz);
      if (!ReadRaw(cat_fds[c], raw.data(), rows * isz,
                   idx * batch_size * isz))
        return false;
      int32_t* dst = out->cats.data() + c * cat_rows;
      const uint8_t* src = raw.data() + cat_lo * isz;
      switch (isz) {
        case 1:
          for (int64_t i = 0; i < cat_rows; ++i)
            dst[i] = (int32_t) reinterpret_cast<const int8_t*>(src)[i];
          break;
        case 2:
          for (int64_t i = 0; i < cat_rows; ++i) {
            int16_t v;
            std::memcpy(&v, src + i * 2, 2);
            dst[i] = v;
          }
          break;
        case 4:
          std::memcpy(dst, src, cat_rows * 4);
          break;
        default:
          return false;
      }
    }
    return true;
  }

  void WorkerLoop() {
    while (!stop.load()) {
      int64_t idx, gen;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || ((int)ring.size() < prefetch_depth &&
                                 next_to_read < num_batches);
        });
        if (stop.load()) return;
        if (next_to_read >= num_batches) continue;
        idx = next_to_read++;
        gen = generation;
      }
      DecodedBatch b;
      b.error = !Decode(idx, &b);
      b.idx = idx;  // error or not, the marker names its batch
      {
        std::lock_guard<std::mutex> lk(mu);
        if (gen != generation) continue;  // seek cleared the ring meanwhile
        ring.push_back(std::move(b));
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Opens a loader. cat_ids/cat_itemsizes describe which cat_<id>.bin files
// to read and their per-element byte width (1/2/4).  Returns nullptr on
// error.  drop_last: floor instead of ceil on the batch count.
void* det_loader_open(const char* dir, int64_t batch_size,
                      int num_numerical, const int* cat_ids,
                      const int* cat_itemsizes, int n_cats,
                      int prefetch_depth, int drop_last, int64_t offset,
                      int64_t lbs, int slice_labels, int slice_cats) {
  auto ld = new Loader();
  std::string base(dir);
  ld->batch_size = batch_size;
  ld->num_numerical = num_numerical;
  ld->offset = offset;
  ld->lbs = lbs;
  ld->slice_labels = slice_labels != 0;
  ld->slice_cats = slice_cats != 0;

  ld->label_fd = open((base + "/label.bin").c_str(), O_RDONLY);
  if (ld->label_fd < 0) {
    delete ld;
    return nullptr;
  }
  struct stat st;
  fstat(ld->label_fd, &st);
  const int64_t entries = st.st_size;
  ld->num_batches =
      drop_last ? entries / batch_size : (entries + batch_size - 1) / batch_size;
  ld->last_batch_rows = drop_last ? batch_size
                                  : entries - (ld->num_batches - 1) * batch_size;
  // Cross-validate stream sizes against label.bin's row count (mirrors the
  // Python loader's "Size mismatch in data files" check; without it a
  // truncated or mismatched file would only surface as a failed read — or,
  // before ReadRaw became strict, as silent zero-filled batches).
  if (num_numerical > 0) {
    ld->numerical_fd = open((base + "/numerical.bin").c_str(), O_RDONLY);
    if (ld->numerical_fd < 0) {
      delete ld;
      return nullptr;
    }
    if (fstat(ld->numerical_fd, &st) != 0 ||
        st.st_size != entries * (int64_t)num_numerical * 2) {
      delete ld;
      return nullptr;
    }
  }
  for (int c = 0; c < n_cats; ++c) {
    int fd = open((base + "/cat_" + std::to_string(cat_ids[c]) + ".bin").c_str(),
                  O_RDONLY);
    if (fd < 0) {
      delete ld;
      return nullptr;
    }
    ld->cat_fds.push_back(fd);
    ld->cat_itemsize.push_back(cat_itemsizes[c]);
    if (fstat(fd, &st) != 0 ||
        st.st_size != entries * (int64_t)cat_itemsizes[c]) {
      delete ld;
      return nullptr;
    }
  }
  ld->prefetch_depth = prefetch_depth;
  if (prefetch_depth > 1) ld->worker = std::thread(&Loader::WorkerLoop, ld);
  return ld;
}

int64_t det_loader_num_batches(void* h) {
  return static_cast<Loader*>(h)->num_batches;
}

// Unsliced row count of batch `idx` (the final batch may be short);
// callers apply their own DP-slice arithmetic per stream.
int64_t det_loader_rows(void* h, int64_t idx) {
  return static_cast<Loader*>(h)->RowsOf(idx);
}

// Copies batch `idx` into caller buffers (each may be nullptr to skip).
// labels_out: [sliced_rows] f32; numerical_out: [sliced_rows*num_numerical]
// f32; cats_out: [n_cats * cat_rows] int32.  Returns 0 on success.
int det_loader_get(void* h, int64_t idx, float* labels_out,
                   float* numerical_out, int32_t* cats_out) {
  auto* ld = static_cast<Loader*>(h);
  if (idx < 0 || idx >= ld->num_batches) return 1;

  DecodedBatch local;
  DecodedBatch* b = nullptr;
  if (ld->prefetch_depth > 1) {
    std::unique_lock<std::mutex> lk(ld->mu);
    // sequential fast path: batch is (or will be) in the ring
    if (!ld->ring.empty() && ld->ring.front().idx <= idx &&
        idx < ld->next_to_read) {
      ld->cv_ready.wait(lk, [&] {
        for (auto& d : ld->ring)
          if (d.idx == idx) return true;
        return false;
      });
      // drop everything before idx, keep later read-ahead
      while (!ld->ring.empty() && ld->ring.front().idx < idx)
        ld->ring.pop_front();
      if (!ld->ring.empty() && ld->ring.front().idx == idx) {
        if (ld->ring.front().error) {
          // consume the marker (its idx is this batch): the failure is
          // reported once and a retry can go through the inline path
          ld->ring.pop_front();
          ld->cv_space.notify_all();
          return 2;
        }
        local = std::move(ld->ring.front());
        ld->ring.pop_front();
        b = &local;
      }
      ld->cv_space.notify_all();
    } else if (idx >= ld->next_to_read || ld->ring.empty()) {
      // random seek: restart read-ahead at idx+1, decode idx inline
      ld->ring.clear();
      ++ld->generation;
      ld->next_to_read = idx + 1;
      ld->cv_space.notify_all();
    }
  }
  if (b == nullptr) {
    if (!ld->Decode(idx, &local)) return 2;
    b = &local;
  }
  if (labels_out)
    std::memcpy(labels_out, b->labels.data(), b->labels.size() * 4);
  if (numerical_out)
    std::memcpy(numerical_out, b->numerical.data(), b->numerical.size() * 4);
  if (cats_out && !b->cats.empty())
    std::memcpy(cats_out, b->cats.data(), b->cats.size() * 4);
  return 0;
}

void det_loader_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
