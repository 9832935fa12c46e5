// Native data-loading runtime: multi-threaded .npy case reader with a
// bounded prefetch queue (the port's copy of transoar_tpu/native/loader.cpp,
// the same code).
//
// A C++ thread pool reads preprocessed .npy volumes straight into reusable
// buffers; Python (ctypes, native_loader.py) hands out epoch orders and
// drains the cases in order. It stands in for the reference's DataLoader
// worker processes (reference transoar/data/dataloader.py:19-23).
//
// Supports NumPy .npy format v1.0/2.0, C-order, little-endian f32 ("<f4")
// images and i32 ("<i4") labels with identical fixed shapes per dataset —
// exactly what the offline preprocessor writes.
//
// Built at first use by native_loader.py:
//   g++ -O2 -shared -fPIC -std=c++17 -pthread loader.cpp -o <build>/loader-<hash>.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  std::vector<int64_t> shape;
  std::string dtype;      // e.g. "<f4"
  size_t data_offset = 0;
  size_t num_elems = 1;
};

bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint16_t len16;
    if (fread(&len16, 2, 1, f) != 1) return false;
    header_len = len16;
    info->data_offset = 10 + header_len;
  } else {
    if (fread(&header_len, 4, 1, f) != 1) return false;
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  // descr
  size_t d = header.find("'descr'");
  if (d == std::string::npos) return false;
  size_t q1 = header.find('\'', d + 7);
  size_t q2 = header.find('\'', q1 + 1);
  info->dtype = header.substr(q1 + 1, q2 - q1 - 1);

  // fortran_order must be False
  if (header.find("'fortran_order': True") != std::string::npos) return false;

  // shape tuple
  size_t s = header.find("'shape'");
  size_t p1 = header.find('(', s);
  size_t p2 = header.find(')', p1);
  std::string tup = header.substr(p1 + 1, p2 - p1 - 1);
  info->shape.clear();
  info->num_elems = 1;
  const char* ptr = tup.c_str();
  while (*ptr) {
    while (*ptr == ' ' || *ptr == ',') ptr++;
    if (!*ptr) break;
    int64_t v = strtoll(ptr, const_cast<char**>(&ptr), 10);
    if (v > 0) {
      info->shape.push_back(v);
      info->num_elems *= v;
    }
  }
  return true;
}

// Read a full npy file into dst (expects elem_size * expected_elems bytes).
bool read_npy(const std::string& path, void* dst, size_t expected_elems,
              const char* expected_dtype) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  NpyInfo info;
  if (!parse_npy_header(f, &info) || info.num_elems != expected_elems ||
      info.dtype != expected_dtype) {
    fclose(f);
    return false;
  }
  size_t elem_size = 4;  // f4 / i4
  if (fseek(f, static_cast<long>(info.data_offset), SEEK_SET) != 0) {
    fclose(f);
    return false;
  }
  size_t got = fread(dst, elem_size, expected_elems, f);
  fclose(f);
  return got == expected_elems;
}

struct Case {
  std::vector<float> image;
  std::vector<int32_t> label;
  int64_t index = -1;
  bool ok = false;
};

class Loader {
 public:
  Loader(std::vector<std::string> image_paths,
         std::vector<std::string> label_paths, size_t voxels, int n_threads,
         int capacity)
      : image_paths_(std::move(image_paths)),
        label_paths_(std::move(label_paths)),
        voxels_(voxels),
        capacity_(capacity > 0 ? capacity : 8),
        n_threads_(n_threads > 0 ? n_threads : 4) {}

  ~Loader() { stop(); }

  // Start (or restart) an epoch over the given case order.
  void set_epoch(const int64_t* order, int n) {
    stop();
    {
      std::lock_guard<std::mutex> lk(mu_);
      order_.assign(order, order + n);
      next_submit_ = 0;
      next_emit_ = 0;
      ready_.clear();
      stopping_ = false;
    }
    for (int i = 0; i < n_threads_; ++i) {
      threads_.emplace_back([this] { worker(); });
    }
  }

  // Blocks until the next case (in epoch order) is ready; copies out.
  // Returns the case index, or -1 at end of epoch, -2 on read error.
  int64_t next(float* image_out, int32_t* label_out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (next_emit_ >= order_.size()) return -1;
    size_t want = next_emit_;
    cv_ready_.wait(lk, [&] {
      return stopping_ || ready_.count(want) > 0;
    });
    if (stopping_) return -1;
    Case c = std::move(ready_[want]);
    ready_.erase(want);
    next_emit_++;
    cv_space_.notify_all();
    lk.unlock();

    if (!c.ok) return -2;
    memcpy(image_out, c.image.data(), voxels_ * sizeof(float));
    memcpy(label_out, c.label.data(), voxels_ * sizeof(int32_t));
    return c.index;
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stopping_ = true;
    }
    cv_ready_.notify_all();
    cv_space_.notify_all();
    for (auto& t : threads_) {
      if (t.joinable()) t.join();
    }
    threads_.clear();
  }

 private:
  void worker() {
    while (true) {
      size_t slot;
      int64_t case_idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [&] {
          return stopping_ || (next_submit_ < order_.size() &&
                               next_submit_ < next_emit_ + capacity_);
        });
        if (stopping_ || next_submit_ >= order_.size()) return;
        slot = next_submit_++;
        case_idx = order_[slot];
      }

      Case c;
      c.index = case_idx;
      c.image.resize(voxels_);
      c.label.resize(voxels_);
      c.ok = read_npy(image_paths_[case_idx], c.image.data(), voxels_,
                      "<f4") &&
             read_npy(label_paths_[case_idx], c.label.data(), voxels_,
                      "<i4");

      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_[slot] = std::move(c);
      }
      cv_ready_.notify_all();
    }
  }

  std::vector<std::string> image_paths_;
  std::vector<std::string> label_paths_;
  size_t voxels_;
  size_t capacity_;
  int n_threads_;

  std::mutex mu_;
  std::condition_variable cv_ready_;
  std::condition_variable cv_space_;
  std::vector<std::thread> threads_;
  std::vector<int64_t> order_;
  std::map<size_t, Case> ready_;
  size_t next_submit_ = 0;
  size_t next_emit_ = 0;
  bool stopping_ = false;
};

}  // namespace

extern "C" {

void* nl_create(const char** image_paths, const char** label_paths, int n,
                int64_t voxels, int n_threads, int capacity) {
  std::vector<std::string> imgs(image_paths, image_paths + n);
  std::vector<std::string> lbls(label_paths, label_paths + n);
  return new Loader(std::move(imgs), std::move(lbls),
                    static_cast<size_t>(voxels), n_threads, capacity);
}

void nl_set_epoch(void* handle, const int64_t* order, int n) {
  static_cast<Loader*>(handle)->set_epoch(order, n);
}

int64_t nl_next(void* handle, float* image_out, int32_t* label_out) {
  return static_cast<Loader*>(handle)->next(image_out, label_out);
}

void nl_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
