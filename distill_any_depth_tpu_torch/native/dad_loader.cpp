// Native host-side data loading for NYU batches: the C++ copy of the
// Python loader (data/nyu.py) that the PyTorch port's train_nyu takes by
// default (data/native_loader.py builds it with g++ against the system
// OpenCV and binds it with ctypes).
//
// A thread pool decodes and preprocesses RGB + depth pairs into a bounded
// REORDER buffer, so the host keeps the card fed: BGR->RGB, a square
// INTER_CUBIC resize of the RGB frame, INTER_NEAREST of the depth, uint8
// depth / 255 and uint16 / 65535, optional ImageNet normalization, and a
// bounded random retry on an unreadable file. The arithmetic is the
// Python loader's, in float32 and in its order ((v / 255 - mean) / std, a
// true division by the depth scale), so the two loaders give the same
// batch bit for bit wherever their OpenCV builds resize alike.
//
// Ordering lives in Python: dad_loader_set_epoch installs an explicit index
// order (the seeded global shuffle and round-robin shard of
// data/nyu.epoch_order, the Python loader's own), so both loaders yield the
// same epochs and a resume stays data-exact. Workers decode positions
// concurrently; next_batch delivers them strictly in order through the
// reorder buffer, so the stream is deterministic despite the pool.
//
// C API (ctypes): dad_loader_create, dad_loader_set_epoch,
// dad_loader_num_samples, dad_loader_next_batch, dad_loader_destroy. The
// output is NHWC float32.

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <mutex>
#include <random>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kImagenetMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kImagenetStd[3] = {0.229f, 0.224f, 0.225f};

struct Sample {
  std::vector<float> image;  // [H, W, 3]
  std::vector<float> depth;  // [H, W]
};

class Loader {
 public:
  Loader(const std::string& csv_path, const std::string& root, int image_size,
         bool normalize, bool raw_255, int num_threads, int queue_capacity)
      : size_(image_size),
        normalize_(normalize),
        raw_255_(raw_255),
        capacity_(std::max(queue_capacity, 2)) {
    std::ifstream f(csv_path);
    std::string line;
    while (std::getline(f, line)) {
      if (line.empty()) continue;
      auto comma = line.find(',');
      if (comma == std::string::npos) continue;
      std::string rgb = line.substr(0, comma);
      std::string depth = line.substr(comma + 1);
      // strip trailing CR / whitespace
      while (!depth.empty() && (depth.back() == '\r' || depth.back() == ' '))
        depth.pop_back();
      pairs_.emplace_back(join(root, rgb), join(root, depth));
    }
    if (pairs_.empty()) return;
    int n = std::max(num_threads, 1);
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this, i] { worker_loop(i); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_) t.join();
  }

  long num_samples() const { return static_cast<long>(pairs_.size()); }

  // Install the next stretch of the sample stream (row indices into the
  // CSV, already globally shuffled + sharded by the Python policy layer).
  // Resets delivery to position 0 of the new order; in-flight decodes from
  // a previous order are dropped via the generation counter.
  void set_epoch(const int64_t* indices, long n) {
    std::lock_guard<std::mutex> lk(mu_);
    order_.assign(indices, indices + n);
    take_pos_ = 0;
    expect_pos_ = 0;
    ++epoch_gen_;
    ready_.clear();
    failed_.clear();
    cv_work_.notify_all();
  }

  // Fills images [batch, H, W, 3] and depths [batch, H, W] in the EXACT
  // installed order; returns the number of samples written (< batch on
  // shutdown, exhausted order, or unrecoverable decode failure).
  int next_batch(int batch, float* images, float* depths) {
    const size_t img_elems = static_cast<size_t>(size_) * size_ * 3;
    const size_t dep_elems = static_cast<size_t>(size_) * size_;
    for (int b = 0; b < batch; ++b) {
      std::unique_lock<std::mutex> lk(mu_);
      if (expect_pos_ >= static_cast<long>(order_.size())) return b;
      cv_ready_.wait(lk, [this] {
        return stop_ || ready_.count(expect_pos_) || failed_.count(expect_pos_);
      });
      if (stop_ || failed_.count(expect_pos_)) return b;
      Sample s = std::move(ready_[expect_pos_]);
      ready_.erase(expect_pos_);
      ++expect_pos_;
      lk.unlock();
      cv_work_.notify_all();
      std::memcpy(images + b * img_elems, s.image.data(),
                  img_elems * sizeof(float));
      std::memcpy(depths + b * dep_elems, s.depth.data(),
                  dep_elems * sizeof(float));
    }
    return batch;
  }

 private:
  static std::string join(const std::string& root, const std::string& rel) {
    if (rel.empty() || rel.front() == '/' || root.empty()) return rel;
    return root + "/" + rel;
  }

  bool load_sample(size_t idx, Sample* out) {
    const auto& pr = pairs_[idx];
    cv::Mat rgb = cv::imread(pr.first, cv::IMREAD_COLOR);
    if (rgb.empty()) return false;
    cv::cvtColor(rgb, rgb, cv::COLOR_BGR2RGB);
    cv::resize(rgb, rgb, cv::Size(size_, size_), 0, 0, cv::INTER_CUBIC);

    cv::Mat depth = cv::imread(pr.second, cv::IMREAD_UNCHANGED);
    if (depth.empty()) return false;
    cv::resize(depth, depth, cv::Size(size_, size_), 0, 0, cv::INTER_NEAREST);

    out->image.resize(static_cast<size_t>(size_) * size_ * 3);
    out->depth.resize(static_cast<size_t>(size_) * size_);

    for (int y = 0; y < size_; ++y) {
      const uint8_t* row = rgb.ptr<uint8_t>(y);
      float* dst = out->image.data() + static_cast<size_t>(y) * size_ * 3;
      for (int x = 0; x < size_ * 3; x += 3) {
        for (int c = 0; c < 3; ++c) {
          float v = static_cast<float>(row[x + c]);
          if (raw_255_) {
            dst[x + c] = v;  // unnormalized 0-255 floats
          } else if (normalize_) {
            dst[x + c] = (v / 255.0f - kImagenetMean[c]) / kImagenetStd[c];
          } else {
            dst[x + c] = v / 255.0f;
          }
        }
      }
    }

    if (depth.channels() > 1) {
      std::vector<cv::Mat> ch;
      cv::split(depth, ch);
      depth = ch[0];
    }
    const float depth_scale = depth.depth() == CV_16U ? 65535.0f : 255.0f;
    for (int y = 0; y < size_; ++y) {
      float* dst = out->depth.data() + static_cast<size_t>(y) * size_;
      if (depth.depth() == CV_16U) {
        const uint16_t* row = depth.ptr<uint16_t>(y);
        for (int x = 0; x < size_; ++x) dst[x] = row[x] / depth_scale;
      } else {
        const uint8_t* row = depth.ptr<uint8_t>(y);
        for (int x = 0; x < size_; ++x) dst[x] = row[x] / depth_scale;
      }
    }
    return true;
  }

  void worker_loop(int worker_id) {
    std::mt19937 retry_rng(static_cast<unsigned>(worker_id) * 7919u + 13u);
    while (true) {
      long pos, gen;
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        // take the next position, but never run more than `capacity_`
        // positions ahead of delivery — bounds the reorder buffer and
        // guarantees the expected position is always admissible
        cv_work_.wait(lk, [this] {
          return stop_ || (take_pos_ < static_cast<long>(order_.size()) &&
                           take_pos_ < expect_pos_ + capacity_);
        });
        if (stop_) return;
        pos = take_pos_++;
        idx = static_cast<size_t>(order_[pos]) % pairs_.size();
        gen = epoch_gen_;
      }
      Sample s;
      bool ok = load_sample(idx, &s);
      // bounded random retry on an unreadable file
      for (int attempt = 0; !ok && attempt < 10; ++attempt) {
        idx = retry_rng() % pairs_.size();
        ok = load_sample(idx, &s);
      }

      std::unique_lock<std::mutex> lk(mu_);
      if (gen != epoch_gen_) continue;  // stale epoch: drop the result
      if (!ok) {
        failed_.insert(pos);  // surfaced to next_batch as a short read
      } else {
        ready_.emplace(pos, std::move(s));
      }
      lk.unlock();
      cv_ready_.notify_all();
    }
  }

  int size_;
  bool normalize_;
  bool raw_255_;
  int capacity_;

  std::vector<std::pair<std::string, std::string>> pairs_;

  // epoch order + reorder buffer (all guarded by mu_)
  std::vector<int64_t> order_;
  long take_pos_ = 0;    // next position a worker will decode
  long expect_pos_ = 0;  // next position next_batch delivers
  long epoch_gen_ = 0;
  std::map<long, Sample> ready_;
  std::set<long> failed_;

  std::mutex mu_;
  std::condition_variable cv_work_, cv_ready_;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* dad_loader_create(const char* csv_path, const char* root, int image_size,
                        int normalize, int raw_255, int num_threads,
                        int queue_capacity) {
  try {
    auto* l = new Loader(csv_path ? csv_path : "", root ? root : "",
                         image_size, normalize != 0, raw_255 != 0, num_threads,
                         queue_capacity);
    if (l->num_samples() == 0) {
      delete l;
      return nullptr;
    }
    return l;
  } catch (...) {
    return nullptr;
  }
}

void dad_loader_set_epoch(void* handle, const int64_t* indices, long n) {
  if (handle && indices && n >= 0)
    static_cast<Loader*>(handle)->set_epoch(indices, n);
}

long dad_loader_num_samples(void* handle) {
  return handle ? static_cast<Loader*>(handle)->num_samples() : 0;
}

int dad_loader_next_batch(void* handle, int batch, float* images,
                          float* depths) {
  if (!handle) return 0;
  try {
    return static_cast<Loader*>(handle)->next_batch(batch, images, depths);
  } catch (...) {
    return 0;
  }
}

void dad_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
