// Fully-connected CRF with Gaussian pairwise potentials — mean-field
// inference via permutohedral-lattice filtering.
//
// TPU-native-framework replacement for the reference's external `denseCRF`
// (SimpleCRF) dependency (reference: vae_utility.py:12,39 — the one native
// C++ component the pipeline leans on). Implements the same semantics:
// unary = -log(prob); two pairwise kernels — bilateral (position/alpha,
// color/beta, weight w1) and spatial (position/gamma, weight w2) — Potts
// compatibility, symmetric kernel normalization, `iters` mean-field updates,
// argmax segmentation. The permutohedral lattice is implemented from the
// Adams/Baek/Davis 2010 algorithm description (splat → blur along d+1
// lattice directions → slice) — written fresh for this framework, not
// copied from any existing CRF codebase.
//
// Performance notes (every transformation below preserves float arithmetic
// order, so segmentations are bit-identical to the straightforward form):
//   * hash slots pack a 32-bit key fingerprint next to the index, so probe
//     chains resolve in one cache line and memcmp runs only on fingerprint
//     hits;
//   * the blur adjacency is symmetric (hi(lo(m)) == m), so only the `lo`
//     neighbor is looked up in the table and `hi` is derived by inversion —
//     halving the init-phase hash traffic;
//   * filter inner loops are compile-time specialized for the value sizes
//     this pipeline uses (vs = 1 for kernel norms, vs = 2 for binary masks);
//   * per-call lattice scratch is thread_local and reused across the 2
//     kernels × iters filter calls per frame (the shared spatial kernel is
//     filtered concurrently by the batch threads, so scratch must be
//     per-thread, not per-lattice).
//
// Exported C API (ctypes-friendly):
//   densecrf_single : one (H,W,3) uint8 image + (H,W,L) float prob
//   densecrf_batch  : N frames, OpenMP-parallel across frames
//
// Build: g++ -O3 -fopenmp -shared -fPIC densecrf.cpp -o libdensecrf.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Hash table for lattice keys (open addressing, power-of-two capacity,
// fingerprint-packed slots: high 32 bits key fingerprint, low 32 bits
// index+1; 0 = empty).
// ---------------------------------------------------------------------------
class KeyTable {
 public:
  KeyTable(int key_size, size_t expected)
      : key_size_(key_size), filled_(0) {
    capacity_ = 1;
    while (capacity_ < expected * 2) capacity_ <<= 1;
    slots_.assign(capacity_, 0);
    keys_.reserve(expected * key_size_);
  }

  int size() const { return filled_; }
  const short* key(int i) const { return keys_.data() + (size_t)i * key_size_; }

  // Returns the index of `key`, inserting if absent; -1 when absent and
  // !create. Slot layout: high 32 bits fingerprint, low 32 bits index+1
  // (so an occupied slot is always nonzero).
  int find_or_insert(const short* key, bool create) {
    const uint64_t h = hash(key);
    const uint32_t fp = (uint32_t)(h >> 32);
    size_t pos = h & (capacity_ - 1);
    for (;;) {
      uint64_t slot = slots_[pos];
      if (slot == 0) {
        if (!create) return -1;
        keys_.insert(keys_.end(), key, key + key_size_);
        slots_[pos] = ((uint64_t)fp << 32) | (uint32_t)(filled_ + 1);
        return filled_++;
      }
      if ((uint32_t)(slot >> 32) == fp) {
        int idx = (int)(uint32_t)slot - 1;
        if (std::memcmp(keys_.data() + (size_t)idx * key_size_, key,
                        key_size_ * sizeof(short)) == 0)
          return idx;
      }
      pos = (pos + 1) & (capacity_ - 1);
    }
  }

 private:
  uint64_t hash(const short* key) const {
    uint64_t r = 14695981039346656037ull;
    for (int i = 0; i < key_size_; i++) {
      r ^= (uint64_t)(unsigned short)key[i];
      r *= 1099511628211ull;
    }
    return r;
  }

  int key_size_;
  size_t capacity_;
  int filled_;
  std::vector<uint64_t> slots_;
  std::vector<short> keys_;
};

// ---------------------------------------------------------------------------
// Permutohedral lattice (d-dimensional features, N points).
// ---------------------------------------------------------------------------
class Permutohedral {
 public:
  void init(const float* features, int d, int N) {
    d_ = d;
    N_ = N;
    offset_.assign((size_t)N * (d + 1), 0);
    barycentric_.assign((size_t)N * (d + 1), 0.f);

    KeyTable table(d, (size_t)N * (d + 1));

    // Canonical simplex coordinates.
    std::vector<short> canonical((d + 1) * (d + 1));
    for (int i = 0; i <= d; i++) {
      for (int j = 0; j <= d - i; j++) canonical[i * (d + 1) + j] = i;
      for (int j = d - i + 1; j <= d; j++) canonical[i * (d + 1) + j] = i - (d + 1);
    }

    std::vector<float> scale(d);
    float inv_std = std::sqrt(2.0f / 3.0f) * (d + 1);
    for (int i = 0; i < d; i++)
      scale[i] = inv_std / std::sqrt((float)(i + 1) * (i + 2));

    std::vector<float> elevated(d + 1), bary(d + 2);
    std::vector<short> rem0(d + 1), rank(d + 1), key(d);

    for (int n = 0; n < N; n++) {
      const float* f = features + (size_t)n * d;
      // Embed into the hyperplane sum(x)=0 in d+1 dims.
      float sm = 0.f;
      for (int j = d; j > 0; j--) {
        float cf = f[j - 1] * scale[j - 1];
        elevated[j] = sm - j * cf;
        sm += cf;
      }
      elevated[0] = sm;

      // Nearest zero-colored lattice point (multiples of d+1).
      int sum = 0;
      for (int i = 0; i <= d; i++) {
        int rd = (int)std::lround(elevated[i] / (d + 1));
        rem0[i] = (short)(rd * (d + 1));
        sum += rd;
      }
      // Rank the differentials.
      std::fill(rank.begin(), rank.end(), (short)0);
      for (int i = 0; i < d; i++)
        for (int j = i + 1; j <= d; j++) {
          if (elevated[i] - rem0[i] < elevated[j] - rem0[j])
            rank[i]++;
          else
            rank[j]++;
        }
      // Repair points that rounded outside the canonical simplex.
      for (int i = 0; i <= d; i++) {
        rank[i] += (short)sum;
        if (rank[i] < 0) {
          rank[i] += (short)(d + 1);
          rem0[i] += (short)(d + 1);
        } else if (rank[i] > d) {
          rank[i] -= (short)(d + 1);
          rem0[i] -= (short)(d + 1);
        }
      }
      // Barycentric coordinates inside the simplex.
      std::fill(bary.begin(), bary.end(), 0.f);
      for (int i = 0; i <= d; i++) {
        float v = (elevated[i] - rem0[i]) / (d + 1);
        bary[d - rank[i]] += v;
        bary[d - rank[i] + 1] -= v;
      }
      bary[0] += 1.0f + bary[d + 1];

      // Splat indices for each simplex vertex.
      for (int r = 0; r <= d; r++) {
        for (int i = 0; i < d; i++)
          key[i] = (short)(rem0[i] + canonical[r * (d + 1) + rank[i]]);
        offset_[(size_t)n * (d + 1) + r] = table.find_or_insert(key.data(), true);
        barycentric_[(size_t)n * (d + 1) + r] = bary[r];
      }
    }

    M_ = table.size();

    // Blur neighbors along each of the d+1 lattice directions. The relation
    // is symmetric — nhi(nlo(m)) == m — so only `lo` is looked up and `hi`
    // is filled by inversion.
    blur_lo_.assign((size_t)M_ * (d + 1), -1);
    blur_hi_.assign((size_t)M_ * (d + 1), -1);
    std::vector<short> nlo(d);
    for (int m = 0; m < M_; m++) {
      const short* k = table.key(m);
      for (int j = 0; j <= d; j++) {
        for (int i = 0; i < d; i++) nlo[i] = (short)(k[i] + 1);
        if (j < d) nlo[j] = (short)(k[j] - d);
        int lo = table.find_or_insert(nlo.data(), false);
        blur_lo_[(size_t)j * M_ + m] = lo;
        if (lo >= 0) blur_hi_[(size_t)j * M_ + lo] = m;
      }
    }
  }

  int num_points() const { return N_; }
  int num_lattice() const { return M_; }

  // out = Gaussian-filter(in) over the lattice; in/out are (N, vs) row-major.
  void compute(float* out, const float* in, int vs) const {
    switch (vs) {
      case 1: return compute_impl<1>(out, in, 1);
      case 2: return compute_impl<2>(out, in, 2);
      default: return compute_impl<0>(out, in, vs);
    }
  }

 private:
  // VS = compile-time value size (0 = runtime `vs`). The arithmetic and its
  // order are identical for every instantiation.
  template <int VS>
  void compute_impl(float* out, const float* in, int vs_rt) const {
    const int vs = VS ? VS : vs_rt;
    // Thread-local scratch: reused across the 2-kernels × iters calls per
    // frame, and per-thread because batch threads filter the shared spatial
    // lattice concurrently.
    static thread_local std::vector<float> vals, newv;
    const size_t need = (size_t)(M_ + 1) * vs;  // slot 0 = null
    if (vals.size() < need) vals.resize(need);
    if (newv.size() < need) newv.resize(need);
    std::memset(vals.data(), 0, need * sizeof(float));
    std::memset(newv.data(), 0, (size_t)vs * sizeof(float));  // null slot only
    float* values = vals.data() + vs;  // index -1 → null slot
    float* new_values = newv.data() + vs;

    // Splat.
    const int* off = offset_.data();
    const float* bar = barycentric_.data();
    for (int n = 0; n < N_; n++) {
      const float* src = in + (size_t)n * vs;
      for (int r = 0; r <= d_; r++) {
        const size_t nr = (size_t)n * (d_ + 1) + r;
        float w = bar[nr];
        float* dst = values + (size_t)off[nr] * vs;
        for (int k = 0; k < vs; k++) dst[k] += w * src[k];
      }
    }

    // Blur along each lattice direction: [0.5, 1, 0.5].
    for (int j = 0; j <= d_; j++) {
      const int* lo_row = blur_lo_.data() + (size_t)j * M_;
      const int* hi_row = blur_hi_.data() + (size_t)j * M_;
      for (int m = 0; m < M_; m++) {
        const float* c = values + (size_t)m * vs;
        const float* l = values + (size_t)lo_row[m] * vs;  // -1 → null slot
        const float* h = values + (size_t)hi_row[m] * vs;
        float* o = new_values + (size_t)m * vs;
        for (int k = 0; k < vs; k++) o[k] = c[k] + 0.5f * (l[k] + h[k]);
      }
      std::swap(values, new_values);
    }

    // Slice (with the lattice's fixed gain correction).
    const float alpha = 1.0f / (1.0f + std::pow(2.0f, -(float)d_));
    for (int n = 0; n < N_; n++) {
      float* dst = out + (size_t)n * vs;
      for (int k = 0; k < vs; k++) dst[k] = 0.f;
      for (int r = 0; r <= d_; r++) {
        const size_t nr = (size_t)n * (d_ + 1) + r;
        float w = bar[nr];
        const float* src = values + (size_t)off[nr] * vs;
        for (int k = 0; k < vs; k++) dst[k] += alpha * w * src[k];
      }
    }
  }

  int d_ = 0, N_ = 0, M_ = 0;
  std::vector<int> offset_;
  std::vector<float> barycentric_;
  std::vector<int> blur_lo_, blur_hi_;
};

// ---------------------------------------------------------------------------
// Pairwise kernel: symmetric-normalized lattice filter + Potts weight.
// ---------------------------------------------------------------------------
struct PairwiseKernel {
  Permutohedral lattice;
  std::vector<float> norm;  // 1/sqrt(filter(1)) per pixel
  float weight;

  void init(const float* features, int d, int N, float w) {
    weight = w;
    lattice.init(features, d, N);
    std::vector<float> ones(N, 1.f);
    norm.assign(N, 0.f);
    lattice.compute(norm.data(), ones.data(), 1);
    for (int i = 0; i < N; i++) norm[i] = 1.0f / std::sqrt(norm[i] + 1e-20f);
  }

  // next += weight * norm .* filter(norm .* Q), per label column.
  void apply(float* next, const float* Q, int N, int L,
             std::vector<float>& tmp_in, std::vector<float>& tmp_out) const {
    if (L == 2) {
      for (int i = 0; i < N; i++) {
        tmp_in[(size_t)i * 2 + 0] = Q[(size_t)i * 2 + 0] * norm[i];
        tmp_in[(size_t)i * 2 + 1] = Q[(size_t)i * 2 + 1] * norm[i];
      }
    } else {
      for (int i = 0; i < N; i++)
        for (int l = 0; l < L; l++)
          tmp_in[(size_t)i * L + l] = Q[(size_t)i * L + l] * norm[i];
    }
    lattice.compute(tmp_out.data(), tmp_in.data(), L);
    if (L == 2) {
      for (int i = 0; i < N; i++) {
        const float wn = weight * norm[i];
        next[(size_t)i * 2 + 0] += wn * tmp_out[(size_t)i * 2 + 0];
        next[(size_t)i * 2 + 1] += wn * tmp_out[(size_t)i * 2 + 1];
      }
    } else {
      for (int i = 0; i < N; i++)
        for (int l = 0; l < L; l++)
          next[(size_t)i * L + l] += weight * norm[i] * tmp_out[(size_t)i * L + l];
    }
  }
};

// Build the spatial (x/γ, y/γ) Potts kernel; identical for every frame of a
// given (H, W, γ, w2), so batch callers build it once and share it
// (lattice compute() is const with thread-local scratch — thread-safe).
void build_spatial_kernel(PairwiseKernel& k, int H, int W, float gamma, float w2) {
  const int N = H * W;
  std::vector<float> feat((size_t)N * 2);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      feat[(size_t)(y * W + x) * 2 + 0] = x / gamma;
      feat[(size_t)(y * W + x) * 2 + 1] = y / gamma;
    }
  k.init(feat.data(), 2, N, w2);
}

void mean_field(const uint8_t* img, const float* prob, int H, int W, int L,
                float w1, float alpha, float beta, float w2, float gamma,
                int iters, uint8_t* out_seg,
                const PairwiseKernel* shared_spatial = nullptr) {
  const int N = H * W;

  // Unary: -log(prob), clamped.
  std::vector<float> unary((size_t)N * L);
  for (size_t i = 0; i < (size_t)N * L; i++) {
    float p = prob[i];
    if (p < 1e-8f) p = 1e-8f;
    unary[i] = -std::log(p);
  }

  // Feature builds (bilateral depends on this frame's colors; spatial may
  // be shared across a batch).
  std::vector<float> feat_bilateral((size_t)N * 5);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      int i = y * W + x;
      feat_bilateral[(size_t)i * 5 + 0] = x / alpha;
      feat_bilateral[(size_t)i * 5 + 1] = y / alpha;
      feat_bilateral[(size_t)i * 5 + 2] = img[(size_t)i * 3 + 0] / beta;
      feat_bilateral[(size_t)i * 5 + 3] = img[(size_t)i * 3 + 1] / beta;
      feat_bilateral[(size_t)i * 5 + 4] = img[(size_t)i * 3 + 2] / beta;
    }

  PairwiseKernel bilateral;
  bilateral.init(feat_bilateral.data(), 5, N, w1);
  PairwiseKernel local_spatial;
  const PairwiseKernel* spatial_ptr = shared_spatial;
  if (spatial_ptr == nullptr) {
    build_spatial_kernel(local_spatial, H, W, gamma, w2);
    spatial_ptr = &local_spatial;
  }
  const PairwiseKernel& spatial = *spatial_ptr;

  // Q init = softmax(-unary) == normalized prob.
  std::vector<float> Q((size_t)N * L), next((size_t)N * L);
  std::vector<float> tmp_in((size_t)N * L), tmp_out((size_t)N * L);
  for (int i = 0; i < N; i++) {
    float s = 0.f;
    for (int l = 0; l < L; l++) s += std::exp(-unary[(size_t)i * L + l]);
    for (int l = 0; l < L; l++)
      Q[(size_t)i * L + l] = std::exp(-unary[(size_t)i * L + l]) / s;
  }

  for (int it = 0; it < iters; it++) {
    for (size_t i = 0; i < (size_t)N * L; i++) next[i] = -unary[i];
    bilateral.apply(next.data(), Q.data(), N, L, tmp_in, tmp_out);
    spatial.apply(next.data(), Q.data(), N, L, tmp_in, tmp_out);
    // Q = softmax(next), numerically stable.
    for (int i = 0; i < N; i++) {
      float mx = next[(size_t)i * L];
      for (int l = 1; l < L; l++) mx = std::max(mx, next[(size_t)i * L + l]);
      float s = 0.f;
      for (int l = 0; l < L; l++) {
        float e = std::exp(next[(size_t)i * L + l] - mx);
        Q[(size_t)i * L + l] = e;
        s += e;
      }
      for (int l = 0; l < L; l++) Q[(size_t)i * L + l] /= s;
    }
  }

  for (int i = 0; i < N; i++) {
    int best = 0;
    float bv = Q[(size_t)i * L];
    for (int l = 1; l < L; l++)
      if (Q[(size_t)i * L + l] > bv) {
        bv = Q[(size_t)i * L + l];
        best = l;
      }
    out_seg[i] = (uint8_t)best;
  }
}

}  // namespace

extern "C" {

void densecrf_single(const uint8_t* img, const float* prob, int H, int W,
                     int L, float w1, float alpha, float beta, float w2,
                     float gamma, int iters, uint8_t* out_seg) {
  mean_field(img, prob, H, W, L, w1, alpha, beta, w2, gamma, iters, out_seg);
}

void densecrf_batch(const uint8_t* imgs, const float* probs, int N_frames,
                    int H, int W, int L, float w1, float alpha, float beta,
                    float w2, float gamma, int iters, uint8_t* out_segs,
                    int num_threads) {
  PairwiseKernel spatial;  // identical for every frame — build once
  build_spatial_kernel(spatial, H, W, gamma, w2);
#ifdef _OPENMP
  if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic)
#endif
  for (int n = 0; n < N_frames; n++) {
    mean_field(imgs + (size_t)n * H * W * 3, probs + (size_t)n * H * W * L, H,
               W, L, w1, alpha, beta, w2, gamma, iters,
               out_segs + (size_t)n * H * W, &spatial);
  }
}

}  // extern "C"
