/* Native audio frontend and threaded loader: the port's copy of the JAX
 * package's native/src/dsp.cc, the C++ feature path of
 * data.native_loader (deepspeech_tpu_torch/data/pipeline.py).
 *
 * Featurizer contract: same math and layout as the tested numpy oracle
 * deepspeech_tpu_torch/data/features.py::featurize_np: pre-emphasis,
 * strided framing, Hann window, real DFT (as an explicit [win, F] cos/sin
 * matrix product; n_fft=320 is not a power of two and the frame count
 * makes a matmul the cache-friendly formulation anyway), log-magnitude,
 * per-utterance mean/std normalization.  Held to it within 2e-3 and to
 * the JAX package's native featurizer within 1e-5 in
 * tests/test_torch_native_loader.py.
 */
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "c_api.h"
#include "internal.h"

namespace ds2n {
namespace {

/* Cached (Hann window ⊙ DFT) matrices for a (win, n_fft) config:
 * re/im are [win * F]; out_k = sum_j frame_j * win_j * e^{-2πi jk/n}. */
struct DftPlan {
  int win, n_fft, F;
  std::vector<float> re, im;  /* window folded in */
};

const DftPlan* GetPlan(int win, int n_fft) {
  static std::mutex mu;
  static std::unordered_map<uint64_t, DftPlan*> cache;
  uint64_t key = (static_cast<uint64_t>(win) << 32) |
                 static_cast<uint32_t>(n_fft);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  auto* plan = new DftPlan();
  plan->win = win;
  plan->n_fft = n_fft;
  plan->F = n_fft / 2 + 1;
  plan->re.resize(static_cast<size_t>(win) * plan->F);
  plan->im.resize(static_cast<size_t>(win) * plan->F);
  const double two_pi = 2.0 * M_PI;
  for (int j = 0; j < win; ++j) {
    /* numpy.hanning: 0.5 - 0.5*cos(2*pi*j/(win-1)). */
    double w = win > 1
                   ? 0.5 - 0.5 * std::cos(two_pi * j / (win - 1))
                   : 1.0;
    for (int k = 0; k < plan->F; ++k) {
      double ang = two_pi * j * k / n_fft;
      plan->re[static_cast<size_t>(j) * plan->F + k] =
          static_cast<float>(w * std::cos(ang));
      plan->im[static_cast<size_t>(j) * plan->F + k] =
          static_cast<float>(-w * std::sin(ang));
    }
  }
  cache.emplace(key, plan);
  return plan;
}

int FeaturizeInto(const float* audio, int n, int win, int hop, int n_fft,
                  float preemph, bool normalize, float eps, float* out) {
  const DftPlan* plan = GetPlan(win, n_fft);
  const int F = plan->F;
  if (n < win) return 0;
  const int T = 1 + (n - win) / hop;

  std::vector<float> pre;
  if (preemph > 0.0f) {
    pre.resize(n);
    pre[0] = audio[0];
    for (int i = 1; i < n; ++i) pre[i] = audio[i] - preemph * audio[i - 1];
    audio = pre.data();
  }

  /* frames[T, win] @ (re|im)[win, F] with accumulation in double to
   * track numpy's pairwise-summed rfft closely. */
  std::vector<double> acc_re(F), acc_im(F);
  for (int t = 0; t < T; ++t) {
    const float* frame = audio + static_cast<size_t>(t) * hop;
    std::fill(acc_re.begin(), acc_re.end(), 0.0);
    std::fill(acc_im.begin(), acc_im.end(), 0.0);
    for (int j = 0; j < win; ++j) {
      const float x = frame[j];
      if (x == 0.0f) continue;
      const float* re = plan->re.data() + static_cast<size_t>(j) * F;
      const float* im = plan->im.data() + static_cast<size_t>(j) * F;
      for (int k = 0; k < F; ++k) {
        acc_re[k] += static_cast<double>(x) * re[k];
        acc_im[k] += static_cast<double>(x) * im[k];
      }
    }
    float* row = out + static_cast<size_t>(t) * F;
    for (int k = 0; k < F; ++k) {
      float mag = static_cast<float>(
          std::sqrt(acc_re[k] * acc_re[k] + acc_im[k] * acc_im[k]));
      row[k] = std::log(mag + eps);
    }
  }

  if (normalize) {
    /* Per-feature mean/std over frames (axis=0), matching the oracle. */
    for (int k = 0; k < F; ++k) {
      double mean = 0.0;
      for (int t = 0; t < T; ++t) mean += out[static_cast<size_t>(t) * F + k];
      mean /= T;
      double var = 0.0;
      for (int t = 0; t < T; ++t) {
        double d = out[static_cast<size_t>(t) * F + k] - mean;
        var += d * d;
      }
      float std = static_cast<float>(std::sqrt(var / T));
      for (int t = 0; t < T; ++t) {
        float* p = out + static_cast<size_t>(t) * F + k;
        *p = static_cast<float>((*p - mean) / (std + eps));
      }
    }
  }
  return T;
}

/* Minimal RIFF/WAVE PCM parser (fmt 1 = int PCM, 3 = float32, plus
 * WAVE_FORMAT_EXTENSIBLE wrapping either).  Chunk sizes are capped by
 * the actual file size so corrupt headers cannot trigger huge
 * allocations; no exception may escape (extern "C" / thread-pool
 * callers), so the body is wrapped against bad_alloc. */
int ParseWavImpl(const char* path, float** out, int* n_samples) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_last_error(std::string("cannot open wav: ") + path);
    return -1;
  }
  std::fseek(f, 0, SEEK_END);
  const long file_size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  auto fail = [&](const std::string& msg) {
    std::fclose(f);
    set_last_error(path + std::string(": ") + msg);
    return -1;
  };
  auto rd_u32 = [&](uint32_t* v) {
    return std::fread(v, 4, 1, f) == 1;
  };
  char tag[4];
  uint32_t riff_size = 0;
  if (std::fread(tag, 1, 4, f) != 4 || std::memcmp(tag, "RIFF", 4) != 0 ||
      !rd_u32(&riff_size) || std::fread(tag, 1, 4, f) != 4 ||
      std::memcmp(tag, "WAVE", 4) != 0)
    return fail("not a RIFF/WAVE file");

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  std::vector<uint8_t> data;
  bool have_fmt = false, have_data = false;
  while (std::fread(tag, 1, 4, f) == 4) {
    uint32_t size = 0;
    if (!rd_u32(&size)) break;
    if (static_cast<long>(size) > file_size)
      return fail("chunk size exceeds file size");
    if (std::memcmp(tag, "fmt ", 4) == 0) {
      std::vector<uint8_t> buf(size);
      if (std::fread(buf.data(), 1, size, f) != size || size < 16)
        return fail("bad fmt chunk");
      std::memcpy(&fmt, buf.data(), 2);
      std::memcpy(&channels, buf.data() + 2, 2);
      std::memcpy(&rate, buf.data() + 4, 4);
      std::memcpy(&bits, buf.data() + 14, 2);
      if (fmt == 0xFFFE && size >= 26) /* extensible: real tag at 24 */
        std::memcpy(&fmt, buf.data() + 24, 2);
      have_fmt = true;
    } else if (std::memcmp(tag, "data", 4) == 0) {
      data.resize(size);
      if (std::fread(data.data(), 1, size, f) != size)
        return fail("truncated data chunk");
      have_data = true;
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
      continue;
    }
    if (size & 1) std::fseek(f, 1, SEEK_CUR);
  }
  std::fclose(f);
  if (!have_fmt || !have_data) return fail("missing fmt/data chunk");
  if (channels == 0) return fail("zero channels");

  size_t bytes_per = bits / 8;
  if (bytes_per == 0 || data.size() % (bytes_per * channels) != 0)
    data.resize(data.size() - data.size() % (bytes_per * channels));
  size_t frames = data.size() / (bytes_per * channels);
  float* buf = static_cast<float*>(malloc(sizeof(float) * (frames ? frames : 1)));
  if (!buf) return fail("oom");

  auto sample = [&](size_t i) -> float {
    const uint8_t* p = data.data() + i * bytes_per;
    if (fmt == 3 && bits == 32) {  /* IEEE float */
      float v;
      std::memcpy(&v, p, 4);
      return v;
    }
    if (bits == 8) return (static_cast<int>(*p) - 128) / 128.0f;
    if (bits == 16) {
      int16_t v;
      std::memcpy(&v, p, 2);
      return v / 32767.0f;  /* match features.py: / iinfo(int16).max */
    }
    if (bits == 32) {
      int32_t v;
      std::memcpy(&v, p, 4);
      return static_cast<float>(v / 2147483647.0);
    }
    return 0.0f;
  };
  if ((fmt != 1 && fmt != 3) || (bits != 8 && bits != 16 && bits != 32)) {
    free(buf);
    return fail("unsupported wav format (PCM 8/16/32 or float32 only)");
  }
  for (size_t t = 0; t < frames; ++t) {
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c)
      acc += sample(t * channels + c);
    buf[t] = acc / channels;
  }
  *out = buf;
  *n_samples = static_cast<int>(frames);
  return static_cast<int>(rate);
}

int ParseWav(const char* path, float** out, int* n_samples) {
  try {
    return ParseWavImpl(path, out, n_samples);
  } catch (const std::exception& e) {
    set_last_error(path + std::string(": ") + e.what());
    return -1;
  }
}

}  // namespace
}  // namespace ds2n

extern "C" {

int ds2n_num_frames(int n_samples, int win, int hop) {
  if (n_samples < win) return 0;
  return 1 + (n_samples - win) / hop;
}

int ds2n_featurize(const float* audio, int n_samples, int win, int hop,
                   int n_fft, float preemph, int normalize, float eps,
                   float* out) {
  if (n_samples < 0 || win <= 0 || hop <= 0 || n_fft < win) {
    ds2n::set_last_error("ds2n_featurize: invalid arguments");
    return -1;
  }
  return ds2n::FeaturizeInto(audio, n_samples, win, hop, n_fft, preemph,
                             normalize != 0, eps, out);
}

int ds2n_load_wav(const char* path, float** out, int* n_samples) {
  return ds2n::ParseWav(path, out, n_samples);
}

int ds2n_featurize_batch(const float* const* audios, const int32_t* lens,
                         int B, int win, int hop, int n_fft, float preemph,
                         int normalize, float eps, int max_frames,
                         float* out, int32_t* out_frames, int n_threads) {
  if (B < 0 || win <= 0 || hop <= 0 || n_fft < win || max_frames <= 0) {
    ds2n::set_last_error("ds2n_featurize_batch: invalid arguments");
    return -1;
  }
  const int F = n_fft / 2 + 1;
  ds2n::ParallelFor(B, n_threads, [&](int b) {
    float* dst = out + static_cast<size_t>(b) * max_frames * F;
    std::memset(dst, 0, sizeof(float) * static_cast<size_t>(max_frames) * F);
    int n = lens[b];
    int t_full = ds2n_num_frames(n, win, hop);
    if (t_full <= 0) { out_frames[b] = 0; return; }
    if (t_full <= max_frames) {
      out_frames[b] =
          ds2n::FeaturizeInto(audios[b], n, win, hop, n_fft, preemph,
                              normalize != 0, eps, dst);
    } else {
      /* Featurize fully (normalization uses all frames, matching the
       * oracle's clip-after-featurize), then copy the head. */
      std::vector<float> full(static_cast<size_t>(t_full) * F);
      ds2n::FeaturizeInto(audios[b], n, win, hop, n_fft, preemph,
                          normalize != 0, eps, full.data());
      std::memcpy(dst, full.data(),
                  sizeof(float) * static_cast<size_t>(max_frames) * F);
      out_frames[b] = max_frames;
    }
  });
  return 0;
}

int ds2n_load_featurize_batch(const char* const* paths, int B,
                              int sample_rate, int win, int hop, int n_fft,
                              float preemph, int normalize, float eps,
                              int max_frames, float* out,
                              int32_t* out_frames, int n_threads) {
  if (B < 0 || win <= 0 || hop <= 0 || n_fft < win || max_frames <= 0) {
    ds2n::set_last_error("ds2n_load_featurize_batch: invalid arguments");
    return -1;
  }
  const int F = n_fft / 2 + 1;
  ds2n::ParallelFor(B, n_threads, [&](int b) {
    float* dst = out + static_cast<size_t>(b) * max_frames * F;
    std::memset(dst, 0, sizeof(float) * static_cast<size_t>(max_frames) * F);
    out_frames[b] = -1;
    float* audio = nullptr;
    int n = 0;
    int rate = ds2n::ParseWav(paths[b], &audio, &n);
    if (rate < 0) return;
    if (rate != sample_rate) { free(audio); return; }
    int t_full = ds2n_num_frames(n, win, hop);
    if (t_full <= 0) {
      out_frames[b] = 0;
    } else if (t_full <= max_frames) {
      out_frames[b] = ds2n::FeaturizeInto(audio, n, win, hop, n_fft, preemph,
                                          normalize != 0, eps, dst);
    } else {
      std::vector<float> full(static_cast<size_t>(t_full) * F);
      ds2n::FeaturizeInto(audio, n, win, hop, n_fft, preemph, normalize != 0,
                          eps, full.data());
      std::memcpy(dst, full.data(),
                  sizeof(float) * static_cast<size_t>(max_frames) * F);
      out_frames[b] = max_frames;
    }
    free(audio);
  });
  return 0;
}

}  /* extern "C" */
