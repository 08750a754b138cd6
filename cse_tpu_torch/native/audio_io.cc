// Native host audio runtime for cse_tpu_torch (a copy of cse_tpu/native/audio_io.cc).
//
// Replaces the reference's librosa/soundfile decode path (which burns CPU in
// every DataLoader worker, reference dataset_train_CSE.py:167-415) with a
// thread-pooled C++ WAV decoder feeding the device pipeline:
//   * cse_read_wav:    single-file decode -> float32 mono
//   * cse_batch_load:  N files decoded in parallel straight into the caller's
//                      pinned [N, T] batch buffer, peak-normalized, truncated
//   * cse_write_wav:   PCM_16 writer (the reference's dump format)
//
// Exposed via a plain C ABI for ctypes. Built on first use by
// cse_tpu_torch/native/audio_native.py (g++ -O3 -shared -fPIC) into
// cse_tpu_torch/_build/.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
};

bool read_wav_file(const char* path, WavData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) ||
      std::memcmp(hdr + 8, "WAVE", 4)) {
    std::fclose(f);
    return false;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  std::vector<uint8_t> data;
  while (true) {
    char cid[4];
    uint32_t size;
    if (std::fread(cid, 1, 4, f) != 4 || std::fread(&size, 4, 1, f) != 1) break;
    if (!std::memcmp(cid, "fmt ", 4)) {
      if (size < 16) break;  // malformed: fields below need 16 bytes
      std::vector<uint8_t> chunk(size);
      if (std::fread(chunk.data(), 1, size, f) != size) break;
      std::memcpy(&fmt, chunk.data(), 2);
      std::memcpy(&channels, chunk.data() + 2, 2);
      std::memcpy(&sr, chunk.data() + 4, 4);
      std::memcpy(&bits, chunk.data() + 14, 2);
      if (fmt == 0xFFFE && size >= 26) std::memcpy(&fmt, chunk.data() + 24, 2);
    } else if (!std::memcmp(cid, "data", 4)) {
      data.resize(size);
      size_t got = std::fread(data.data(), 1, size, f);
      data.resize(got);
      if (sr) break;  // fmt already seen: done
      // data chunk BEFORE fmt (legal): keep scanning for the trailing fmt
      if (got < size) break;
      if (size & 1) std::fseek(f, 1, SEEK_CUR);  // RIFF pad byte
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
    if (sr && !data.empty()) break;
  }
  std::fclose(f);
  if (!sr || !channels || data.empty()) return false;

  size_t frames;
  std::vector<float> mono;
  if (fmt == 1 && bits == 16) {
    frames = data.size() / (2 * channels);
    mono.resize(frames);
    const int16_t* p = reinterpret_cast<const int16_t*>(data.data());
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int c = 0; c < channels; ++c) acc += p[i * channels + c];
      mono[i] = acc / (32768.0f * channels);
    }
  } else if (fmt == 3 && bits == 32) {
    frames = data.size() / (4 * channels);
    mono.resize(frames);
    const float* p = reinterpret_cast<const float*>(data.data());
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int c = 0; c < channels; ++c) acc += p[i * channels + c];
      mono[i] = acc / channels;
    }
  } else if (fmt == 1 && bits == 32) {
    frames = data.size() / (4 * channels);
    mono.resize(frames);
    const int32_t* p = reinterpret_cast<const int32_t*>(data.data());
    for (size_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      for (int c = 0; c < channels; ++c) acc += p[i * channels + c];
      mono[i] = static_cast<float>(acc / (2147483648.0 * channels));
    }
  } else if (fmt == 1 && bits == 24) {
    frames = data.size() / (3 * channels);
    mono.resize(frames);
    for (size_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      for (int c = 0; c < channels; ++c) {
        const uint8_t* b = data.data() + 3 * (i * channels + c);
        int32_t v = (b[0] | (b[1] << 8) | (b[2] << 16));
        if (v & 0x800000) v -= 0x1000000;
        acc += v;
      }
      mono[i] = static_cast<float>(acc / (8388608.0 * channels));
    }
  } else {
    return false;
  }
  out->samples = std::move(mono);
  out->sample_rate = static_cast<int>(sr);
  return true;
}

}  // namespace

extern "C" {

// Decode one file. Returns sample count written (<= max_len), 0 on failure.
// *sr_out receives the sample rate.
int64_t cse_read_wav(const char* path, float* out, int64_t max_len,
                     int32_t* sr_out) {
  WavData w;
  if (!read_wav_file(path, &w)) return 0;
  int64_t n = static_cast<int64_t>(w.samples.size());
  if (n > max_len) n = max_len;
  std::memcpy(out, w.samples.data(), n * sizeof(float));
  *sr_out = w.sample_rate;
  return n;
}

// Header-only probe: mono frame count + rate WITHOUT decoding samples
// (sizing pass for cse_read_wav — a full decode here would double the IO).
int64_t cse_wav_info(const char* path, int32_t* sr_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) ||
      std::memcmp(hdr + 8, "WAVE", 4)) {
    std::fclose(f);
    return -1;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  uint64_t data_size = 0;
  bool have_fmt = false, have_data = false;
  while (!(have_fmt && have_data)) {
    char cid[4];
    uint32_t size;
    if (std::fread(cid, 1, 4, f) != 4 || std::fread(&size, 4, 1, f) != 1) break;
    if (!std::memcmp(cid, "fmt ", 4)) {
      if (size < 16) break;  // malformed: fields below need 16 bytes
      std::vector<uint8_t> chunk(size);
      if (std::fread(chunk.data(), 1, size, f) != size) break;
      std::memcpy(&fmt, chunk.data(), 2);
      std::memcpy(&channels, chunk.data() + 2, 2);
      std::memcpy(&sr, chunk.data() + 4, 4);
      std::memcpy(&bits, chunk.data() + 14, 2);
      if (fmt == 0xFFFE && size >= 26) std::memcpy(&fmt, chunk.data() + 24, 2);
      have_fmt = true;
    } else if (!std::memcmp(cid, "data", 4)) {
      // clamp the declared size to the bytes actually present (truncated
      // files, streaming 0xFFFFFFFF placeholders)
      long pos = std::ftell(f);
      std::fseek(f, 0, SEEK_END);
      long end = std::ftell(f);
      uint64_t avail = (end > pos) ? static_cast<uint64_t>(end - pos) : 0;
      data_size = (size < avail) ? size : avail;
      have_data = true;
      // restore the position past this chunk so a (legal) layout with the
      // data chunk BEFORE fmt can still find the trailing fmt chunk
      std::fseek(f, pos + static_cast<long>(size + (size & 1)), SEEK_SET);
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  bool supported = (fmt == 1 && (bits == 16 || bits == 24 || bits == 32)) ||
                   (fmt == 3 && bits == 32);
  if (!have_fmt || !have_data || !sr || !channels || !supported) return -1;
  *sr_out = static_cast<int32_t>(sr);
  return static_cast<int64_t>(data_size / (channels * (bits / 8)));
}

// Parallel scatter decode: file i lands at rows[i] (buf_len floats each).
// Rows are zero-padded past the decoded length only when zero_tail is set —
// pass 0 ONLY for freshly calloc'd destinations (zero-mapped pages); failed
// rows are ALWAYS fully zeroed. peak_target > 0 applies per-file peak
// normalization (the reference's load-time `x / max|x| * 0.9`). Returns
// #successes. The pointer form lets a caller decode one batch's worth of
// files into SEVERAL destination arrays (mix/gt/noise...) with a single
// thread pool spanning all of them.
int32_t cse_batch_load_ptrs(const char** paths, int32_t n_files, float** rows,
                            int64_t buf_len, int32_t* lens, int32_t* srs,
                            float peak_target, int32_t n_threads,
                            int32_t zero_tail) {
  std::atomic<int32_t> next(0), ok(0);
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n_files) n_threads = n_files;
  auto worker = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n_files) break;
      float* row = rows[i];
      WavData w;
      if (!read_wav_file(paths[i], &w)) {
        // failed rows are always fully zeroed so callers never read stale
        // data for them, even with zero_tail off
        std::memset(row, 0, buf_len * sizeof(float));
        lens[i] = 0;
        srs[i] = 0;
        continue;
      }
      int64_t n = static_cast<int64_t>(w.samples.size());
      if (peak_target > 0.f) {
        float peak = 1e-12f;
        for (float v : w.samples) peak = std::max(peak, std::abs(v));
        float scale = peak_target / peak;
        for (auto& v : w.samples) v *= scale;
      }
      if (n > buf_len) n = buf_len;
      std::memcpy(row, w.samples.data(), n * sizeof(float));
      // tail zeroing only where needed: with a freshly calloc'd destination
      // (both loaders) the pages past n are zero-mapped already, and
      // touching them would dirty ~T16-n floats per short row for nothing
      if (zero_tail && n < buf_len)
        std::memset(row + n, 0, (buf_len - n) * sizeof(float));
      lens[i] = static_cast<int32_t>(n);
      srs[i] = w.sample_rate;
      ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// Contiguous-matrix form of the above: decode into out[n_files, buf_len].
int32_t cse_batch_load(const char** paths, int32_t n_files, float* out,
                       int64_t buf_len, int32_t* lens, int32_t* srs,
                       float peak_target, int32_t n_threads,
                       int32_t zero_tail) {
  std::vector<float*> rows(n_files);
  for (int32_t i = 0; i < n_files; ++i)
    rows[i] = out + static_cast<int64_t>(i) * buf_len;
  return cse_batch_load_ptrs(paths, n_files, rows.data(), buf_len, lens, srs,
                             peak_target, n_threads, zero_tail);
}

// PCM_16 mono writer. Returns 1 on success.
int32_t cse_write_wav(const char* path, const float* x, int64_t n,
                      int32_t sr) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 0;
  uint32_t data_size = static_cast<uint32_t>(n * 2);
  uint32_t riff_size = 36 + data_size;
  uint16_t fmt = 1, channels = 1, bits = 16;
  uint32_t byte_rate = sr * 2;
  uint16_t block_align = 2;
  std::fwrite("RIFF", 1, 4, f);
  std::fwrite(&riff_size, 4, 1, f);
  std::fwrite("WAVEfmt ", 1, 8, f);
  uint32_t fmt_size = 16;
  std::fwrite(&fmt_size, 4, 1, f);
  std::fwrite(&fmt, 2, 1, f);
  std::fwrite(&channels, 2, 1, f);
  std::fwrite(&sr, 4, 1, f);
  std::fwrite(&byte_rate, 4, 1, f);
  std::fwrite(&block_align, 2, 1, f);
  std::fwrite(&bits, 2, 1, f);
  std::fwrite("data", 1, 4, f);
  std::fwrite(&data_size, 4, 1, f);
  std::vector<int16_t> pcm(n);
  for (int64_t i = 0; i < n; ++i) {
    float v = x[i] * 32768.0f;
    if (v > 32767.f) v = 32767.f;
    if (v < -32768.f) v = -32768.f;
    pcm[i] = static_cast<int16_t>(v);
  }
  std::fwrite(pcm.data(), 2, n, f);
  std::fclose(f);
  return 1;
}

}  // extern "C"
