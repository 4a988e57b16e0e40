// Native data pipeline: threaded image prefetch + decode + photometric
// correction, feeding the host->device input queue.
//
// The port's own copy of libcml_tpu/native/cml_io.cpp (built by
// libcml_tpu_torch/native/io.py into libcml_tpu_torch/_build/). It is the
// replacement for the reference's C++ capture runtime
// (reference: src/cml/capture/AbstractCapture.h:83-140 — threaded prefetch
// base with a bounded queue; CaptureImage.cpp — per-frame decode +
// photometric preparation; image/LookupTable.h:8 gamma LUT;
// TUMCapture.cpp:19-131 vignette/pcalib handling).
//
// Design: a worker pool decodes frames ahead of the consumer into a
// fixed-capacity ordered ring (slot = index % capacity); the consumer blocks
// only when the pipeline is genuinely behind. Decoding supports 8/16-bit
// grayscale and 8-bit RGB PNG (via zlib inflate + full filter reconstruction)
// and PGM/PPM; gamma-LUT and vignette correction are applied in the worker so
// the Python side receives ready-to-upload float32 planes.
//
// Build: g++ -O3 -shared -fPIC cml_io.cpp -o libcml_io.so -lz -lpthread

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// PNG decode (8/16-bit gray, 8-bit RGB/RGBA -> float32 grayscale)
// ---------------------------------------------------------------------------

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Returns 0 on success. out must hold H*W floats (caller checks maxpix).
int decode_png_gray(const uint8_t* data, size_t n, float* out, int* H_out,
                    int* W_out, size_t maxpix) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (n < 8 || memcmp(data, kSig, 8) != 0) return -1;
  size_t off = 8;
  uint32_t W = 0, H = 0;
  int bit_depth = 0, color_type = -1;
  std::vector<uint8_t> idat;
  while (off + 8 <= n) {
    uint32_t len = be32(data + off);
    const uint8_t* type = data + off + 4;
    const uint8_t* body = data + off + 8;
    if (off + 12 + len > n) return -2;
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return -3;
      W = be32(body);
      H = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      if (body[12] != 0) return -4;  // interlaced unsupported
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  if (W == 0 || H == 0 || idat.empty()) return -5;
  if (size_t(W) * H > maxpix) return -6;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;   // gray
    case 2: channels = 3; break;   // rgb
    case 4: channels = 2; break;   // gray+alpha
    case 6: channels = 4; break;   // rgba
    default: return -7;            // palette unsupported
  }
  if (bit_depth != 8 && !(bit_depth == 16 && color_type == 0)) return -8;
  const int bypp = channels * bit_depth / 8;
  const size_t stride = size_t(W) * bypp;
  std::vector<uint8_t> raw(H * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return -9;

  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (uint32_t y = 0; y < H; ++y) {
    const uint8_t* row = raw.data() + size_t(y) * (stride + 1);
    int filter = row[0];
    const uint8_t* src = row + 1;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bypp) ? cur[x - bypp] : 0;
      int b = prev[x];
      int c = x >= size_t(bypp) ? prev[x - bypp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -10;
      }
      cur[x] = uint8_t(v);
    }
    float* dst = out + size_t(y) * W;
    if (color_type == 0 && bit_depth == 8) {
      for (uint32_t x = 0; x < W; ++x) dst[x] = float(cur[x]);
    } else if (color_type == 0 && bit_depth == 16) {
      for (uint32_t x = 0; x < W; ++x)
        dst[x] = float((cur[2 * x] << 8) | cur[2 * x + 1]) * (255.0f / 65535.0f);
    } else if (color_type == 4) {
      for (uint32_t x = 0; x < W; ++x) dst[x] = float(cur[2 * x]);
    } else {  // rgb / rgba -> BT.601 luma (the reference converts color
              // captures to gray the same way, CaptureImage.cpp)
      for (uint32_t x = 0; x < W; ++x) {
        const uint8_t* px = &cur[size_t(x) * bypp];
        dst[x] = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
      }
    }
    prev.swap(cur);
  }
  *H_out = int(H);
  *W_out = int(W);
  return 0;
}

// PGM (P5) / PPM (P6), 8-bit.
int decode_pnm_gray(const uint8_t* data, size_t n, float* out, int* H_out,
                    int* W_out, size_t maxpix) {
  if (n < 2 || data[0] != 'P' || (data[1] != '5' && data[1] != '6')) return -1;
  int channels = data[1] == '5' ? 1 : 3;
  size_t off = 2;
  int vals[3], got = 0;
  while (got < 3 && off < n) {
    while (off < n && (isspace(data[off]))) ++off;
    if (off < n && data[off] == '#') {
      while (off < n && data[off] != '\n') ++off;
      continue;
    }
    int v = 0;
    bool any = false;
    while (off < n && isdigit(data[off])) {
      v = v * 10 + (data[off++] - '0');
      any = true;
    }
    if (any) vals[got++] = v;
  }
  if (got < 3 || off >= n) return -2;
  ++off;  // single whitespace after maxval
  int W = vals[0], H = vals[1];
  if (size_t(W) * H > maxpix || vals[2] > 255) return -3;
  if (off + size_t(W) * H * channels > n) return -4;
  const uint8_t* src = data + off;
  for (int i = 0; i < W * H; ++i) {
    if (channels == 1)
      out[i] = float(src[i]);
    else
      out[i] = 0.299f * src[3 * i] + 0.587f * src[3 * i + 1] +
               0.114f * src[3 * i + 2];
  }
  *H_out = H;
  *W_out = W;
  return 0;
}

int decode_gray(const uint8_t* data, size_t n, float* out, int* H, int* W,
                size_t maxpix) {
  if (n >= 8 && data[0] == 137) return decode_png_gray(data, n, out, H, W, maxpix);
  return decode_pnm_gray(data, n, out, H, W, maxpix);
}

// ---------------------------------------------------------------------------
// Prefetch pipeline
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> pix;
  int H = 0, W = 0;
  int status = 0;  // 0 empty, 1 ready, <0 error code
  long index = -1;
};

struct Pipeline {
  std::vector<std::string> paths;
  std::vector<Slot> ring;
  std::vector<std::thread> workers;
  std::vector<float> gamma;     // 256-entry inverse response, empty = off
  std::vector<float> vignette;  // H*W attenuation, empty = off
  int vh = 0, vw = 0;
  size_t cap = 0, maxpix = 0;
  std::atomic<long> next_to_fetch{0};
  long next_to_emit = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  bool stopped = false;

  void worker() {
    std::vector<uint8_t> buf;
    while (true) {
      long idx = next_to_fetch.fetch_add(1);
      if (idx >= long(paths.size())) return;
      // read file
      int status = 0;
      int H = 0, W = 0;
      std::vector<float> pix(maxpix);
      FILE* f = fopen(paths[idx].c_str(), "rb");
      if (!f) {
        status = -100;
      } else {
        fseek(f, 0, SEEK_END);
        long sz = ftell(f);
        fseek(f, 0, SEEK_SET);
        buf.resize(sz);
        if (fread(buf.data(), 1, sz, f) != size_t(sz)) status = -101;
        fclose(f);
        if (!status)
          status = decode_gray(buf.data(), sz, pix.data(), &H, &W, maxpix);
      }
      if (!status) {
        // photometric correction in the worker: gamma LUT then vignette
        // divide (reference: TUM pcalib + vignette, TUMCapture.cpp:19-131)
        const size_t npix = size_t(H) * W;
        if (!gamma.empty()) {
          for (size_t i = 0; i < npix; ++i) {
            float v = pix[i];
            int lo = int(v);
            lo = lo < 0 ? 0 : (lo > 254 ? 254 : lo);
            float frac = v - lo;
            pix[i] = gamma[lo] * (1.0f - frac) + gamma[lo + 1] * frac;
          }
        }
        if (!vignette.empty() && vh == H && vw == W) {
          for (size_t i = 0; i < npix; ++i) {
            float a = vignette[i];
            pix[i] = a > 1e-4f ? pix[i] / a : pix[i];
          }
        }
      }
      // publish into the ordered ring
      std::unique_lock<std::mutex> lk(mu);
      size_t slot = size_t(idx) % cap;
      cv_free.wait(lk, [&] {
        return stopped || ring[slot].status == 0 || ring[slot].index >= idx;
      });
      if (stopped) return;
      Slot& s = ring[slot];
      s.pix.swap(pix);
      s.H = H;
      s.W = W;
      s.index = idx;
      s.status = status ? status : 1;
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* cmlio_open(const char** paths, int n, int n_workers, int queue_cap,
                 const float* gamma, const float* vignette, int vh, int vw,
                 long maxpix) {
  auto* p = new Pipeline();
  p->paths.assign(paths, paths + n);
  p->cap = queue_cap > 0 ? queue_cap : 4;
  p->maxpix = maxpix > 0 ? size_t(maxpix) : (4096u * 3072u);
  p->ring.resize(p->cap);
  for (auto& s : p->ring) s.pix.reserve(p->maxpix);
  if (gamma) p->gamma.assign(gamma, gamma + 256);
  if (vignette && vh > 0 && vw > 0) {
    p->vignette.assign(vignette, vignette + size_t(vh) * vw);
    p->vh = vh;
    p->vw = vw;
  }
  int nw = n_workers > 0 ? n_workers : 2;
  for (int i = 0; i < nw; ++i)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// Copies the next in-order frame into out (caller allocates maxpix floats).
// Returns the frame index, or -1 at end-of-stream, or -1000-err on decode
// failure (the stream continues afterwards).
long cmlio_next(void* handle, float* out, int* H_out, int* W_out) {
  auto* p = static_cast<Pipeline*>(handle);
  if (p->next_to_emit >= long(p->paths.size())) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  long want = p->next_to_emit;
  size_t slot = size_t(want) % p->cap;
  p->cv_ready.wait(lk, [&] {
    return p->ring[slot].index == want && p->ring[slot].status != 0;
  });
  Slot& s = p->ring[slot];
  long rc = want;
  if (s.status == 1) {
    *H_out = s.H;
    *W_out = s.W;
    memcpy(out, s.pix.data(), sizeof(float) * size_t(s.H) * s.W);
  } else {
    rc = -1000 + s.status;
  }
  s.status = 0;
  s.index = -1;
  p->next_to_emit++;
  p->cv_free.notify_all();
  return rc;
}

void cmlio_close(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopped = true;
  }
  p->cv_free.notify_all();
  p->next_to_fetch.store(long(p->paths.size()));
  for (auto& t : p->workers) t.join();
  delete p;
}

// One-shot decode for callers that manage their own threading.
int cmlio_decode(const uint8_t* data, long n, float* out, int* H, int* W,
                 long maxpix) {
  return decode_gray(data, size_t(n), out, H, W, size_t(maxpix));
}

}  // extern "C"
