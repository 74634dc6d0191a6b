// libmxtpu_io — the port's copy of the native IO library (mxtpu's
// src/libmxtpu.cc): the C++ half of mx.io's image pipeline.
//
// A plain C ABI loaded with ctypes by mxtpu_torch/native.py, which
// builds it with g++ at first use. Components:
//   * RecordIO: offset indexer + pread-based random reader with
//     multi-part (cflag) reassembly, byte-compatible with
//     mxtpu_torch/recordio.py and dmlc .rec files.
//   * JPEG decode and encode, and a bilinear resize to float32.
//   * A threaded sample pipeline: worker threads read+decode+resize
//     records into a bounded queue; the host thread drains batches in
//     order (the counterpart of ImageRecordIOParser2 + PrefetcherIter).
//
// The JPEG codec is chosen when the library is built, by a macro:
//   default            libjpeg (jpeglib.h, -ljpeg), as mxtpu's library;
//   MXTPU_IO_NVJPEG    nvJPEG from the CUDA toolkit (nvjpeg.h,
//                      -lnvjpeg_static -lculibos -lcudart_static), for
//                      a host with the toolkit and no libjpeg headers.
// Everything else is the same code in both builds.

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#ifdef MXTPU_IO_NVJPEG
#include <cuda_runtime_api.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#endif

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct RecFile {
  int fd = -1;
  std::vector<uint64_t> offsets;   // record starts (first chunk)
  std::vector<uint8_t> scratch;    // last read payload
};

// read one chunk at *pos (advancing it); returns false at EOF/corruption
bool ReadChunk(int fd, uint64_t* pos, std::vector<uint8_t>* out,
               uint32_t* cflag) {
  uint32_t header[2];
  if (pread(fd, header, 8, (off_t)*pos) != 8) return false;
  if (header[0] != kMagic) return false;
  *cflag = header[1] >> 29;
  uint32_t len = header[1] & ((1u << 29) - 1);
  size_t old = out->size();
  out->resize(old + len);
  if (len && pread(fd, out->data() + old, len, (off_t)(*pos + 8)) !=
                 (ssize_t)len)
    return false;
  *pos += 8 + ((len + 3u) & ~3u);
  return true;
}

// read a full logical record (reassembling multi-part) at *pos
bool ReadRecord(int fd, uint64_t* pos, std::vector<uint8_t>* out) {
  out->clear();
  uint32_t cflag = 0;
  std::vector<uint8_t> chunk;
  if (!ReadChunk(fd, pos, &chunk, &cflag)) return false;
  if (cflag == 0) {
    out->swap(chunk);
    return true;
  }
  if (cflag != 1) return false;
  const uint8_t magic_bytes[4] = {0x0a, 0x23, 0xd7, 0xce};
  *out = chunk;
  while (true) {
    chunk.clear();
    uint32_t cf = 0;
    if (!ReadChunk(fd, pos, &chunk, &cf)) return false;
    out->insert(out->end(), magic_bytes, magic_bytes + 4);
    out->insert(out->end(), chunk.begin(), chunk.end());
    if (cf == 3) return true;
    if (cf != 2) return false;
  }
}

// a codec's failures: a JPEG it cannot decode, or a codec that cannot
// run in this process (nvJPEG with no CUDA device), which it explains in
// mxtpu_codec_error()
constexpr int kBadJpeg = 1;
constexpr int kCodecUnavailable = 2;

std::mutex g_codec_err_mu;
std::string g_codec_err;

void SetCodecError(const std::string& msg) {
  std::lock_guard<std::mutex> lk(g_codec_err_mu);
  g_codec_err = msg;
}

#ifdef MXTPU_IO_NVJPEG
// ---------------------------------------------------------------------------
// nvJPEG codec: one library handle; a decode state, an encoder, a stream
// and a device buffer for each thread (the pipeline's workers decode in
// parallel, each on its own stream). nvJPEG runs on the card: where this
// process sees none (CUDA_VISIBLE_DEVICES empty, a process that hides the
// card) the codec fails with kCodecUnavailable and says why in
// mxtpu_codec_error(), apart from a JPEG it cannot decode.
// ---------------------------------------------------------------------------
nvjpegHandle_t NvHandle() {
  static nvjpegHandle_t handle = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    if (nvjpegCreateSimple(&handle) != NVJPEG_STATUS_SUCCESS)
      handle = nullptr;
  });
  return handle;
}

struct NvThread {
  cudaStream_t stream = nullptr;
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  uint8_t* dbuf = nullptr;
  size_t cap = 0;
  bool ok = false;

  NvThread() {
    int devices = 0;
    cudaError_t e = cudaGetDeviceCount(&devices);
    if (e != cudaSuccess || devices == 0) {
      SetCodecError(std::string("nvJPEG needs a CUDA device and this "
                                "process sees none (cudaGetDeviceCount: ") +
                    (e != cudaSuccess ? cudaGetErrorString(e) : "0") + ")");
      return;
    }
    nvjpegHandle_t h = NvHandle();
    if (!h) {
      SetCodecError("nvjpegCreateSimple failed");
      return;
    }
    e = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
    if (e != cudaSuccess) {
      SetCodecError(std::string("cudaStreamCreateWithFlags: ") +
                    cudaGetErrorString(e));
      return;
    }
    ok = nvjpegJpegStateCreate(h, &dec) == NVJPEG_STATUS_SUCCESS &&
         nvjpegEncoderStateCreate(h, &enc, stream) ==
             NVJPEG_STATUS_SUCCESS &&
         nvjpegEncoderParamsCreate(h, &params, stream) ==
             NVJPEG_STATUS_SUCCESS;
    if (!ok) SetCodecError("nvJPEG could not create its per-thread state");
  }
  ~NvThread() {
    if (params) nvjpegEncoderParamsDestroy(params);
    if (enc) nvjpegEncoderStateDestroy(enc);
    if (dec) nvjpegJpegStateDestroy(dec);
    if (dbuf) cudaFree(dbuf);
    if (stream) cudaStreamDestroy(stream);
  }
  bool Reserve(size_t n) {
    if (n <= cap) return true;
    if (dbuf) cudaFree(dbuf);
    dbuf = nullptr;
    cap = 0;
    cudaError_t e = cudaMalloc(reinterpret_cast<void**>(&dbuf), n);
    if (e != cudaSuccess) {
      dbuf = nullptr;
      SetCodecError(std::string("cudaMalloc: ") + cudaGetErrorString(e));
      return false;
    }
    cap = n;
    return true;
  }
};

NvThread& Nv() {
  thread_local NvThread t;
  return t;
}

// decode JPEG to tightly-packed uint8 (RGB, or luma for want_c == 1);
// returns 0 on success, kBadJpeg or kCodecUnavailable
int DecodeJpeg(const uint8_t* buf, size_t len, int want_c,
               std::vector<uint8_t>* out, int* w, int* h, int* c) {
  NvThread& t = Nv();
  if (!t.ok) return kCodecUnavailable;
  int ncomp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(NvHandle(), buf, len, &ncomp, &sub, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return kBadJpeg;
  *w = widths[0];
  *h = heights[0];
  *c = want_c == 1 ? 1 : 3;
  size_t row = (size_t)(*w) * (*c);
  size_t n = row * (*h);
  if (!t.Reserve(n)) return kCodecUnavailable;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = t.dbuf;
  img.pitch[0] = row;
  nvjpegOutputFormat_t fmt =
      want_c == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI;
  if (nvjpegDecode(NvHandle(), t.dec, buf, len, fmt, &img, t.stream) !=
      NVJPEG_STATUS_SUCCESS)
    return kBadJpeg;
  out->resize(n);
  cudaError_t e = cudaMemcpyAsync(out->data(), t.dbuf, n,
                                  cudaMemcpyDeviceToHost, t.stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(t.stream);
  if (e != cudaSuccess) {
    SetCodecError(std::string("nvJPEG's copy back: ") + cudaGetErrorString(e));
    return kCodecUnavailable;
  }
  return 0;
}

// encode tightly-packed HWC uint8 (c = 1 or 3) at `quality`, 4:2:0
// chroma for colour; *out is malloc'd (free with mxtpu_free)
long EncodeJpeg(const uint8_t* px, int h, int w, int c, int quality,
                uint8_t** out) {
  NvThread& t = Nv();
  if (c != 1 && c != 3) return -1;
  if (!t.ok) return -kCodecUnavailable;
  size_t n = (size_t)h * w * c;
  if (!t.Reserve(n)) return -kCodecUnavailable;
  nvjpegHandle_t hd = NvHandle();
  if (cudaMemcpyAsync(t.dbuf, px, n, cudaMemcpyHostToDevice, t.stream) !=
          cudaSuccess ||
      nvjpegEncoderParamsSetQuality(t.params, quality, t.stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetOptimizedHuffman(t.params, 0, t.stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetSamplingFactors(
          t.params, c == 1 ? NVJPEG_CSS_GRAY : NVJPEG_CSS_420, t.stream) !=
          NVJPEG_STATUS_SUCCESS)
    return -1;
  nvjpegImage_t src;
  memset(&src, 0, sizeof(src));
  src.channel[0] = t.dbuf;
  src.pitch[0] = (size_t)w * c;
  nvjpegStatus_t st =
      c == 3 ? nvjpegEncodeImage(hd, t.enc, t.params, &src,
                                 NVJPEG_INPUT_RGBI, w, h, t.stream)
             : nvjpegEncodeYUV(hd, t.enc, t.params, &src, NVJPEG_CSS_GRAY,
                               w, h, t.stream);
  if (st != NVJPEG_STATUS_SUCCESS) return -1;
  size_t len = 0;
  if (nvjpegEncodeRetrieveBitstream(hd, t.enc, nullptr, &len, t.stream) !=
      NVJPEG_STATUS_SUCCESS)
    return -1;
  uint8_t* buf = static_cast<uint8_t*>(malloc(len));
  if (!buf) return -1;
  if (nvjpegEncodeRetrieveBitstream(hd, t.enc, buf, &len, t.stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(t.stream) != cudaSuccess) {
    free(buf);
    return -1;
  }
  *out = buf;
  return (long)len;
}

constexpr const char* kBackend = "nvjpeg";
#else
// ---------------------------------------------------------------------------
// libjpeg codec
// ---------------------------------------------------------------------------
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void JpegErrExit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// decode JPEG to tightly-packed uint8; returns 0 on success or kBadJpeg
int DecodeJpeg(const uint8_t* buf, size_t len, int want_c,
               std::vector<uint8_t>* out, int* w, int* h, int* c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrExit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return kBadJpeg;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = want_c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  *c = cinfo.output_components;
  out->resize((size_t)(*w) * (*h) * (*c));
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
                   (size_t)cinfo.output_scanline * (*w) * (*c);
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// encode tightly-packed HWC uint8 (c = 1 or 3) at `quality` with
// libjpeg's defaults (4:2:0 chroma for colour); *out is malloc'd
// (free with mxtpu_free)
long EncodeJpeg(const uint8_t* px, int h, int w, int c, int quality,
                uint8_t** out) {
  if (c != 1 && c != 3) return -1;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  unsigned char* buf = nullptr;
  unsigned long len = 0;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrExit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_compress(&cinfo);
    free(buf);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        px + (size_t)cinfo.next_scanline * w * c);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = buf;
  return (long)len;
}

constexpr const char* kBackend = "libjpeg";
#endif

void ResizeBilinear(const uint8_t* src, int sh, int sw, int c, float* dst,
                    int dh, int dw) {
  const float ry = dh > 1 ? (float)(sh - 1) / (dh - 1) : 0.f;
  const float rx = dw > 1 ? (float)(sw - 1) / (dw - 1) : 0.f;
  for (int y = 0; y < dh; ++y) {
    float fy = y * ry;
    int y0 = (int)fy;
    int y1 = y0 + 1 < sh ? y0 + 1 : y0;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = x * rx;
      int x0 = (int)fx;
      int x1 = x0 + 1 < sw ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int k = 0; k < c; ++k) {
        float v00 = src[((size_t)y0 * sw + x0) * c + k];
        float v01 = src[((size_t)y0 * sw + x1) * c + k];
        float v10 = src[((size_t)y1 * sw + x0) * c + k];
        float v11 = src[((size_t)y1 * sw + x1) * c + k];
        dst[((size_t)y * dw + x) * c + k] =
            v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
            v10 * wy * (1 - wx) + v11 * wy * wx;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// threaded decode pipeline
// ---------------------------------------------------------------------------
struct Sample {
  std::vector<float> data;   // h*w*c (f32 mode)
  std::vector<uint8_t> u8;   // h*w*c (u8 mode: round(resize) — the
                             // device does convert/normalize/layout)
  float label = 0.f;
  bool valid = false;        // skip markers keep the sequence contiguous
  bool codec_unavailable = false;   // the codec cannot run here
};

struct Pipeline {
  RecFile rec;
  int h, w, c;
  bool out_u8 = false;   // emit rounded uint8 samples (quarter the
                         // host→device bytes; decode+resize is the
                         // host's job, normalize/layout the device's)
  bool shuffle;
  uint32_t seed, epoch = 0;
  std::vector<uint32_t> order;
  std::atomic<size_t> next_idx{0};
  // ordered bounded buffer: samples are emitted in `order` sequence so
  // shuffle=False keeps file order regardless of worker scheduling
  std::map<uint32_t, Sample> ready;
  size_t next_emit = 0;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t max_queue = 64;
  int nthreads = 1;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  int active_workers = 0;    // guarded by mu

  void Emit(uint32_t seq, Sample&& s) {
    std::unique_lock<std::mutex> lk(mu);
    // always admit the sequence the consumer is waiting for, so a full
    // buffer of later samples cannot deadlock against it
    cv_push.wait(lk, [&] {
      return ready.size() < max_queue || seq == next_emit || stop.load();
    });
    if (stop.load()) return;
    ready.emplace(seq, std::move(s));
    cv_pop.notify_all();
  }

  void WorkerLoop() {
    std::vector<uint8_t> record, pixels;
    while (!stop.load()) {
      size_t i = next_idx.fetch_add(1);
      if (i >= order.size()) break;
      Sample s;                 // default: invalid (skip marker)
      uint64_t pos = rec.offsets[order[i]];
      if (ReadRecord(rec.fd, &pos, &record) && record.size() >= 24) {
        // IRHeader: uint32 flag, float label, uint64 id[2]
        uint32_t flag;
        float label;
        memcpy(&flag, record.data(), 4);
        memcpy(&label, record.data() + 4, 4);
        size_t off = 24 + (size_t)flag * 4;   // ext labels skipped
        if (off < record.size()) {
          if (flag > 0) memcpy(&label, record.data() + 24, 4);
          int dw, dh, dc;
          int rc = DecodeJpeg(record.data() + off, record.size() - off, c,
                              &pixels, &dw, &dh, &dc);
          s.codec_unavailable = rc == kCodecUnavailable;
          if (!rc) {
            s.label = label;
            s.valid = true;
            s.data.resize((size_t)h * w * c);
            // python-path parity (CenterCropAug): crop the centered
            // min(src,target) region, then bilinear-resize
            int ch = dh < h ? dh : h;
            int cw = dw < w ? dw : w;
            int y0 = (dh - ch) / 2, x0 = (dw - cw) / 2;
            if (ch == dh && cw == dw) {
              ResizeBilinear(pixels.data(), dh, dw, dc, s.data.data(),
                             h, w);
            } else {
              std::vector<uint8_t> crop((size_t)ch * cw * dc);
              for (int y = 0; y < ch; ++y)
                memcpy(crop.data() + (size_t)y * cw * dc,
                       pixels.data() +
                           ((size_t)(y0 + y) * dw + x0) * dc,
                       (size_t)cw * dc);
              ResizeBilinear(crop.data(), ch, cw, dc, s.data.data(),
                             h, w);
            }
            if (out_u8) {
              // round in the WORKER (parallel); ≤0.5 LSB vs the f32
              // path, well inside decoder-parity tolerances
              s.u8.resize(s.data.size());
              for (size_t i = 0; i < s.data.size(); ++i)
                s.u8[i] = (uint8_t)(s.data[i] + 0.5f);
              s.data.clear();
              s.data.shrink_to_fit();
            }
          }
        }
      }
      Emit((uint32_t)i, std::move(s));
    }
    std::lock_guard<std::mutex> lk(mu);   // race-free final wakeup
    --active_workers;
    cv_pop.notify_all();
  }

  void Start(int nthreads) {
    order.resize(rec.offsets.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (uint32_t)i;
    if (shuffle) {
      std::mt19937 rng(seed + epoch);
      for (size_t i = order.size(); i > 1; --i) {
        size_t j = rng() % i;
        std::swap(order[i - 1], order[j]);
      }
    }
    next_idx = 0;
    next_emit = 0;
    stop = false;
    {
      std::lock_guard<std::mutex> lk(mu);
      active_workers = nthreads;
    }
    for (int t = 0; t < nthreads; ++t)
      workers.emplace_back([this] { WorkerLoop(); });
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu);   // no lost wakeups
      stop = true;
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers) t.join();
    workers.clear();
    std::lock_guard<std::mutex> lk(mu);
    ready.clear();
  }
};

// drain up to `batch` ordered samples through `sink(sample, slot)`
template <typename Sink>
long PipeDrain(Pipeline* p, long batch, float* labels, Sink sink) {
  long filled = 0;
  while (filled < batch) {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_pop.wait(lk, [&] {
      return p->ready.count((uint32_t)p->next_emit) ||
             p->active_workers == 0;
    });
    auto it = p->ready.find((uint32_t)p->next_emit);
    if (it == p->ready.end()) {
      // workers finished; skip over any hole a dying worker left
      if (p->ready.empty()) break;
      it = p->ready.begin();
      p->next_emit = it->first;
    }
    Sample s = std::move(it->second);
    p->ready.erase(it);
    ++p->next_emit;
    lk.unlock();
    p->cv_push.notify_all();
    if (s.codec_unavailable) return -kCodecUnavailable;
    if (!s.valid) continue;                  // skipped record
    sink(s, filled);
    labels[filled] = s.label;
    ++filled;
  }
  return filled;
}

}  // namespace

extern "C" {

// which JPEG codec this build holds: "libjpeg" or "nvjpeg"
const char* mxtpu_jpeg_backend() { return kBackend; }

// -- recordio ---------------------------------------------------------------
void* mxtpu_rec_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  RecFile* rf = new RecFile();
  rf->fd = fd;
  // index all record starts in one sequential scan
  uint64_t pos = 0;
  off_t end = lseek(fd, 0, SEEK_END);
  while ((off_t)pos + 8 <= end) {
    uint32_t header[2];
    if (pread(fd, header, 8, (off_t)pos) != 8 || header[0] != kMagic) break;
    uint32_t cflag = header[1] >> 29;
    if (cflag == 0 || cflag == 1) rf->offsets.push_back(pos);
    pos += 8 + (((header[1] & ((1u << 29) - 1)) + 3u) & ~3u);
  }
  return rf;
}

long mxtpu_rec_count(void* h) {
  return h ? (long)static_cast<RecFile*>(h)->offsets.size() : -1;
}

// read record i; returns length and sets *data (valid until next call)
long mxtpu_rec_read(void* h, long i, const uint8_t** data) {
  RecFile* rf = static_cast<RecFile*>(h);
  if (!rf || i < 0 || (size_t)i >= rf->offsets.size()) return -1;
  uint64_t pos = rf->offsets[i];
  if (!ReadRecord(rf->fd, &pos, &rf->scratch)) return -1;
  *data = rf->scratch.data();
  return (long)rf->scratch.size();
}

void mxtpu_rec_close(void* h) {
  RecFile* rf = static_cast<RecFile*>(h);
  if (rf) {
    if (rf->fd >= 0) close(rf->fd);
    delete rf;
  }
}

// -- jpeg -------------------------------------------------------------------
// why the codec could not run in this process, after a call that
// returned -2 (the last such reason; "" when there was none)
const char* mxtpu_codec_error() {
  static thread_local std::string copy;
  std::lock_guard<std::mutex> lk(g_codec_err_mu);
  copy = g_codec_err;
  return copy.c_str();
}

// decode into caller buffer after a probe call with out=null; returns
// needed byte count, -1 for a JPEG it cannot decode, or -2 when the
// codec cannot run in this process (see mxtpu_codec_error)
long mxtpu_jpeg_decode(const uint8_t* buf, unsigned long len, int want_c,
                       uint8_t* out, int* w, int* h, int* c) {
  std::vector<uint8_t> pixels;
  int rc = DecodeJpeg(buf, len, want_c, &pixels, w, h, c);
  if (rc) return -rc;
  if (out) memcpy(out, pixels.data(), pixels.size());
  return (long)pixels.size();
}

// encode HWC uint8 pixels; returns the byte count and sets *out to a
// malloc'd buffer the caller frees with mxtpu_free, -1 on failure, or -2
// when the codec cannot run in this process (see mxtpu_codec_error)
long mxtpu_jpeg_encode(const uint8_t* px, int h, int w, int c,
                       int quality, uint8_t** out) {
  return EncodeJpeg(px, h, w, c, quality, out);
}

void mxtpu_free(void* p) { free(p); }

void mxtpu_resize_bilinear(const uint8_t* src, int sh, int sw, int c,
                           float* dst, int dh, int dw) {
  ResizeBilinear(src, sh, sw, c, dst, dh, dw);
}

// -- pipeline ---------------------------------------------------------------
void* mxtpu_pipe_create(const char* rec_path, int h, int w, int c,
                        int shuffle, unsigned seed, int nthreads,
                        int out_u8) {
  void* rh = mxtpu_rec_open(rec_path);
  if (!rh) return nullptr;
  Pipeline* p = new Pipeline();
  p->rec = *static_cast<RecFile*>(rh);
  static_cast<RecFile*>(rh)->fd = -1;      // ownership moved
  mxtpu_rec_close(rh);
  p->h = h;
  p->w = w;
  p->c = c;
  p->out_u8 = out_u8 != 0;
  p->shuffle = shuffle != 0;
  p->seed = seed;
  p->nthreads = nthreads > 0 ? nthreads : 1;
  p->Start(p->nthreads);
  return p;
}

// fill up to batch samples; returns count (0 = epoch exhausted),
// -1 on mode mismatch (pipe was created with out_u8=1), -2 when the
// codec cannot run in this process (see mxtpu_codec_error)
long mxtpu_pipe_next(void* h, long batch, float* data, float* labels) {
  Pipeline* p = static_cast<Pipeline*>(h);
  if (p->out_u8) return -1;   // samples hold u8; f32 read would be UB
  size_t sample_sz = (size_t)p->h * p->w * p->c;
  return PipeDrain(p, batch, labels, [&](const Sample& s, long i) {
    memcpy(data + i * sample_sz, s.data.data(),
           sample_sz * sizeof(float));
  });
}

// u8 variant; -1 unless the pipe was created with out_u8=1
long mxtpu_pipe_next_u8(void* h, long batch, uint8_t* data,
                        float* labels) {
  Pipeline* p = static_cast<Pipeline*>(h);
  if (!p->out_u8) return -1;
  size_t sample_sz = (size_t)p->h * p->w * p->c;
  return PipeDrain(p, batch, labels, [&](const Sample& s, long i) {
    memcpy(data + i * sample_sz, s.u8.data(), sample_sz);
  });
}

void mxtpu_pipe_reset(void* h) {
  Pipeline* p = static_cast<Pipeline*>(h);
  p->Stop();
  p->epoch += 1;
  p->Start(p->nthreads);
}

void mxtpu_pipe_destroy(void* h) {
  Pipeline* p = static_cast<Pipeline*>(h);
  if (p) {
    p->Stop();
    if (p->rec.fd >= 0) close(p->rec.fd);
    delete p;
  }
}

}  // extern "C"
