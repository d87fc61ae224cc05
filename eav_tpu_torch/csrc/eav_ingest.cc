// eav_ingest: the port's native host-side decode library, a copy of
// eav_tpu/ingest/cpp/eav_ingest.cc (the reference delegates host decode to
// third-party native wheels: scipy.io's C for .mat, torchaudio's C++ for .wav,
// cv2 for .mp4). Exposed to Python through ctypes (eav_tpu_torch/ingest/native.py):
//
//   - WAV (RIFF PCM16/24/32/float) reader -> float32 planar channels
//   - MATLAB v5 (.mat) numeric-matrix reader (zlib-compressed elements too)
//     -> float64 buffers with shape metadata
//   - a threaded prefetch queue of WAV decodes, so a subject's decode
//     overlaps the card's work
//   - an MP4 probe and strided frame decoder through libav, when the build
//     finds its development files (EAV_HAVE_LIBAV)
//
// Built at first use by eav_tpu_torch/ops/build.py (g++ -O3 -fPIC -std=c++17
// -shared, -lz -lpthread, and libav's flags from pkg-config when present)
// into eav_tpu_torch/_build/. The pure-Python readers (ingest/mat5.py,
// ingest/wav.py) are the oracle the tests hold this code to.
//
// One difference from the reference's copy: next_element does not pad a
// miCOMPRESSED element to 8 bytes. MATLAB v5 pads only uncompressed
// elements, so the reference loses every compressed variable after the first.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

// MP4 decode via libav (ffmpeg) when its development files are present.
#ifdef EAV_HAVE_LIBAV
extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libswscale/swscale.h>
}
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Error handling: last error message per process (simple, single-threaded use)
// ---------------------------------------------------------------------------
static thread_local std::string g_last_error;

const char* eav_last_error() { return g_last_error.c_str(); }

static int fail(const std::string& msg) {
  g_last_error = msg;
  return -1;
}

// ---------------------------------------------------------------------------
// WAV reader
// ---------------------------------------------------------------------------

// Reads a RIFF/WAVE file. On success fills *out (malloc'd planar float32,
// channels x samples), *channels, *samples, *sample_rate; returns 0.
// Caller frees with eav_free().
int eav_read_wav(const char* path, float** out, int* channels, long* samples,
                 int* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) != 0 ||
      memcmp(hdr + 8, "WAVE", 4) != 0) {
    fclose(f);
    return fail("not a RIFF/WAVE file");
  }
  uint16_t audio_format = 0, nch = 0, bits = 0;
  uint32_t rate = 0;
  std::vector<unsigned char> data;
  bool have_fmt = false, have_data = false;
  unsigned char chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      if (size < 16) {  // PCM fmt chunk is >= 16 bytes; anything less is corrupt
        fclose(f);
        return fail("fmt chunk too small");
      }
      std::vector<unsigned char> fmt(size);
      if (fread(fmt.data(), 1, size, f) != size) break;
      memcpy(&audio_format, fmt.data(), 2);
      memcpy(&nch, fmt.data() + 2, 2);
      memcpy(&rate, fmt.data() + 4, 4);
      memcpy(&bits, fmt.data() + 14, 2);
      if (audio_format == 0xFFFE && size >= 26)
        memcpy(&audio_format, fmt.data() + 24, 2);
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      data.resize(size);
      if (fread(data.data(), 1, size, f) != size) break;
      have_data = true;
    } else {
      fseek(f, size, SEEK_CUR);
    }
    if (size % 2) fseek(f, 1, SEEK_CUR);
  }
  fclose(f);
  if (!have_fmt || !have_data) return fail("missing fmt/data chunk");
  if (nch == 0) return fail("zero channels");

  long frames = 0;
  std::vector<float> interleaved;
  if (audio_format == 1 && bits == 16) {
    frames = (long)(data.size() / 2 / nch);
    interleaved.resize((size_t)frames * nch);
    const int16_t* p = (const int16_t*)data.data();
    for (long i = 0; i < frames * nch; ++i) interleaved[i] = p[i] / 32768.0f;
  } else if (audio_format == 1 && bits == 32) {
    frames = (long)(data.size() / 4 / nch);
    interleaved.resize((size_t)frames * nch);
    const int32_t* p = (const int32_t*)data.data();
    for (long i = 0; i < frames * nch; ++i)
      interleaved[i] = (float)(p[i] / 2147483648.0);
  } else if (audio_format == 3 && bits == 32) {
    frames = (long)(data.size() / 4 / nch);
    interleaved.resize((size_t)frames * nch);
    memcpy(interleaved.data(), data.data(), (size_t)frames * nch * 4);
  } else if (audio_format == 1 && bits == 24) {
    frames = (long)(data.size() / 3 / nch);
    interleaved.resize((size_t)frames * nch);
    const unsigned char* p = data.data();
    for (long i = 0; i < frames * nch; ++i) {
      int32_t v = p[3 * i] | (p[3 * i + 1] << 8) | (p[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      interleaved[i] = (float)v / (float)(1 << 23);
    }
  } else {
    return fail("unsupported WAV format " + std::to_string(audio_format) +
                "/" + std::to_string(bits) + "bit");
  }
  // interleaved -> planar (channels, samples)
  float* planar = (float*)malloc(sizeof(float) * (size_t)frames * nch);
  if (!planar) return fail("oom");
  for (int c = 0; c < nch; ++c)
    for (long i = 0; i < frames; ++i)
      planar[(size_t)c * frames + i] = interleaved[(size_t)i * nch + c];
  *out = planar;
  *channels = nch;
  *samples = frames;
  *sample_rate = (int)rate;
  return 0;
}

void eav_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// MATLAB v5 reader (numeric matrices, miCOMPRESSED supported)
// ---------------------------------------------------------------------------

namespace {

struct Cursor {
  const unsigned char* p;
  size_t n;
  size_t off = 0;
  bool read(void* dst, size_t k) {
    if (off + k > n) return false;
    memcpy(dst, p + off, k);
    off += k;
    return true;
  }
  const unsigned char* ptr() const { return p + off; }
  void skip(size_t k) { off += k; }
  bool eof() const { return off >= n; }
};

struct Element {
  uint32_t mi_type;
  const unsigned char* data;
  size_t size;
};

bool next_element(Cursor& c, Element* el) {
  uint32_t tag[2];
  if (!c.read(tag, 8)) return false;
  uint32_t mi = tag[0], nbytes = tag[1];
  if (mi >> 16) {  // small element: <= 4 data bytes packed into the tag
    el->mi_type = mi & 0xFFFF;
    el->size = mi >> 16;
    if (el->size > 4) return false;
    el->data = c.ptr() - 4;
    return true;
  }
  // bound the element by the remaining buffer — truncated/corrupt files must
  // fail cleanly (like the Python fallbacks), not read out of bounds
  if (nbytes > c.n - c.off) return false;
  el->mi_type = mi;
  el->size = nbytes;
  el->data = c.ptr();
  // uncompressed elements are padded to 8 bytes; compressed ones are not
  c.skip(mi == 15 ? nbytes : nbytes + ((8 - nbytes % 8) % 8));
  return true;
}

size_t mi_dtype_size(uint32_t t) {
  switch (t) {
    case 1: case 2: return 1;
    case 3: case 4: return 2;
    case 5: case 6: case 7: return 4;
    case 9: case 12: case 13: return 8;
    default: return 0;
  }
}

}  // namespace

// Reads variable `name` from a v5 .mat file as float64 (converted from its
// stored type). Fills *out (malloc'd, Fortran/MATLAB element order),
// *dims (malloc'd int64 array), *ndims. Returns 0 on success.
int eav_read_mat_var(const char* path, const char* name, double** out,
                     int64_t** dims_out, int* ndims_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize < 128) {
    fclose(f);
    return fail("truncated .mat");
  }
  std::vector<unsigned char> buf((size_t)fsize);
  if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    return fail("short read");
  }
  fclose(f);
  uint16_t endian;
  memcpy(&endian, buf.data() + 126, 2);
  if (endian != 0x4D49) return fail("big-endian .mat unsupported");

  Cursor c{buf.data() + 128, (size_t)fsize - 128};
  Element el;
  std::vector<unsigned char> inflated;
  while (!c.eof() && next_element(c, &el)) {
    const unsigned char* body = el.data;
    size_t body_size = el.size;
    if (el.mi_type == 15) {  // miCOMPRESSED
      uLongf dest_len = (uLongf)(body_size * 8 + 1024);
      inflated.resize(dest_len);
      int rc = Z_BUF_ERROR;
      while ((rc = uncompress(inflated.data(), &dest_len, body,
                              (uLong)body_size)) == Z_BUF_ERROR) {
        dest_len = (uLongf)(inflated.size() * 2);
        inflated.resize(dest_len);
      }
      if (rc != Z_OK) return fail("zlib inflate failed");
      Cursor ic{inflated.data(), dest_len};
      if (!next_element(ic, &el)) continue;
      body = el.data;
      body_size = el.size;
    }
    if (el.mi_type != 14) continue;  // miMATRIX
    Cursor m{body, body_size};
    Element flags, dims, nm;
    if (!next_element(m, &flags) || !next_element(m, &dims) ||
        !next_element(m, &nm))
      continue;
    if (flags.size < 1 || dims.size % 4 != 0) continue;
    uint8_t mx_class = flags.data[0];
    std::string vname((const char*)nm.data, nm.size);
    while (!vname.empty() && vname.back() == '\0') vname.pop_back();
    if (vname != name) continue;
    if (mx_class < 6 || mx_class > 15) return fail("unsupported mxCLASS");
    Element real;
    if (!next_element(m, &real)) return fail("missing data element");
    int nd = (int)(dims.size / 4);
    std::vector<int32_t> d(nd);
    memcpy(d.data(), dims.data, dims.size);
    size_t total = 1;
    for (int i = 0; i < nd; ++i) total *= (size_t)d[i];
    size_t esz = mi_dtype_size(real.mi_type);
    if (esz == 0 || real.size < total * esz) return fail("bad data element");
    double* vals = (double*)malloc(sizeof(double) * total);
    if (!vals) return fail("oom");
    const unsigned char* src = real.data;
    for (size_t i = 0; i < total; ++i) {
      switch (real.mi_type) {
        case 1: vals[i] = ((const int8_t*)src)[i]; break;
        case 2: vals[i] = ((const uint8_t*)src)[i]; break;
        case 3: vals[i] = ((const int16_t*)src)[i]; break;
        case 4: vals[i] = ((const uint16_t*)src)[i]; break;
        case 5: vals[i] = ((const int32_t*)src)[i]; break;
        case 6: vals[i] = ((const uint32_t*)src)[i]; break;
        case 7: vals[i] = ((const float*)src)[i]; break;
        case 9: vals[i] = ((const double*)src)[i]; break;
        default: free(vals); return fail("unsupported mi type");
      }
    }
    int64_t* dd = (int64_t*)malloc(sizeof(int64_t) * (size_t)nd);
    for (int i = 0; i < nd; ++i) dd[i] = d[i];
    *out = vals;
    *dims_out = dd;
    *ndims_out = nd;
    return 0;
  }
  return fail(std::string("variable not found: ") + name);
}

// ---------------------------------------------------------------------------
// Prefetch queue: N worker threads run registered jobs (file decode) and a
// consumer pops results in completion order. Python supplies paths; results
// are WAV decodes (the hot ingest loop, 100 files/subject).
// ---------------------------------------------------------------------------

struct WavResult {
  std::string path;
  float* data = nullptr;
  int channels = 0;
  long samples = 0;
  int sample_rate = 0;
  int status = -1;
  std::string error;
};

struct PrefetchQueue {
  std::vector<std::thread> workers;
  std::queue<std::string> jobs;
  std::queue<WavResult*> results;
  std::mutex mu;
  std::condition_variable cv_jobs, cv_results;
  bool closed = false;
  int pending = 0;

  explicit PrefetchQueue(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { worker(); });
  }

  void worker() {
    for (;;) {
      std::string path;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_jobs.wait(lk, [this] { return closed || !jobs.empty(); });
        if (jobs.empty()) return;  // closed
        path = std::move(jobs.front());
        jobs.pop();
      }
      WavResult* r = new WavResult();
      r->path = path;
      r->status = eav_read_wav(path.c_str(), &r->data, &r->channels,
                               &r->samples, &r->sample_rate);
      if (r->status != 0) r->error = g_last_error;
      {
        std::lock_guard<std::mutex> lk(mu);
        results.push(r);
      }
      cv_results.notify_one();
    }
  }

  void submit(const char* path) {
    {
      std::lock_guard<std::mutex> lk(mu);
      jobs.push(path);
      pending++;
    }
    cv_jobs.notify_one();
  }

  WavResult* pop() {
    std::unique_lock<std::mutex> lk(mu);
    cv_results.wait(lk, [this] { return !results.empty(); });
    WavResult* r = results.front();
    results.pop();
    pending--;
    return r;
  }

  ~PrefetchQueue() {
    {
      std::lock_guard<std::mutex> lk(mu);
      closed = true;
    }
    cv_jobs.notify_all();
    for (auto& t : workers) t.join();
    while (!results.empty()) {
      WavResult* r = results.front();
      results.pop();
      if (r->data) free(r->data);
      delete r;
    }
  }
};

void* eav_prefetch_create(int n_threads) { return new PrefetchQueue(n_threads); }

void eav_prefetch_submit(void* q, const char* path) {
  ((PrefetchQueue*)q)->submit(path);
}

// Pops one completed decode. Returns 0 and fills outputs on success; on
// decode failure returns -1 with the error in eav_last_error(). The returned
// buffer must be freed with eav_free().
int eav_prefetch_pop(void* q, char* path_out, int path_cap, float** data,
                     int* channels, long* samples, int* sample_rate) {
  WavResult* r = ((PrefetchQueue*)q)->pop();
  snprintf(path_out, path_cap, "%s", r->path.c_str());
  int status = r->status;
  if (status == 0) {
    *data = r->data;
    *channels = r->channels;
    *samples = r->samples;
    *sample_rate = r->sample_rate;
  } else {
    g_last_error = r->error;
    if (r->data) free(r->data);
  }
  delete r;
  return status;
}

void eav_prefetch_destroy(void* q) { delete (PrefetchQueue*)q; }

// ---------------------------------------------------------------------------
// MP4 strided frame decode (libav). Replaces the reference's cv2
// read-every-frame loop (`Dataload_vision.py:49-62`): every frame is decoded
// (inter-frame codecs require it) but only every `stride`-th is converted
// YUV->RGB24, and the whole loop runs without the GIL so Python-side thread
// pools scale.
// ---------------------------------------------------------------------------

// 1 when this build can decode mp4, else 0.
int eav_mp4_supported() {
#ifdef EAV_HAVE_LIBAV
  return 1;
#else
  return 0;
#endif
}

// Header-only probe: video dimensions without decoding (mp4 moov carries
// codec params). Lets the caller pre-allocate the exact frame buffer for
// eav_read_mp4_strided_into.
int eav_mp4_probe(const char* path, int* width, int* height) {
#ifndef EAV_HAVE_LIBAV
  (void)path; (void)width; (void)height;
  return fail("built without libav (rebuild with ffmpeg dev libraries)");
#else
  // IDENTICAL stream selection to eav_read_mp4_strided_into (header-params
  // check, else find_stream_info; then av_find_best_stream) so the probe
  // dims always describe the stream the decoder will pick.
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
    return fail(std::string("cannot open ") + path);
  bool have_params = false;
  for (unsigned i = 0; i < fmt->nb_streams; ++i) {
    AVCodecParameters* p = fmt->streams[i]->codecpar;
    if (p->codec_type == AVMEDIA_TYPE_VIDEO && p->codec_id != AV_CODEC_ID_NONE &&
        p->width > 0 && p->height > 0) {
      have_params = true;
      break;
    }
  }
  if (!have_params && avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return fail("no stream info");
  }
  int vs = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (vs < 0) {
    avformat_close_input(&fmt);
    return fail("no video stream");
  }
  int w = fmt->streams[vs]->codecpar->width;
  int h = fmt->streams[vs]->codecpar->height;
  avformat_close_input(&fmt);
  if (w <= 0 || h <= 0) return fail("no video stream");
  *width = w; *height = h;
  return 0;
#endif
}

// Decodes frames 0, stride, 2*stride, ... < max_frames of the first video
// stream, writing RGB24 frames directly into the caller's buffer (e.g. a
// pre-allocated numpy array — avoids a second multi-hundred-MB copy, which
// costs seconds on hosts with slow first-touch memory). cap_bytes bounds
// the buffer. Returns 0 on success.
int eav_read_mp4_strided_into(const char* path, int stride, int max_frames,
                              uint8_t* buf, long cap_bytes, int* n_frames,
                              int* height, int* width) {
#ifndef EAV_HAVE_LIBAV
  (void)path; (void)stride; (void)max_frames; (void)buf; (void)cap_bytes;
  (void)n_frames; (void)height; (void)width;
  return fail("built without libav (rebuild with ffmpeg dev libraries)");
#else
  if (stride <= 0 || max_frames <= 0) return fail("bad stride/max_frames");
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
    return fail(std::string("cannot open ") + path);
  // mp4 moov atoms already carry codec parameters; find_stream_info would
  // pre-decode a probe window per file (a large per-clip cost at HD).
  // Only fall back to probing when the header left params unfilled.
  bool have_params = false;
  for (unsigned i = 0; i < fmt->nb_streams; ++i) {
    AVCodecParameters* p = fmt->streams[i]->codecpar;
    if (p->codec_type == AVMEDIA_TYPE_VIDEO && p->codec_id != AV_CODEC_ID_NONE &&
        p->width > 0 && p->height > 0) {
      have_params = true;
      break;
    }
  }
  if (!have_params && avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return fail("no stream info");
  }
  int vs = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (vs < 0) {
    avformat_close_input(&fmt);
    return fail("no video stream");
  }
  AVCodecParameters* par = fmt->streams[vs]->codecpar;
  const AVCodec* dec = avcodec_find_decoder(par->codec_id);
  if (!dec) {
    avformat_close_input(&fmt);
    return fail("unsupported codec");
  }
  AVCodecContext* ctx = avcodec_alloc_context3(dec);
  if (!ctx || avcodec_parameters_to_context(ctx, par) < 0 ||
      avcodec_open2(ctx, dec, nullptr) < 0) {
    if (ctx) avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return fail("cannot open codec");
  }
  const int w = par->width, h = par->height;
  if (w <= 0 || h <= 0) {
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return fail("bad video dimensions");
  }
  const int cap = (max_frames + stride - 1) / stride;
  if ((long)cap * h * w * 3 > cap_bytes) {
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return fail("caller buffer too small for decoded frames");
  }
  SwsContext* sws = nullptr;
  // sws context is cached per source geometry/format and recreated if the
  // stream changes mid-file (rare, but silently stretching frames through a
  // stale context would corrupt data).
  int sws_w = -1, sws_h = -1, sws_fmt = -1;
  // swscale's vector writers may store past the end of a row that is not
  // padded (an RGB24 row of w*3 bytes): converting straight into the
  // caller's buffer overran it when the kept frames filled it (the
  // reference's copy does; a 40-pixel-wide clip corrupts the heap). Each
  // kept frame is converted into a scratch image with 64-byte aligned,
  // padded rows and copied row by row.
  const int scratch_line = ((w * 3 + 63) / 64) * 64 + 64;
  uint8_t* scratch = (uint8_t*)av_malloc((size_t)scratch_line * (h + 1));
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  if (!scratch || !pkt || !frame) {
    av_free(scratch);
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return fail("out of memory for the decoder's buffers");
  }
  int idx = 0, kept = 0;
  bool done = false, error = false;
  std::string err_msg;

  auto handle_frame = [&](AVFrame* f) {
    if (idx >= max_frames) { done = true; return; }
    if (idx % stride == 0 && kept < cap) {
      if (!sws || f->width != sws_w || f->height != sws_h ||
          f->format != sws_fmt) {
        if (sws) sws_freeContext(sws);
        sws = sws_getContext(f->width, f->height, (AVPixelFormat)f->format,
                             w, h, AV_PIX_FMT_RGB24, SWS_FAST_BILINEAR, nullptr,
                             nullptr, nullptr);
        if (!sws) { error = true; err_msg = "sws_getContext failed"; done = true; return; }
        sws_w = f->width; sws_h = f->height; sws_fmt = f->format;
      }
      uint8_t* dst[1] = {scratch};
      int lines[1] = {scratch_line};
      sws_scale(sws, f->data, f->linesize, 0, f->height, dst, lines);
      uint8_t* out = buf + (size_t)kept * h * w * 3;
      for (int r = 0; r < h; ++r)
        memcpy(out + (size_t)r * w * 3, scratch + (size_t)r * scratch_line, (size_t)w * 3);
      kept++;
    }
    idx++;
  };

  while (!done && av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == vs) {
      int rc = avcodec_send_packet(ctx, pkt);
      if (rc == 0) {
        while (!done && avcodec_receive_frame(ctx, frame) == 0)
          handle_frame(frame);
      } else if (rc != AVERROR(EAGAIN)) {
        // A dropped packet would silently SHIFT every later strided frame
        // index relative to the cv2 reference loop — corrupt input is an
        // error, not a skip. (EAGAIN cannot occur here: the receive loop
        // above always drains the decoder before the next send.)
        error = true;
        err_msg = "avcodec_send_packet failed (corrupt packet?)";
        done = true;
      }
    }
    av_packet_unref(pkt);
  }
  if (!done) {  // drain the decoder
    avcodec_send_packet(ctx, nullptr);
    while (!done && avcodec_receive_frame(ctx, frame) == 0)
      handle_frame(frame);
  }
  if (sws) sws_freeContext(sws);
  av_free(scratch);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&ctx);
  avformat_close_input(&fmt);
  if (error) return fail(err_msg);
  if (kept == 0) return fail("no frames decoded");
  *n_frames = kept;
  *height = h;
  *width = w;
  return 0;
#endif
}

}  // extern "C"
