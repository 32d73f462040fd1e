// mxnet_tpu_torch's copy of mxnet_tpu/native/imagedec.cc: the same code with its C
// symbols prefixed MXT (not MXTPU), so both packages' libraries can be
// loaded into one process.
//
// Batch JPEG decode + augment pipeline — the TPU-native rebuild of the
// reference's in-engine image pipeline (reference src/io/iter_image_recordio_2.cc:
// ImageRecordIOParser2 decodes record chunks on C++ threads with OpenCV;
// reference src/io/image_aug_default.cc applies crop/mirror/normalize).
//
// Design for a host that feeds a TPU:
//  - libjpeg-turbo with DCT-domain scaling (scale_num/8) and region-limited
//    decode (jpeg_crop_scanline + jpeg_skip_scanlines): only the pixels the
//    crop window needs are entropy-decoded and IDCT'd.
//  - One fused resample pass: decoded window -> bilinear resize -> crop ->
//    mirror -> (x-mean)/std -> dtype cast -> NCHW/NHWC pack.  No intermediate
//    float image, no transpose pass, no second copy.
//  - Output dtype includes bfloat16 so the host->device transfer moves half
//    the bytes of f32 and the device casts for free.
//  - Deterministic augmentation: crop offsets/mirror bits derive from
//    (chunk_seed, image index) via splitmix64 — independent of thread
//    scheduling, reproducible across runs.
//  - Persistent worker pool; the calling thread participates, so on a
//    single-core host there is zero pool overhead (the call degrades to a
//    plain loop).  Python callers invoke through ctypes, which releases the
//    GIL for the duration — decode overlaps the interpreter's train-step
//    dispatch even with one core.
#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace mxt {
namespace {

// ---------------------------------------------------------------------------
// deterministic rng (splitmix64) — mirrors the Python pipeline's
// _chunk_seed mixing discipline (image.py): a sample's augmentation is a
// pure function of (chunk_seed, index).
// ---------------------------------------------------------------------------
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t Next() {
    state += 0x9e3779b97f4a7c15ULL;
    uint64_t z = state;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform integer in [0, n] (n inclusive); n >= 0
  uint32_t Below(uint32_t n) {
    return n == 0 ? 0 : static_cast<uint32_t>(Next() % (uint64_t(n) + 1));
  }
};

inline uint64_t MixSeed(uint64_t chunk_seed, uint64_t idx) {
  uint64_t z = chunk_seed * 0x9e3779b97f4a7c15ULL +
               idx * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 30)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// ---------------------------------------------------------------------------
// libjpeg error trampoline: decode errors long-jump back and mark the
// sample invalid (the reference parser likewise tolerates bad images
// per-record instead of failing the batch).
// ---------------------------------------------------------------------------
struct JpegError {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void ErrorExit(j_common_ptr cinfo) {
  JpegError* err = reinterpret_cast<JpegError*>(cinfo->err);
  longjmp(err->jump, 1);
}

void SilentEmit(j_common_ptr, int) {}
void SilentOutput(j_common_ptr) {}

inline uint16_t FloatToBf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  // round-to-nearest-even on the dropped 16 bits
  uint32_t rounded = bits + 0x7fffU + ((bits >> 16) & 1U);
  return static_cast<uint16_t>(rounded >> 16);
}

enum DType { kU8 = 0, kF32 = 1, kBf16 = 2 };
enum Layout { kNCHW = 0, kNHWC = 1 };

struct PipeConfig {
  int out_h, out_w;
  int resize;       // shorter-edge resize before crop; 0 = crop from source
  int rand_crop;    // 1 = random offsets, 0 = center
  int rand_mirror;  // 1 = flip horizontally with p=0.5
  int dtype;        // DType
  int layout;       // Layout
  int fast_dct;     // 1 = JDCT_IFAST (~1.5x decode speed, +-2 LSB vs exact)
  float mean[3];
  float std_inv[3];
  bool normalize;
};

size_t DTypeSize(int dt) { return dt == kF32 ? 4 : (dt == kBf16 ? 2 : 1); }

// Per-thread scratch: the decoded source window (RGB u8 rows) + the
// per-output-column bilinear taps (rebuilt per image, allocated once).
struct XTap {
  int ix;
  float fx;
};

struct Scratch {
  std::vector<uint8_t> window;  // win_h * win_stride bytes
  std::vector<JSAMPROW> rows;
  std::vector<XTap> xmap;
};

// byte -> normalized output value, per channel (the pack stage's entire
// arithmetic for unit-scale crops collapses into this table).
union LutVal {
  uint8_t u8;
  float f32;
  uint16_t b16;
};

struct Lut {
  LutVal v[3][256];
};

inline void StoreVal(uint8_t* dst, float v) {
  int q = static_cast<int>(v + 0.5f);
  *dst = static_cast<uint8_t>(q < 0 ? 0 : (q > 255 ? 255 : q));
}
inline void StoreVal(float* dst, float v) { *dst = v; }
inline void StoreVal(uint16_t* dst, float v) { *dst = FloatToBf16(v); }

inline uint8_t LutGet(const LutVal& lv, uint8_t*) { return lv.u8; }
inline float LutGet(const LutVal& lv, float*) { return lv.f32; }
inline uint16_t LutGet(const LutVal& lv, uint16_t*) { return lv.b16; }

// Identity unit-scale pack for raw uint8 NHWC output: rows memcpy straight
// out of the decode window (the TPU feed path — normalization happens on
// device where it fuses into the first conv).
void PackUnitCopyNHWC(const PipeConfig& cfg, const uint8_t* win,
                      int win_stride, int src_x, int src_y, bool mirror,
                      uint8_t* out) {
  const size_t row_bytes = static_cast<size_t>(cfg.out_w) * 3;
  for (int oy = 0; oy < cfg.out_h; ++oy) {
    const uint8_t* row =
        win + static_cast<size_t>(src_y + oy) * win_stride + src_x * 3;
    uint8_t* dst = out + static_cast<size_t>(oy) * row_bytes;
    if (!mirror) {
      std::memcpy(dst, row, row_bytes);
    } else {
      const uint8_t* p = row + (cfg.out_w - 1) * 3;
      for (int ox = 0; ox < cfg.out_w; ++ox, p -= 3, dst += 3) {
        dst[0] = p[0];
        dst[1] = p[1];
        dst[2] = p[2];
      }
    }
  }
}

// Unit-scale pack: the crop maps 1:1 onto decoded pixels, so each output
// channel value is lut[c][source byte].  OutT in {uint8_t,float,uint16_t}.
template <typename OutT, bool kNchw>
void PackUnit(const PipeConfig& cfg, const uint8_t* win, int win_stride,
              int src_x, int src_y, bool mirror, const Lut& lut, OutT* out) {
  const size_t plane = static_cast<size_t>(cfg.out_h) * cfg.out_w;
  for (int oy = 0; oy < cfg.out_h; ++oy) {
    const uint8_t* row =
        win + static_cast<size_t>(src_y + oy) * win_stride + src_x * 3;
    OutT* o0;
    OutT* o1;
    OutT* o2;
    if (kNchw) {
      size_t base = static_cast<size_t>(oy) * cfg.out_w;
      o0 = out + base;
      o1 = out + plane + base;
      o2 = out + 2 * plane + base;
    } else {
      o0 = out + static_cast<size_t>(oy) * cfg.out_w * 3;
      o1 = o0 + 1;
      o2 = o0 + 2;
    }
    const int step = kNchw ? 1 : 3;
    if (mirror) {
      const uint8_t* p = row + (cfg.out_w - 1) * 3;
      for (int ox = 0; ox < cfg.out_w; ++ox, p -= 3) {
        *o0 = LutGet(lut.v[0][p[0]], o0);
        *o1 = LutGet(lut.v[1][p[1]], o1);
        *o2 = LutGet(lut.v[2][p[2]], o2);
        o0 += step;
        o1 += step;
        o2 += step;
      }
    } else {
      const uint8_t* p = row;
      for (int ox = 0; ox < cfg.out_w; ++ox, p += 3) {
        *o0 = LutGet(lut.v[0][p[0]], o0);
        *o1 = LutGet(lut.v[1][p[1]], o1);
        *o2 = LutGet(lut.v[2][p[2]], o2);
        o0 += step;
        o1 += step;
        o2 += step;
      }
    }
  }
}

// Bilinear pack with precomputed x taps; y taps computed per row.
template <typename OutT, bool kNchw>
void PackBilinear(const PipeConfig& cfg, const uint8_t* win, int win_stride,
                  int win_h, const XTap* xmap, double map_y0, double map_dy,
                  OutT* out) {
  const size_t plane = static_cast<size_t>(cfg.out_h) * cfg.out_w;
  const int hmax = win_h - 1;
  const float m0 = cfg.mean[0], m1 = cfg.mean[1], m2 = cfg.mean[2];
  const float i0 = cfg.std_inv[0], i1 = cfg.std_inv[1], i2 = cfg.std_inv[2];
  const bool norm = cfg.normalize;
  for (int oy = 0; oy < cfg.out_h; ++oy) {
    double dy = map_y0 + oy * map_dy;
    if (dy < 0) dy = 0;
    if (dy > hmax) dy = hmax;
    int iy = static_cast<int>(dy);
    if (iy > hmax - 1) iy = hmax > 0 ? hmax - 1 : 0;
    const float fy = static_cast<float>(dy - iy);
    const float ofy = 1.0f - fy;
    const uint8_t* row0 = win + static_cast<size_t>(iy) * win_stride;
    const uint8_t* row1 = hmax == 0 ? row0 : row0 + win_stride;
    OutT* o0;
    OutT* o1;
    OutT* o2;
    if (kNchw) {
      size_t base = static_cast<size_t>(oy) * cfg.out_w;
      o0 = out + base;
      o1 = out + plane + base;
      o2 = out + 2 * plane + base;
    } else {
      o0 = out + static_cast<size_t>(oy) * cfg.out_w * 3;
      o1 = o0 + 1;
      o2 = o0 + 2;
    }
    const int step = kNchw ? 1 : 3;
    for (int ox = 0; ox < cfg.out_w; ++ox) {
      const XTap t = xmap[ox];
      const uint8_t* p00 = row0 + t.ix * 3;
      const uint8_t* p10 = row1 + t.ix * 3;
      const float fx = t.fx, ofx = 1.0f - fx;
      const float w00 = ofx * ofy, w01 = fx * ofy;
      const float w10 = ofx * fy, w11 = fx * fy;
      float v0 = w00 * p00[0] + w01 * p00[3] + w10 * p10[0] + w11 * p10[3];
      float v1 = w00 * p00[1] + w01 * p00[4] + w10 * p10[1] + w11 * p10[4];
      float v2 = w00 * p00[2] + w01 * p00[5] + w10 * p10[2] + w11 * p10[5];
      if (norm) {
        v0 = (v0 - m0) * i0;
        v1 = (v1 - m1) * i1;
        v2 = (v2 - m2) * i2;
      }
      StoreVal(o0, v0);
      StoreVal(o1, v1);
      StoreVal(o2, v2);
      o0 += step;
      o1 += step;
      o2 += step;
    }
  }
}

// reference python/mxnet/image.py:scale_down — shrink the crop if the
// (resized) source is smaller than the requested crop.
inline void ScaleDown(int sw, int sh, int* cw, int* ch) {
  if (sh < *ch) {
    *cw = static_cast<int>(static_cast<float>(*cw) * sh / *ch);
    *ch = sh;
  }
  if (sw < *cw) {
    *ch = static_cast<int>(static_cast<float>(*ch) * sw / *cw);
    *cw = sw;
  }
  if (*cw < 1) *cw = 1;
  if (*ch < 1) *ch = 1;
}

Lut BuildLut(const PipeConfig& cfg) {
  Lut lut;
  for (int c = 0; c < 3; ++c) {
    for (int b = 0; b < 256; ++b) {
      float v = static_cast<float>(b);
      if (cfg.normalize) v = (v - cfg.mean[c]) * cfg.std_inv[c];
      switch (cfg.dtype) {
        case kU8: {
          int q = static_cast<int>(v + 0.5f);
          lut.v[c][b].u8 =
              static_cast<uint8_t>(q < 0 ? 0 : (q > 255 ? 255 : q));
          break;
        }
        case kF32:
          lut.v[c][b].f32 = v;
          break;
        default:
          lut.v[c][b].b16 = FloatToBf16(v);
      }
    }
  }
  return lut;
}

// Decode one JPEG and write the augmented sample into out (one image's
// slot inside the batch buffer).  Returns false on any decode error.
bool DecodeOne(const PipeConfig& cfg, const Lut& lut, const uint8_t* buf,
               uint64_t len, void* out, uint64_t seed, Scratch* scratch) {
  if (len == 0) return false;
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = ErrorExit;
  jerr.pub.emit_message = SilentEmit;
  jerr.pub.output_message = SilentOutput;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale sources convert in-decode
  if (cfg.fast_dct) {
    // training profile: IFAST is the fastest SIMD IDCT in libjpeg-turbo
    // (measured ~1.5x the default ISLOW on 256px q90 photos on this
    // host); output differs from the exact path by at most a couple of
    // 8-bit steps, which augmentation noise dwarfs.  Exact mode
    // (MXNET_JPEG_DECODE_FAST=0) keeps byte parity with cv2.
    cinfo.dct_method = JDCT_IFAST;
  }

  const int src_w = static_cast<int>(cinfo.image_width);
  const int src_h = static_cast<int>(cinfo.image_height);
  if (src_w <= 0 || src_h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }

  // Resized dims (reference image.py:resize_short integer semantics).
  int rs_w = src_w, rs_h = src_h;
  if (cfg.resize > 0) {
    if (src_h > src_w) {
      rs_w = cfg.resize;
      rs_h = static_cast<int>(static_cast<int64_t>(cfg.resize) * src_h /
                              src_w);
    } else {
      rs_h = cfg.resize;
      rs_w = static_cast<int>(static_cast<int64_t>(cfg.resize) * src_w /
                              src_h);
    }
    // DCT-domain prescale: the largest downscale that still leaves the
    // shorter edge >= the resize target (so the bilinear pass only ever
    // shrinks a little, never invents pixels).
    int m = 8;
    while (m > 1) {
      int cand = m - 1;
      if (static_cast<int64_t>(src_w) * cand / 8 >= rs_w &&
          static_cast<int64_t>(src_h) * cand / 8 >= rs_h) {
        m = cand;
      } else {
        break;
      }
    }
    cinfo.scale_num = static_cast<unsigned>(m);
    cinfo.scale_denom = 8;
  }

  jpeg_calc_output_dimensions(&cinfo);
  const int dec_w = static_cast<int>(cinfo.output_width);
  const int dec_h = static_cast<int>(cinfo.output_height);

  // Crop window in resized space.
  Rng rng(MixSeed(seed, 0));
  int crop_w = cfg.out_w, crop_h = cfg.out_h;
  ScaleDown(rs_w, rs_h, &crop_w, &crop_h);
  int x0, y0;
  if (cfg.rand_crop) {
    x0 = static_cast<int>(rng.Below(static_cast<uint32_t>(rs_w - crop_w)));
    y0 = static_cast<int>(rng.Below(static_cast<uint32_t>(rs_h - crop_h)));
  } else {
    x0 = (rs_w - crop_w) / 2;
    y0 = (rs_h - crop_h) / 2;
  }
  const bool mirror = cfg.rand_mirror && (rng.Next() & 1U);

  // Map the crop window back into decoded space; pad one pixel for the
  // bilinear taps.
  const double sx = static_cast<double>(dec_w) / rs_w;   // resized->decoded
  const double sy = static_cast<double>(dec_h) / rs_h;
  int wx0 = static_cast<int>(x0 * sx) - 1;
  int wy0 = static_cast<int>(y0 * sy) - 1;
  int wx1 = static_cast<int>((x0 + crop_w) * sx) + 2;
  int wy1 = static_cast<int>((y0 + crop_h) * sy) + 2;
  if (wx0 < 0) wx0 = 0;
  if (wy0 < 0) wy0 = 0;
  if (wx1 > dec_w) wx1 = dec_w;
  if (wy1 > dec_h) wy1 = dec_h;

  jpeg_start_decompress(&cinfo);

  // Horizontal region-of-interest decode (iMCU-aligned; the library moves
  // the left edge, we track the shift).
  JDIMENSION roi_x = static_cast<JDIMENSION>(wx0);
  JDIMENSION roi_w = static_cast<JDIMENSION>(wx1 - wx0);
  if (static_cast<int>(roi_w) < dec_w) {
    jpeg_crop_scanline(&cinfo, &roi_x, &roi_w);
  }
  const int win_x0 = static_cast<int>(roi_x);
  const int win_w = static_cast<int>(roi_w);
  const int win_stride = win_w * 3;
  const int win_h = wy1 - wy0;

  // +3 bytes slack: the bilinear inner loop reads tap ix+1 unconditionally
  // (its weight is zero at the right edge of a degenerate 1-px window).
  scratch->window.resize(static_cast<size_t>(win_h) * win_stride + 3);
  scratch->rows.resize(win_h);
  for (int r = 0; r < win_h; ++r) {
    scratch->rows[r] = scratch->window.data() +
                       static_cast<size_t>(r) * win_stride;
  }

  if (wy0 > 0) jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(wy0));
  int got = 0;
  while (got < win_h) {
    JDIMENSION n = jpeg_read_scanlines(&cinfo, scratch->rows.data() + got,
                                       static_cast<JDIMENSION>(win_h - got));
    if (n == 0) break;
    got += static_cast<int>(n);
  }
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (got < win_h) return false;

  // Fused resample/pack.  The out->window mapping is affine per axis:
  //   d = (o + 0.5) * g * s + x0 * s - 0.5 - win_origin
  // with g = crop/out (crop resampling) and s = dec/resized (DCT prescale
  // residual).  Unit scale (crop straight from the stored image, the
  // common training case) collapses to a LUT copy.
  const double gx = static_cast<double>(crop_w) / cfg.out_w;
  const double gy = static_cast<double>(crop_h) / cfg.out_h;
  const uint8_t* win = scratch->window.data();
  const int wmax = win_w - 1;

  const bool unit = dec_w == rs_w && dec_h == rs_h && crop_w == cfg.out_w &&
                    crop_h == cfg.out_h;
  if (unit) {
    const int src_x = x0 - win_x0;
    const int src_y = y0 - wy0;
    if (cfg.dtype == kU8 && cfg.layout == kNHWC && !cfg.normalize) {
      PackUnitCopyNHWC(cfg, win, win_stride, src_x, src_y, mirror,
                       static_cast<uint8_t*>(out));
      return true;
    }
    switch (cfg.dtype) {
      case kU8:
        if (cfg.layout == kNCHW)
          PackUnit<uint8_t, true>(cfg, win, win_stride, src_x, src_y, mirror,
                                  lut, static_cast<uint8_t*>(out));
        else
          PackUnit<uint8_t, false>(cfg, win, win_stride, src_x, src_y, mirror,
                                   lut, static_cast<uint8_t*>(out));
        break;
      case kF32:
        if (cfg.layout == kNCHW)
          PackUnit<float, true>(cfg, win, win_stride, src_x, src_y, mirror,
                                lut, static_cast<float*>(out));
        else
          PackUnit<float, false>(cfg, win, win_stride, src_x, src_y, mirror,
                                 lut, static_cast<float*>(out));
        break;
      default:
        if (cfg.layout == kNCHW)
          PackUnit<uint16_t, true>(cfg, win, win_stride, src_x, src_y, mirror,
                                   lut, static_cast<uint16_t*>(out));
        else
          PackUnit<uint16_t, false>(cfg, win, win_stride, src_x, src_y,
                                    mirror, lut, static_cast<uint16_t*>(out));
    }
    return true;
  }

  scratch->xmap.resize(cfg.out_w);
  const double step_x = gx * sx;
  const double c0_x = 0.5 * step_x + x0 * sx - 0.5 - win_x0;
  for (int ox = 0; ox < cfg.out_w; ++ox) {
    int oxs = mirror ? (cfg.out_w - 1 - ox) : ox;
    double dx = c0_x + oxs * step_x;
    if (dx < 0) dx = 0;
    if (dx > wmax) dx = wmax;
    int ix = static_cast<int>(dx);
    if (ix > wmax - 1) ix = wmax > 0 ? wmax - 1 : 0;
    scratch->xmap[ox].ix = ix;
    scratch->xmap[ox].fx = static_cast<float>(dx - ix);
  }
  const double step_y = gy * sy;
  const double c0_y = 0.5 * step_y + y0 * sy - 0.5 - wy0;
  switch (cfg.dtype) {
    case kU8:
      if (cfg.layout == kNCHW)
        PackBilinear<uint8_t, true>(cfg, win, win_stride, win_h,
                                    scratch->xmap.data(), c0_y, step_y,
                                    static_cast<uint8_t*>(out));
      else
        PackBilinear<uint8_t, false>(cfg, win, win_stride, win_h,
                                     scratch->xmap.data(), c0_y, step_y,
                                     static_cast<uint8_t*>(out));
      break;
    case kF32:
      if (cfg.layout == kNCHW)
        PackBilinear<float, true>(cfg, win, win_stride, win_h,
                                  scratch->xmap.data(), c0_y, step_y,
                                  static_cast<float*>(out));
      else
        PackBilinear<float, false>(cfg, win, win_stride, win_h,
                                   scratch->xmap.data(), c0_y, step_y,
                                   static_cast<float*>(out));
      break;
    default:
      if (cfg.layout == kNCHW)
        PackBilinear<uint16_t, true>(cfg, win, win_stride, win_h,
                                     scratch->xmap.data(), c0_y, step_y,
                                     static_cast<uint16_t*>(out));
      else
        PackBilinear<uint16_t, false>(cfg, win, win_stride, win_h,
                                      scratch->xmap.data(), c0_y, step_y,
                                      static_cast<uint16_t*>(out));
  }
  return true;
}

// ---------------------------------------------------------------------------
// Pipeline object: config + persistent worker pool.  DecodeBatch partitions
// images over (workers + caller) via an atomic cursor.
// ---------------------------------------------------------------------------
struct BatchJob {
  const uint8_t* const* bufs;
  const uint64_t* lens;
  int n;
  void* out;
  uint8_t* valid;
  uint64_t chunk_seed;
  size_t sample_bytes;
  std::atomic<int> cursor{0};
  std::atomic<int> done{0};
};

class ImagePipe {
 public:
  ImagePipe(const PipeConfig& cfg, int nthreads)
      : cfg_(cfg), lut_(BuildLut(cfg)) {
    int extra = nthreads - 1;
    if (extra < 0) extra = 0;
    for (int i = 0; i < extra; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~ImagePipe() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int DecodeBatch(const uint8_t* const* bufs, const uint64_t* lens, int n,
                  void* out, uint8_t* valid, uint64_t chunk_seed) {
    BatchJob job;
    job.bufs = bufs;
    job.lens = lens;
    job.n = n;
    job.out = out;
    job.valid = valid;
    job.chunk_seed = chunk_seed;
    job.sample_bytes = static_cast<size_t>(cfg_.out_h) * cfg_.out_w * 3 *
                       DTypeSize(cfg_.dtype);
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = &job;
    }
    cv_.notify_all();
    Work(&job, &caller_scratch_);  // caller participates
    // Wait until every image is done AND no worker still holds the job
    // pointer — `job` lives on this stack frame, so a worker that grabbed
    // job_ must fully exit Work() before we return (working_ guards the
    // window between a worker's last cursor probe and its release).
    {
      std::unique_lock<std::mutex> lk(mu_);
      done_cv_.wait(lk, [&] {
        return job.done.load() >= job.n && working_ == 0;
      });
      job_ = nullptr;
    }
    int nvalid = 0;
    for (int i = 0; i < n; ++i) nvalid += valid[i] ? 1 : 0;
    return nvalid;
  }

 private:
  void Work(BatchJob* job, Scratch* scratch) {
    for (;;) {
      int i = job->cursor.fetch_add(1);
      if (i >= job->n) break;
      void* slot = static_cast<uint8_t*>(job->out) +
                   static_cast<size_t>(i) * job->sample_bytes;
      bool ok = DecodeOne(cfg_, lut_, job->bufs[i], job->lens[i], slot,
                          MixSeed(job->chunk_seed, static_cast<uint64_t>(i)),
                          scratch);
      job->valid[i] = ok ? 1 : 0;
      if (job->done.fetch_add(1) + 1 >= job->n) {
        std::lock_guard<std::mutex> lk(mu_);
        done_cv_.notify_all();
      }
    }
  }

  void WorkerLoop() {
    Scratch scratch;
    for (;;) {
      BatchJob* job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] {
          return stop_ || (job_ != nullptr && job_->cursor.load() < job_->n);
        });
        if (stop_) return;
        job = job_;
        ++working_;  // claimed under the lock: DecodeBatch cannot free the
                     // job until this drops back to zero
      }
      Work(job, &scratch);
      {
        std::lock_guard<std::mutex> lk(mu_);
        --working_;
        done_cv_.notify_all();
      }
    }
  }

  PipeConfig cfg_;
  Lut lut_;
  std::vector<std::thread> workers_;
  Scratch caller_scratch_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  BatchJob* job_ = nullptr;
  int working_ = 0;
  bool stop_ = false;
};

}  // namespace
}  // namespace mxt

extern "C" {

// mean/std: pointers to 3 floats (RGB) or null for no normalization.
void* MXTImgPipeCreate(int nthreads, int out_h, int out_w, int resize,
                         int rand_crop, int rand_mirror, int dtype, int layout,
                         const float* mean, const float* stdv, int fast_dct) {
  mxt::PipeConfig cfg;
  cfg.out_h = out_h;
  cfg.out_w = out_w;
  cfg.resize = resize;
  cfg.rand_crop = rand_crop;
  cfg.rand_mirror = rand_mirror;
  cfg.dtype = dtype;
  cfg.layout = layout;
  cfg.fast_dct = fast_dct;
  cfg.normalize = (mean != nullptr) || (stdv != nullptr);
  for (int c = 0; c < 3; ++c) {
    cfg.mean[c] = mean ? mean[c] : 0.0f;
    float s = stdv ? stdv[c] : 1.0f;
    cfg.std_inv[c] = s != 0.0f ? 1.0f / s : 1.0f;
  }
  if (out_h <= 0 || out_w <= 0 || dtype < 0 || dtype > 2) return nullptr;
  return new mxt::ImagePipe(cfg, nthreads < 1 ? 1 : nthreads);
}

int MXTImgPipeDecodeBatch(void* handle, const uint8_t* const* bufs,
                            const uint64_t* lens, int n, void* out,
                            uint8_t* valid, uint64_t chunk_seed) {
  return static_cast<mxt::ImagePipe*>(handle)->DecodeBatch(
      bufs, lens, n, out, valid, chunk_seed);
}

void MXTImgPipeDestroy(void* handle) {
  delete static_cast<mxt::ImagePipe*>(handle);
}

// Single-image decode to a caller-provided HWC u8 buffer of the NATIVE
// size (for mx.nd.imdecode).  Caller first asks for dims with
// MXTImgDecodeDims, then decodes.  to_rgb=0 gives BGR byte order
// (reference _cvimdecode default), 1 gives RGB.
int MXTImgDecodeDims(const uint8_t* buf, uint64_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  mxt::JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = mxt::ErrorExit;
  jerr.pub.emit_message = mxt::SilentEmit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int MXTImgDecode(const uint8_t* buf, uint64_t len, uint8_t* out,
                   int to_rgb) {
  jpeg_decompress_struct cinfo;
  mxt::JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = mxt::ErrorExit;
  jerr.pub.emit_message = mxt::SilentEmit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  std::vector<JSAMPROW> rows(1);
  while (cinfo.output_scanline < cinfo.output_height) {
    rows[0] = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, rows.data(), 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (!to_rgb) {  // swap to BGR in place
    const size_t npix = static_cast<size_t>(w) * cinfo.output_height;
    for (size_t i = 0; i < npix; ++i) {
      uint8_t t = out[i * 3];
      out[i * 3] = out[i * 3 + 2];
      out[i * 3 + 2] = t;
    }
  }
  return 0;
}

}  // extern "C"
