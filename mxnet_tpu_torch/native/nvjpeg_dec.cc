// JPEG decode on the card with nvJPEG (the CUDA toolkit's decoder), for
// hosts whose native library has no libjpeg: the native image route then
// decodes each record here into device planes the caller owns (torch
// tensors): the coded YCbCr planes, which the caller upsamples and
// converts to RGB with libjpeg's arithmetic (fancy upsampling, its
// fixed-point color conversion) in torch ops on the same stream, then
// crops and normalizes (mxnet_tpu_torch/image.py, _NvjpegDecoder).  Where
// libjpeg exists the libjpeg pipeline (imagedec.cc) is used and this
// library is not built.
//
// Built with g++ against the toolkit's headers into its own library
// (libmxt_nvjpeg-<digest>.so, -lnvjpeg); it calls no CUDA runtime function
// itself: the stream comes from the caller.
#include <cstdint>
#include <new>

#include <nvjpeg.h>

#if defined(_WIN32)
#define MXT_API __declspec(dllexport)
#else
#define MXT_API __attribute__((visibility("default")))
#endif

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

}  // namespace

extern "C" {

// Returns a decoder, or null when nvJPEG cannot start (no device).
MXT_API void* MXTNvjpegCreate() {
  Decoder* d = new (std::nothrow) Decoder();
  if (d == nullptr) return nullptr;
  if (nvjpegCreateSimple(&d->handle) != NVJPEG_STATUS_SUCCESS) {
    delete d;
    return nullptr;
  }
  if (nvjpegJpegStateCreate(d->handle, &d->state) != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(d->handle);
    delete d;
    return nullptr;
  }
  return d;
}

MXT_API void MXTNvjpegDestroy(void* handle) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (d == nullptr) return;
  if (d->state != nullptr) nvjpegJpegStateDestroy(d->state);
  if (d->handle != nullptr) nvjpegDestroy(d->handle);
  delete d;
}

// Components, chroma subsampling (0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0,
// 3 = grayscale, 4 = another) and each component's plane size of a JPEG;
// returns the nvjpegStatus_t (0 = success).
MXT_API int MXTNvjpegInfo(void* handle, const uint8_t* buf, uint64_t len,
                          int* ncomp, int* subsampling, int* heights,
                          int* widths) {
  Decoder* d = static_cast<Decoder*>(handle);
  nvjpegChromaSubsampling_t sub;
  int w[NVJPEG_MAX_COMPONENT] = {0};
  int h[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t st = nvjpegGetImageInfo(
      d->handle, buf, static_cast<size_t>(len), ncomp, &sub, w, h);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  for (int c = 0; c < 3; ++c) {
    heights[c] = h[c];
    widths[c] = w[c];
  }
  switch (sub) {
    case NVJPEG_CSS_444: *subsampling = 0; break;
    case NVJPEG_CSS_422: *subsampling = 1; break;
    case NVJPEG_CSS_420: *subsampling = 2; break;
    case NVJPEG_CSS_GRAY: *subsampling = 3; break;
    default: *subsampling = 4;
  }
  return 0;
}

// Decode into device planes the caller owns, enqueued on `stream`:
// format 0 = the YCbCr planes as coded (chroma not upsampled; p0, p1, p2),
// 1 = the luma plane alone (p0), 2 = interleaved RGB (p0, nvJPEG's own
// upsampling and color conversion).  Returns the nvjpegStatus_t.
MXT_API int MXTNvjpegDecode(void* handle, const uint8_t* buf, uint64_t len,
                            int format, uint8_t* p0, uint64_t pitch0,
                            uint8_t* p1, uint64_t pitch1, uint8_t* p2,
                            uint64_t pitch2, void* stream) {
  Decoder* d = static_cast<Decoder*>(handle);
  nvjpegImage_t out;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    out.channel[c] = nullptr;
    out.pitch[c] = 0;
  }
  out.channel[0] = p0;
  out.pitch[0] = static_cast<size_t>(pitch0);
  out.channel[1] = p1;
  out.pitch[1] = static_cast<size_t>(pitch1);
  out.channel[2] = p2;
  out.pitch[2] = static_cast<size_t>(pitch2);
  nvjpegOutputFormat_t fmt = format == 0 ? NVJPEG_OUTPUT_YUV
                             : format == 1 ? NVJPEG_OUTPUT_Y
                                           : NVJPEG_OUTPUT_RGBI;
  return static_cast<int>(nvjpegDecode(
      d->handle, d->state, buf, static_cast<size_t>(len), fmt, &out,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
