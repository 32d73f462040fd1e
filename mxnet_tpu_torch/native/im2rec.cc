// mxnet_tpu_torch's copy of mxnet_tpu/native/im2rec.cc: the same code with its C
// symbols prefixed MXT (not MXTPU), so both packages' libraries can be
// loaded into one process.
//
// Native-speed im2rec: pack an image list into RecordIO.
//
// TPU-native analog of the reference tools/im2rec.cc (its OpenCV
// multithreaded packer): worker threads read+transcode images (libjpeg
// decode -> shorter-edge bilinear resize -> libjpeg encode), a writer
// serializes records in LIST ORDER into the .rec via the framing in
// recordio.cc and emits the .idx (id \t offset) alongside.  Python
// drives it through ctypes (tools/im2rec.py --native); the pure-Python
// path stays as the portable fallback.
//
// Record payload layout matches mxnet_tpu/recordio.py pack():
//   IRHeader = <u32 flag> <f32 label> <u64 id> <u64 id2>  (little endian)
//   followed by the (possibly transcoded) image bytes.
#include <stdio.h>   // jpeglib.h needs FILE declared first

#include <jpeglib.h>
#include <setjmp.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <condition_variable>
#include <cstdlib>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// from recordio.cc
extern "C" {
void* MXTRecordIOWriterCreate(const char* path);
int MXTRecordIOWriterWrite(void* handle, const char* data, uint64_t len);
uint64_t MXTRecordIOWriterTell(void* handle);
void MXTRecordIOWriterClose(void* handle);
}

namespace {

struct JErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void JErrExit(j_common_ptr cinfo) {
  JErr* e = reinterpret_cast<JErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// full-frame RGB decode (no ROI — im2rec wants the whole image)
bool DecodeFull(const uint8_t* buf, size_t len, std::vector<uint8_t>* rgb,
                int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JErrExit;
  if (setjmp(jerr.jb)) {
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
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb->data() +
        static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// shorter-edge resize, bilinear (reference image.py resize_short ints)
void ResizeShort(const std::vector<uint8_t>& src, int sw, int sh,
                 int target, std::vector<uint8_t>* dst, int* dw, int* dh) {
  if (sw <= sh) {
    *dw = target;
    *dh = static_cast<int>(static_cast<int64_t>(target) * sh / sw);
  } else {
    *dh = target;
    *dw = static_cast<int>(static_cast<int64_t>(target) * sw / sh);
  }
  dst->resize(static_cast<size_t>(*dw) * *dh * 3);
  const float fx = static_cast<float>(sw) / *dw;
  const float fy = static_cast<float>(sh) / *dh;
  for (int y = 0; y < *dh; ++y) {
    float syf = (y + 0.5f) * fy - 0.5f;
    int y0 = static_cast<int>(syf);
    if (y0 < 0) y0 = 0;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = syf - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < *dw; ++x) {
      float sxf = (x + 0.5f) * fx - 0.5f;
      int x0 = static_cast<int>(sxf);
      if (x0 < 0) x0 = 0;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = sxf - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v =
            (1 - wy) * ((1 - wx) * src[(static_cast<size_t>(y0) * sw + x0) * 3 + c] +
                        wx * src[(static_cast<size_t>(y0) * sw + x1) * 3 + c]) +
            wy * ((1 - wx) * src[(static_cast<size_t>(y1) * sw + x0) * 3 + c] +
                  wx * src[(static_cast<size_t>(y1) * sw + x1) * 3 + c]);
        int q = static_cast<int>(v + 0.5f);
        (*dst)[(static_cast<size_t>(y) * *dw + x) * 3 + c] =
            static_cast<uint8_t>(q < 0 ? 0 : (q > 255 ? 255 : q));
      }
    }
  }
}

bool EncodeJpeg(const std::vector<uint8_t>& rgb, int w, int h, int quality,
                std::vector<uint8_t>* out) {
  jpeg_compress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JErrExit;
  // volatile: assigned between setjmp and a potential longjmp — without
  // it the error path would free an indeterminate pointer (C11 7.13.2.1)
  unsigned char* volatile mem = nullptr;
  unsigned long mem_len = 0;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, const_cast<unsigned char**>(&mem), &mem_len);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb.data() + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  out->assign(mem, mem + mem_len);
  free(mem);
  return true;
}

struct Item {
  uint64_t id;
  float label;
  std::string path;
};

struct Result {
  bool ok;
  std::vector<uint8_t> record;   // IRHeader + payload
};

bool ReadFile(const std::string& path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) { fclose(f); return false; }
  out->resize(static_cast<size_t>(n));
  bool ok = n == 0 || fread(out->data(), 1, static_cast<size_t>(n), f) ==
      static_cast<size_t>(n);
  fclose(f);
  return ok;
}

void BuildRecord(const Item& it, const std::vector<uint8_t>& payload,
                 std::vector<uint8_t>* rec) {
  rec->resize(24 + payload.size());
  uint32_t flag = 0;
  memcpy(rec->data(), &flag, 4);
  memcpy(rec->data() + 4, &it.label, 4);
  uint64_t id = it.id, id2 = 0;
  memcpy(rec->data() + 8, &id, 8);
  memcpy(rec->data() + 16, &id2, 8);
  memcpy(rec->data() + 24, payload.data(), payload.size());
}

bool IsJpeg(const std::vector<uint8_t>& b) {
  return b.size() > 3 && b[0] == 0xFF && b[1] == 0xD8;
}

}  // namespace

extern "C" int MXTIm2Rec(const char* lst_path, const char* root,
                           const char* rec_path, const char* idx_path,
                           int resize, int quality, int nthreads,
                           int pass_through, uint64_t* out_packed,
                           uint64_t* out_skipped) {
  // ---- parse the list -------------------------------------------------
  std::vector<Item> items;
  {
    FILE* f = fopen(lst_path, "r");
    if (!f) return -1;
    char line[65536];
    while (fgets(line, sizeof(line), f)) {
      // idx \t label... \t path  (path = last field, label = second)
      std::vector<char*> fields;
      char* save = nullptr;
      for (char* tok = strtok_r(line, "\t\n", &save); tok;
           tok = strtok_r(nullptr, "\t\n", &save)) {
        fields.push_back(tok);
      }
      if (fields.size() < 3) continue;
      Item it;
      it.id = strtoull(fields[0], nullptr, 10);
      it.label = strtof(fields[1], nullptr);
      std::string p = fields.back();
      if (root && root[0] && p[0] != '/') {
        it.path = std::string(root) + "/" + p;
      } else {
        it.path = p;
      }
      items.push_back(std::move(it));
    }
    fclose(f);
  }

  void* writer = MXTRecordIOWriterCreate(rec_path);
  if (!writer) return -2;
  FILE* idx = fopen(idx_path, "w");
  if (!idx) { MXTRecordIOWriterClose(writer); return -3; }

  // ---- pipeline: workers transcode, writer drains in order ------------
  std::mutex mu;
  std::condition_variable cv;
  std::map<size_t, Result> done;
  size_t next_in = 0;     // next index to claim (under mu)
  size_t next_out = 0;    // writer's cursor (under mu)
  std::atomic<uint64_t> skipped{0};
  std::atomic<bool> abort_all{false};
  const size_t n = items.size();
  const size_t max_inflight = static_cast<size_t>(nthreads) * 8 + 8;

  auto worker = [&]() {
    for (;;) {
      size_t i;
      {
        // backpressure at CLAIM time: a worker may only take an item
        // within max_inflight of the writer's cursor, so depositing a
        // finished item never blocks and the item the in-order writer
        // needs next is always claimable (no deadlock)
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return abort_all.load() || next_in >= n ||
                 next_in < next_out + max_inflight;
        });
        if (abort_all.load() || next_in >= n) return;
        i = next_in++;
      }
      Result r;
      r.ok = false;
      std::vector<uint8_t> raw;
      if (ReadFile(items[i].path, &raw) && !raw.empty()) {
        if (pass_through || !IsJpeg(raw)) {
          // pack source bytes untouched (non-JPEG sources are always
          // passed through; the python path transcodes them via cv2)
          BuildRecord(items[i], raw, &r.record);
          r.ok = true;
        } else {
          std::vector<uint8_t> rgb;
          int w = 0, h = 0;
          if (DecodeFull(raw.data(), raw.size(), &rgb, &w, &h)) {
            std::vector<uint8_t> enc;
            if (resize > 0 && (w < h ? w : h) != resize) {
              std::vector<uint8_t> rs;
              int rw = 0, rh = 0;
              ResizeShort(rgb, w, h, resize, &rs, &rw, &rh);
              r.ok = EncodeJpeg(rs, rw, rh, quality, &enc);
            } else {
              r.ok = EncodeJpeg(rgb, w, h, quality, &enc);
            }
            if (r.ok) BuildRecord(items[i], enc, &r.record);
          }
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      done.emplace(i, std::move(r));
      cv.notify_all();
    }
  };

  int nt = nthreads > 0 ? nthreads : 1;
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(nt));
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);

  uint64_t packed = 0;
  int rc = 0;
  for (size_t i = 0; i < n; ++i) {
    Result r;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return done.count(i) != 0; });
      r = std::move(done[i]);
      done.erase(i);
      next_out = i + 1;
      cv.notify_all();
    }
    if (!r.ok) {
      skipped.fetch_add(1);
      continue;
    }
    uint64_t pos = MXTRecordIOWriterTell(writer);
    if (MXTRecordIOWriterWrite(
            writer, reinterpret_cast<const char*>(r.record.data()),
            r.record.size()) != 0) {
      rc = -4;
      break;
    }
    fprintf(idx, "%llu\t%llu\n",
            static_cast<unsigned long long>(items[i].id),
            static_cast<unsigned long long>(pos));
    ++packed;
  }

  abort_all.store(true);
  cv.notify_all();
  for (auto& t : pool) t.join();
  fclose(idx);
  MXTRecordIOWriterClose(writer);
  if (out_packed) *out_packed = packed;
  if (out_skipped) *out_skipped = skipped.load();
  return rc;
}
