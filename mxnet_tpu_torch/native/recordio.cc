// mxnet_tpu_torch's copy of mxnet_tpu/native/recordio.cc: the same code with its C
// symbols prefixed MXT (not MXTPU), so both packages' libraries can be
// loaded into one process.
//
// RecordIO binary stream format — byte-compatible with the reference's
// dmlc-core recordio (reference usage: src/io/iter_image_recordio*.cc,
// python/mxnet/recordio.py), so .rec datasets packed for the reference load
// unmodified here.
//
// Format: each record is framed as
//   [kMagic (4B LE)] [lrecord (4B LE)] [payload (len bytes)] [pad to 4B]
//   lrecord = (cflag << 29) | length,  cflag: 0 = whole record,
//   1 = first part, 2 = middle, 3 = last part.
// A payload containing the magic word at a 4-byte-aligned offset is split at
// that point (the magic bytes are elided and re-inserted by the reader), so
// the magic is a valid resync marker anywhere in the file.
#include "mxt.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace mxt {

static const uint32_t kMagic = 0xced7230a;
static const uint32_t kLenMask = (1U << 29U) - 1U;

inline uint32_t EncodeLRec(uint32_t cflag, uint32_t length) {
  return (cflag << 29U) | length;
}

class RecordWriter {
 public:
  explicit RecordWriter(const char* path) { fp_ = fopen(path, "wb"); }
  bool ok() const { return fp_ != nullptr; }

  int Write(const char* data, uint64_t size) {
    if (size >= (1ULL << 29U)) return -1;
    const char* magic_bytes = reinterpret_cast<const char*>(&kMagic);
    uint32_t len = static_cast<uint32_t>(size);
    uint32_t lower_align = (len >> 2U) << 2U;
    uint32_t upper_align = ((len + 3U) >> 2U) << 2U;
    uint32_t dptr = 0;
    for (uint32_t i = 0; i < lower_align; i += 4) {
      if (data[i] == magic_bytes[0] && data[i + 1] == magic_bytes[1] &&
          data[i + 2] == magic_bytes[2] && data[i + 3] == magic_bytes[3]) {
        uint32_t lrec = EncodeLRec(dptr == 0 ? 1U : 2U, i - dptr);
        if (fwrite(&kMagic, 4, 1, fp_) != 1) return -1;
        if (fwrite(&lrec, 4, 1, fp_) != 1) return -1;
        if (i != dptr && fwrite(data + dptr, i - dptr, 1, fp_) != 1) return -1;
        dptr = i + 4;
      }
    }
    uint32_t lrec = EncodeLRec(dptr != 0 ? 3U : 0U, len - dptr);
    if (fwrite(&kMagic, 4, 1, fp_) != 1) return -1;
    if (fwrite(&lrec, 4, 1, fp_) != 1) return -1;
    if (len != dptr && fwrite(data + dptr, len - dptr, 1, fp_) != 1) return -1;
    if (upper_align != len) {
      uint32_t zero = 0;
      if (fwrite(&zero, upper_align - len, 1, fp_) != 1) return -1;
    }
    return 0;
  }

  uint64_t Tell() { return static_cast<uint64_t>(ftell(fp_)); }

  ~RecordWriter() {
    if (fp_) fclose(fp_);
  }

 private:
  FILE* fp_ = nullptr;
};

class RecordReader {
 public:
  explicit RecordReader(const char* path) { fp_ = fopen(path, "rb"); }
  bool ok() const { return fp_ != nullptr; }

  // 1 = record read into out, 0 = EOF, -1 = corrupt.
  int Read(std::string* out) {
    out->clear();
    bool in_multipart = false;
    for (;;) {
      uint32_t magic = 0;
      size_t got = fread(&magic, 1, 4, fp_);
      if (got == 0 && !in_multipart) return 0;  // clean EOF
      if (got != 4 || magic != kMagic) return -1;
      uint32_t lrec = 0;
      if (fread(&lrec, 1, 4, fp_) != 4) return -1;
      uint32_t cflag = lrec >> 29U;
      uint32_t len = lrec & kLenMask;
      uint32_t upper_align = ((len + 3U) >> 2U) << 2U;
      size_t base = out->size();
      if (in_multipart) {
        // Re-insert the elided magic between parts.
        out->append(reinterpret_cast<const char*>(&kMagic), 4);
        base = out->size();
      }
      out->resize(base + upper_align);
      if (upper_align &&
          fread(&(*out)[base], 1, upper_align, fp_) != upper_align)
        return -1;
      out->resize(base + len);
      if (cflag == 0) return 1;
      if (cflag == 3) return in_multipart ? 1 : -1;
      if (cflag == 1 && in_multipart) return -1;
      in_multipart = true;
    }
  }

  void Seek(uint64_t pos) { fseek(fp_, static_cast<long>(pos), SEEK_SET); }
  uint64_t Tell() { return static_cast<uint64_t>(ftell(fp_)); }

  ~RecordReader() {
    if (fp_) fclose(fp_);
  }

 private:
  FILE* fp_ = nullptr;
};

}  // namespace mxt

extern "C" {

void* MXTRecordIOWriterCreate(const char* path) {
  auto* w = new mxt::RecordWriter(path);
  if (!w->ok()) {
    delete w;
    return nullptr;
  }
  return w;
}

int MXTRecordIOWriterWrite(void* handle, const char* data, uint64_t len) {
  return static_cast<mxt::RecordWriter*>(handle)->Write(data, len);
}

uint64_t MXTRecordIOWriterTell(void* handle) {
  return static_cast<mxt::RecordWriter*>(handle)->Tell();
}

void MXTRecordIOWriterClose(void* handle) {
  delete static_cast<mxt::RecordWriter*>(handle);
}

void* MXTRecordIOReaderCreate(const char* path) {
  auto* r = new mxt::RecordReader(path);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

int MXTRecordIOReaderRead(void* handle, char** out, uint64_t* out_len) {
  std::string rec;
  int ret = static_cast<mxt::RecordReader*>(handle)->Read(&rec);
  if (ret != 1) {
    *out = nullptr;
    *out_len = 0;
    return ret;
  }
  *out = static_cast<char*>(malloc(rec.size() ? rec.size() : 1));
  memcpy(*out, rec.data(), rec.size());
  *out_len = rec.size();
  return 1;
}

void MXTRecordIOReaderSeek(void* handle, uint64_t pos) {
  static_cast<mxt::RecordReader*>(handle)->Seek(pos);
}

uint64_t MXTRecordIOReaderTell(void* handle) {
  return static_cast<mxt::RecordReader*>(handle)->Tell();
}

void MXTRecordIOReaderClose(void* handle) {
  delete static_cast<mxt::RecordReader*>(handle);
}

}  // extern "C"
