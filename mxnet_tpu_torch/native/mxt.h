// mxnet_tpu_torch's copy of mxnet_tpu/native/mxtpu.h: the same code with its C
// symbols prefixed MXT (not MXTPU), so both packages' libraries can be
// loaded into one process.
//
// mxt native runtime — C ABI surface.
//
// TPU-native re-design of the reference's native runtime layer
// (reference include/mxnet/engine.h:59-229, src/engine/threaded_engine.h,
// dmlc-core recordio):  the XLA runtime owns device-side scheduling, so this
// engine is the *host-side* concurrency authority — it orders IO, data
// pipeline stages, checkpoint writes, kvstore host ops and Python callbacks
// with the same read/write-variable dependency semantics the reference uses
// for every NDArray mutation.
#ifndef MXT_H_
#define MXT_H_

#include <cstdint>

#if defined(_WIN32)
#define MXT_API __declspec(dllexport)
#else
#define MXT_API __attribute__((visibility("default")))
#endif

extern "C" {

typedef void (*mxt_engine_cb)(void* payload);

// ---- engine ----
// engine_type: 0 = naive (synchronous, debugging), 1 = threaded pool.
MXT_API void* MXTEngineCreate(int engine_type, int num_workers);
MXT_API void MXTEngineShutdown(void* handle);
MXT_API uint64_t MXTEngineNewVar(void* handle);
// Deletion is dependency-safe: performed after all pending ops on the var.
MXT_API void MXTEngineDeleteVar(void* handle, uint64_t var);
// Returns 0 on success, -1 on error (duplicate vars across lists).
MXT_API int MXTEnginePushAsync(void* handle, mxt_engine_cb cb,
                                   void* payload, const uint64_t* const_vars,
                                   int n_const, const uint64_t* mutable_vars,
                                   int n_mutable, int priority,
                                   const char* opr_name);
MXT_API void MXTEngineWaitForVar(void* handle, uint64_t var);
MXT_API void MXTEngineWaitForAll(void* handle);
MXT_API int MXTEngineNumPending(void* handle);
MXT_API const char* MXTEngineLastError(void* handle);

// ---- profiler (chrome://tracing traceEvents) ----
// state: 0 = stop, 1 = run.  Dump returns a malloc'd JSON string.
MXT_API void MXTProfilerSetState(void* handle, int state);
MXT_API char* MXTProfilerDump(void* handle);

// ---- recordio ----
MXT_API void* MXTRecordIOWriterCreate(const char* path);
MXT_API int MXTRecordIOWriterWrite(void* handle, const char* data,
                                       uint64_t len);
MXT_API uint64_t MXTRecordIOWriterTell(void* handle);
MXT_API void MXTRecordIOWriterClose(void* handle);

MXT_API void* MXTRecordIOReaderCreate(const char* path);
// Returns 1 if a record was read, 0 on EOF, -1 on corrupt stream.
// *out is malloc'd; free with MXTFree.
MXT_API int MXTRecordIOReaderRead(void* handle, char** out,
                                      uint64_t* out_len);
MXT_API void MXTRecordIOReaderSeek(void* handle, uint64_t pos);
MXT_API uint64_t MXTRecordIOReaderTell(void* handle);
MXT_API void MXTRecordIOReaderClose(void* handle);

MXT_API void MXTFree(void* ptr);

}  // extern "C"

#endif  // MXT_H_
