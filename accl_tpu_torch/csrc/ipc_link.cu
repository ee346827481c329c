// CUDA IPC for the multi-process DCN link: one process's receive region
// mapped into a peer process on the same card, and the interprocess
// events that order a hop's two copies.
//
// Replaces no TPU kernel. On a TPU pod the reference's hop between hosts
// is moved by the device runtime (XLA routes a lax.ppermute that crosses
// hosts over DCN; accl_tpu/device/dcn_device.py:7-10) and the host only
// issues the program. The port's counterpart on one card is a device copy
// into a region the peer process has mapped. This file holds no kernel:
// only the runtime calls that export, map and release such a region, the
// events, and the copy itself (cudaMemcpyAsync on the caller's stream).
// accl_tpu_torch/device/ipc_arena.py binds it with ctypes, and
// accl_tpu_torch/ops/_build.py builds it into accl_tpu_torch/_build/ at
// first use.
//
// Bound: bytes. A hop moves its message twice through device memory: the
// sender's copy into the peer's slot and the receiver's copy out of it
// (2 reads and 2 writes of the message).
//
// Every entry returns a cudaError_t (0 on success). Only alloc and free
// may synchronise, and the link calls them at connect, on growth and at
// close only. Each call first selects the device it is
// given: this library carries its own runtime, whose current device is
// not PyTorch's.

#include <cuda_runtime.h>

namespace {

inline cudaError_t on(int device) { return cudaSetDevice(device); }

}  // namespace

extern "C" {

int accl_ipc_handle_bytes() {
  static_assert(sizeof(cudaIpcMemHandle_t) == sizeof(cudaIpcEventHandle_t),
                "one handle size for regions and events");
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// a region of its own cudaMalloc, so that its handle maps exactly it (its
// bytes are not cleared: a slot is always written before it is read)
int accl_ipc_alloc(int device, long long bytes, void** ptr) {
  if (bytes < 1) return cudaErrorInvalidValue;
  cudaError_t e = on(device);
  return e != cudaSuccess ? e : cudaMalloc(ptr, static_cast<size_t>(bytes));
}

int accl_ipc_free(int device, void* ptr) {
  cudaError_t e = on(device);
  return e != cudaSuccess ? e : cudaFree(ptr);
}

int accl_ipc_mem_handle(int device, void* ptr, void* handle) {
  cudaError_t e = on(device);
  if (e != cudaSuccess) return e;
  return cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr);
}

// a peer's region; cudaIpcOpenMemHandle refuses a handle of this process
int accl_ipc_open_mem(int device, const void* handle, void** ptr) {
  cudaError_t e = on(device);
  if (e != cudaSuccess) return e;
  return cudaIpcOpenMemHandle(
      ptr, *static_cast<const cudaIpcMemHandle_t*>(handle),
      cudaIpcMemLazyEnablePeerAccess);
}

int accl_ipc_close_mem(int device, void* ptr) {
  cudaError_t e = on(device);
  return e != cudaSuccess ? e : cudaIpcCloseMemHandle(ptr);
}

int accl_ipc_event_create(int device, void** event) {
  cudaError_t e = on(device);
  if (e != cudaSuccess) return e;
  return cudaEventCreateWithFlags(
      reinterpret_cast<cudaEvent_t*>(event),
      cudaEventDisableTiming | cudaEventInterprocess);
}

int accl_ipc_event_handle(int device, void* event, void* handle) {
  cudaError_t e = on(device);
  if (e != cudaSuccess) return e;
  return cudaIpcGetEventHandle(static_cast<cudaIpcEventHandle_t*>(handle),
                               static_cast<cudaEvent_t>(event));
}

int accl_ipc_open_event(int device, const void* handle, void** event) {
  cudaError_t e = on(device);
  if (e != cudaSuccess) return e;
  return cudaIpcOpenEventHandle(
      reinterpret_cast<cudaEvent_t*>(event),
      *static_cast<const cudaIpcEventHandle_t*>(handle));
}

int accl_ipc_event_destroy(int device, void* event) {
  cudaError_t e = on(device);
  return e != cudaSuccess ? e
                          : cudaEventDestroy(static_cast<cudaEvent_t>(event));
}

int accl_ipc_record(int device, void* event, void* stream) {
  cudaError_t e = on(device);
  if (e != cudaSuccess) return e;
  return cudaEventRecord(static_cast<cudaEvent_t>(event),
                         static_cast<cudaStream_t>(stream));
}

int accl_ipc_wait(int device, void* event, void* stream) {
  cudaError_t e = on(device);
  if (e != cudaSuccess) return e;
  return cudaStreamWaitEvent(static_cast<cudaStream_t>(stream),
                             static_cast<cudaEvent_t>(event), 0);
}

int accl_ipc_copy(int device, void* dst, const void* src, long long bytes,
                  void* stream) {
  if (bytes < 0) return cudaErrorInvalidValue;
  cudaError_t e = on(device);
  if (e != cudaSuccess) return e;
  return cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes),
                         cudaMemcpyDeviceToDevice,
                         static_cast<cudaStream_t>(stream));
}

const char* accl_ipc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
