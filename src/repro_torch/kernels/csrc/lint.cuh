// Launch notes for the kernel lint (analysis/kernel_lint.py).  While the
// lint records (<lib>_lint_record(1)), every launch site of the library notes
// the kernel it launches, its block size and its dynamic shared memory; the
// lint then reads each note back with the kernel's attributes
// (cudaFuncGetAttributes) and its resident blocks an SM at that launch
// configuration (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Recording
// is off unless the lint turns it on: a note is then one branch on the host.
// Included by every source (tc.cuh includes it); each library exports its
// own <lib>_lint_* functions through LINT_EXPORTS.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace lint {

struct Note {
  const void* fn;
  const char* name;
  int variant;        // the template arguments, encoded by the launch site
  int threads;
  size_t smem;        // dynamic shared memory of the launch
};
constexpr int kMaxNotes = 1024;
static Note notes[kMaxNotes];
static int count = 0;   // notes taken; those past kMaxNotes are not kept
static bool on = false;

template <typename F>
inline void note(F* fn, const char* name, int variant, dim3 block,
                 size_t smem) {
  if (!on) return;
  if (count < kMaxNotes)
    notes[count] = Note{(const void*)fn, name, variant,
                        (int)(block.x * block.y * block.z), smem};
  ++count;
}

// out: registers a thread, static shared bytes, dynamic shared bytes of the
// launch, the opted-in dynamic limit, local (spill) bytes a thread, the
// kernel's thread limit, resident blocks an SM, threads a block, variant
inline int attrs(int i, long long* out) {
  if (i < 0 || i >= count || i >= kMaxNotes) return (int)cudaErrorInvalidValue;
  const Note& n = notes[i];
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, n.fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, n.fn, n.threads,
                                                    n.smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (long long)a.sharedSizeBytes;
  out[2] = (long long)n.smem;
  out[3] = a.maxDynamicSharedSizeBytes;
  out[4] = (long long)a.localSizeBytes;
  out[5] = a.maxThreadsPerBlock;
  out[6] = blocks;
  out[7] = n.threads;
  out[8] = n.variant;
  return 0;
}

}  // namespace lint

#define LINT_EXPORTS(lib)                                                   \
  extern "C" int lib##_lint_record(int enable) {                            \
    lint::on = enable != 0;                                                 \
    if (lint::on) lint::count = 0;                                          \
    return 0;                                                               \
  }                                                                         \
  extern "C" int lib##_lint_count() { return lint::count; }                 \
  extern "C" const char* lib##_lint_name(int i) {                           \
    return i >= 0 && i < lint::count && i < lint::kMaxNotes                 \
               ? lint::notes[i].name                                        \
               : "";                                                        \
  }                                                                         \
  extern "C" int lib##_lint_attrs(int i, long long* out) {                  \
    return lint::attrs(i, out);                                             \
  }
