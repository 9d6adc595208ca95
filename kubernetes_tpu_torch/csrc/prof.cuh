// Clock stamps of the scans' profiling instances (K2, K9).
//
// A profiling instance is a template instance of a scan with PROF set; its
// launcher takes it only when the caller passes a stamp buffer (the
// parameter block's `prof`, else null), which chip_smoke.py's kernel phase
// alone does. One thread (thread 0 of the block, of CTA 0 in a cluster)
// writes the SM clock at fixed points of every prof_every-th step (pod or
// entry), KTPU_PROF_SLOTS stamps a sampled step, so the difference of two
// stamps is the time the block spent in the phase between them. The
// other instances compile no stamp.
#pragma once

#include <cuda_runtime.h>

#define KTPU_PROF_SLOTS 8

// Stamp slot s of `step`. `dep` is a value the phase before the stamp
// produced: the branch on it issues after the value arrived, so the stamp
// cannot pass a load the phase still waits for.
__device__ __forceinline__ void ktpu_prof_stamp(long long* prof, int every,
                                                int step, int s,
                                                int dep = 0) {
  if (step % every != 0) return;
  long long* row = prof + (size_t)(step / every) * KTPU_PROF_SLOTS;
  if (dep == 0x7fffffff) row[KTPU_PROF_SLOTS - 1] = -1;
  row[s] = clock64();
}
