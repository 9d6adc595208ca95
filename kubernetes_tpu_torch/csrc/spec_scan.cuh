// K12's parameter block, which both of its designs take (spec_scan.cu,
// the block design; spec_scan_cluster.cu, the cluster design).
#pragma once

#include "class_step.cuh"

// K12's parameter block: K2's, then the cohort fields (kernels/
// speculative.py _SpecParams; ctypes lays the nested Structure out as C
// does). The scratch is the block design's; the cluster design keeps its
// cohort in shared memory.
struct KtpuSpecParams {
  KtpuScanParams scan;
  const bool* spec_plain;   // [P]      the pod reads no carried term
  int* stats;               // [P / W, 2]
  float* fscratch;          // [W * (2R + 5 + C)]
  int* iscratch;            // [2W]
  int W;                    // cohort width, divides P
  int fscratch_len, iscratch_len;
};
