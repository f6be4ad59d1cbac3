// The point expression of the stepA operator y = -r * L_st(x) + r*eps * x,
// shared by the whole-field kernels and the tile kernels of cg_operator.cu,
// so that a tile's output is bitwise the whole field's at the same points.
//
// Every rounding is spelled out (__fadd_rn, __fmaf_rn, __fmul_rn), so nvcc
// cannot contract or reorder it differently in the two kernels.

#pragma once

#include <cuda_runtime.h>

namespace ofot {

// One axis of the 'N' Laplacian at a point: c is the point, prev/next its
// neighbours along the axis (read only where they exist).  Row 0 is
// -c + next and the last row -c + prev (reference operators.py:104-108).
__device__ __forceinline__ float lap_n(float c, float prev, float next,
                                       bool first, bool last) {
  if (first) return __fadd_rn(-c, next);
  if (last) return __fadd_rn(-c, prev);
  return __fadd_rn(__fmaf_rn(-2.f, c, next), prev);
}

// The operator at one point, from its six neighbours (each used only where
// it exists) and which global boundaries the point lies on.
__device__ __forceinline__ float apply(float c, float tp, float tn, float xp,
                                      float xn, float yp, float yn, bool t0,
                                      bool t1, bool x0, bool x1, bool y0,
                                      bool y1, float r, float reps) {
  const float lt = lap_n(c, tp, tn, t0, t1);
  const float lx = lap_n(c, xp, xn, x0, x1);
  const float ly = lap_n(c, yp, yn, y0, y1);
  // the order of laplacian_st: t, then x, then y
  return __fmaf_rn(reps, c, __fmul_rn(-r, __fadd_rn(__fadd_rn(lt, lx), ly)));
}

}  // namespace ofot
