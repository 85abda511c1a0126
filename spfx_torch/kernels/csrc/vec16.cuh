// 16-byte vectors of float (float4) and double (double2), for kernels that
// move rows between device memory, shared memory and registers four or
// two values at a time. Included by getrf_inv.cu and syrk_gemm.cu.

#pragma once

#include <cuda_runtime.h>

template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void get(float4 v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static float4 make(const float* o) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void get(double2 v, double* o) { o[0] = v.x; o[1] = v.y; }
  __device__ static double2 make(const double* o) {
    return make_double2(o[0], o[1]);
  }
};
