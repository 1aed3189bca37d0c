// Pass 2 of the separable EoT tile warp: a per-column 1-D bilinear
// resample along rows, and its exact transpose.
//
//   out[b,c,y,x]    = sum_k w(y,k) * inter[b,c,k,x]
//   d_inter[b,c,k,x] = sum_y w(y,k) * g[b,c,y,x]
//   sy = A[b,x]*y + B[b,x], k0 = floor(sy), w1 = sy - k0,
//   w(y,k0) = 1 - w1, w(y,k0+1) = w1, zero fill outside [0, OH).
//
// Replaces the Pallas TPU kernels of depthmodelhardening_tpu/ops/
// pallas_warp.py: _vert_fwd_kernel (:39) and _vert_fwd_banded_kernel
// (:132) by vertical_resample_fwd; _vert_bwd_kernel (:63) and
// _vert_bwd_banded_kernel (:163) by vertical_resample_bwd.
//
// What bounds it on an H100: bytes. The TPU kernels sweep every object
// row k for every output row (a dense VPU loop, later cut to static
// 56-row bands); each output here needs only its two taps. The forward
// is one thread per (b, y, x): it computes sy once, reads the two taps
// of each of the C channels (neighbouring threads read neighbouring
// columns, so the loads coalesce) and writes C outputs. The backward is
// the gather form, one thread per (b, k, x), looping over the TH tile
// rows and reading g only at the rows whose taps hit k: no atomics, so
// it is deterministic. The loop costs TH multiply-adds per thread,
// which is well under the time of its memory traffic at the attack's
// shapes, and handles any A (negative, zero or tiny) exactly.
// Built with -fmad=false, so sy and the weights round exactly as the
// plain PyTorch version (ops/warp.py) rounds them.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 8;
constexpr int kThreads = 256;

__global__ void vert_fwd(const float* __restrict__ inter,
                         const float* __restrict__ A,
                         const float* __restrict__ B,
                         float* __restrict__ out,
                         int Bn, int C, int OH, int TH, int TW) {
  const long long n = (long long)Bn * TH * TW;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % TW);
  const long long t = i / TW;
  const int y = (int)(t % TH);
  const int b = (int)(t / TH);

  const float sy = A[(long long)b * TW + x] * (float)y
                   + B[(long long)b * TW + x];
  const float k0f = floorf(sy);
  const float w1 = sy - k0f;
  const float w0 = 1.0f - w1;
  const bool ok0 = k0f >= 0.0f && k0f < (float)OH;
  const bool ok1 = k0f + 1.0f >= 0.0f && k0f + 1.0f < (float)OH;
  const int k0 = ok0 ? (int)k0f : 0;
  const int k1 = ok1 ? (int)k0f + 1 : 0;

  for (int c = 0; c < C; ++c) {
    const float* col = inter + ((long long)(b * C + c) * OH) * TW + x;
    const float t0 = ok0 ? col[(long long)k0 * TW] * w0 : 0.0f;
    const float t1 = ok1 ? col[(long long)k1 * TW] * w1 : 0.0f;
    out[((long long)(b * C + c) * TH + y) * TW + x] = t0 + t1;
  }
}

__global__ void vert_bwd(const float* __restrict__ g,
                         const float* __restrict__ A,
                         const float* __restrict__ B,
                         float* __restrict__ d_inter,
                         int Bn, int C, int OH, int TH, int TW) {
  const long long n = (long long)Bn * OH * TW;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % TW);
  const long long t = i / TW;
  const int k = (int)(t % OH);
  const int b = (int)(t / OH);

  const float a = A[(long long)b * TW + x];
  const float bb = B[(long long)b * TW + x];
  const float kf = (float)k;
  float acc[kMaxChannels];
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int y = 0; y < TH; ++y) {
    const float sy = a * (float)y + bb;
    const float k0f = floorf(sy);
    float w;
    if (k0f == kf) {
      w = 1.0f - (sy - k0f);
    } else if (k0f + 1.0f == kf) {
      w = sy - k0f;
    } else {
      continue;
    }
    for (int c = 0; c < C; ++c) {
      acc[c] += g[((long long)(b * C + c) * TH + y) * TW + x] * w;
    }
  }
  for (int c = 0; c < C; ++c) {
    d_inter[((long long)(b * C + c) * OH + k) * TW + x] = acc[c];
  }
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int vertical_resample_fwd(const float* inter, const float* A,
                                     const float* B, float* out, int Bn,
                                     int C, int OH, int TH, int TW,
                                     cudaStream_t stream) {
  if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
  const long long n = (long long)Bn * TH * TW;
  if (n > 0) {
    vert_fwd<<<blocks_for(n), kThreads, 0, stream>>>(inter, A, B, out, Bn,
                                                     C, OH, TH, TW);
  }
  return (int)cudaGetLastError();
}

extern "C" int vertical_resample_bwd(const float* g, const float* A,
                                     const float* B, float* d_inter, int Bn,
                                     int C, int OH, int TH, int TW,
                                     cudaStream_t stream) {
  if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
  const long long n = (long long)Bn * OH * TW;
  if (n > 0) {
    vert_bwd<<<blocks_for(n), kThreads, 0, stream>>>(g, A, B, d_inter, Bn,
                                                     C, OH, TH, TW);
  }
  return (int)cudaGetLastError();
}
