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
// columns, so the loads coalesce) and writes C outputs.
//
// The backward is the gather form, one thread per (b, k, x) on a
// (x, k, b) grid, reading g only at the tile rows whose taps hit k: no
// atomics, so it is deterministic. Looping over all TH rows to find
// them cost TH floor-and-compare steps a thread for about 2 hits at the
// attack's slopes (A >= 0.9) and ran at 3% of the byte bound. Row y
// hits k iff floor(sy) is k - 1 or k, i.e. sy in [k - 1, k + 1), so for
// A != 0 y lies between e1 = (k - 1 - B) / A and e2 = (k + 1 - B) / A.
// The kernel loops over [min(e1, e2) - m, max(e1, e2) + m], clamped to
// [0, TH), with m = 1 + err / |A| rows, err = 2^-20 (|A| TH + |B| + k
// + 2): the computed sy = fl(fl(A y) + B) is within 2^-23 (|A| TH + |B|)
// of A y + B, and e1, e2 within 2^-23 (k + 1 + |B|) / |A| of theirs, so
// m holds both four times over, plus a row for the floor. Inside the
// interval each row keeps the exact test (recompute sy, floorf, compare
// with k) and rows are walked upwards, so the weights and the order of
// the sum are those of the full loop bit for bit. Where the interval is
// not finite (A = 0, or A so small that err / |A| overflows) the kernel
// loops over all TH rows; a tiny A gives an interval that spans them
// anyway. The channel loops are unrolled to kMaxChannels, so the
// accumulators stay in registers (a loop to C put them on the stack).
// Index math is 32-bit; the entry point refuses tensors of 2^31
// elements or more and grids past 65535 object rows or batches.
// Built with -fmad=false, so sy and the weights round exactly as the
// plain PyTorch version (ops/warp.py) rounds them.

#include <climits>

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

// The tile rows [y0, y1) that can hit object row k (see the note above;
// tests/test_torch_warp.py holds its float32 mirror).
__device__ __forceinline__ void candidate_rows(float a, float bb, float kf,
                                               int TH, int& y0, int& y1) {
  const float e1 = (kf - 1.0f - bb) / a;
  const float e2 = (kf + 1.0f - bb) / a;
  const float err = 0x1p-20f * (fabsf(a) * (float)TH + fabsf(bb) + kf + 2.0f);
  const float m = 1.0f + err / fabsf(a);
  const float lo = fminf(e1, e2) - m, hi = fmaxf(e1, e2) + m;
  if (isfinite(lo) && isfinite(hi)) {
    y0 = (int)fminf(fmaxf(floorf(lo), 0.0f), (float)TH);
    y1 = (int)fminf(fmaxf(floorf(hi) + 1.0f, 0.0f), (float)TH);
  } else {
    y0 = 0;
    y1 = TH;
  }
}

// Grid (ceil(TW / kThreads), OH, Bn).
__global__ void vert_bwd(const float* __restrict__ g,
                         const float* __restrict__ A,
                         const float* __restrict__ B,
                         float* __restrict__ d_inter,
                         int C, int OH, int TH, int TW) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= TW) return;
  const int k = blockIdx.y, b = blockIdx.z;

  const float a = A[b * TW + x];
  const float bb = B[b * TW + x];
  const float kf = (float)k;
  int y0, y1;
  candidate_rows(a, bb, kf, TH, y0, y1);
  // channel loops unrolled to kMaxChannels, so acc stays in registers
  float acc[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;

  const float* gb = g + b * C * TH * TW + x;
  for (int y = y0; y < y1; ++y) {
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
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < C) acc[c] += gb[(c * TH + y) * TW] * w;
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < C) d_inter[((b * C + c) * OH + k) * TW + x] = acc[c];
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
  if (Bn <= 0 || OH <= 0 || TW <= 0) return (int)cudaGetLastError();
  constexpr long long kMaxGrid = 65535;  // the grid's y and z limits
  const long long rows = (long long)Bn * C * (TH > OH ? TH : OH);
  if (Bn > kMaxGrid || OH > kMaxGrid || rows * TW > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((TW + kThreads - 1) / kThreads, OH, Bn);
  vert_bwd<<<grid, kThreads, 0, stream>>>(g, A, B, d_inter, C, OH, TH, TW);
  return (int)cudaGetLastError();
}
