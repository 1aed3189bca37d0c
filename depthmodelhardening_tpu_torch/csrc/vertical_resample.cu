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
// 56-row bands); each output here needs only its two taps. The first
// forward ran one thread per output (b, y, x), with three 64-bit
// divisions and modulos and 64-bit address math a thread, and every
// thread loaded A[b, x] and B[b, x] again for its one row: at the
// attack's batch 12 it took 0.0134 ms against a 0.0054 ms bound, the
// fixed cost a thread outweighing its 2 C loads and C stores (NVIDIA
// H100 80GB HBM3, 700.00 W). Now a thread owns kFwdCols = 2 adjacent
// columns of one batch item and a strip of kFwdRows consecutive output
// rows, on a grid (ceil(TW / (kFwdCols kFwdThreads)), ceil(TH / (kFwdRows
// kFwdStrips)), Bn) with no division in the kernel and 32-bit index
// math: it loads its A[b, x] and B[b, x] once, computes each row's taps,
// then starts all of the strip's tap loads (rows x channels x columns x
// 2, each guarded by its validity) before its first store, and stores a
// row's two columns as one float2 where TW is even. Neighbouring threads
// read and write neighbouring columns, so loads and stores coalesce. The
// channel loops are unrolled to kMaxChannels with c < C guards, so the
// loaded taps stay in registers; that is also why more rows a thread
// lose: the taps of 8 channels take 2 x 8 registers a row and column, so
// 2, 4 and 8 rows need 95, 173 and 255 registers (the last with a stack)
// against one row's 55, and fewer threads fit an SM. Of the strips
// kernel_variants.py measures, one row on 32 x 4 threads is the fastest
// at the attack's batch 12 and 32; a fill of the output alone
// (out.zero_()) takes 0.0079 ms at batch 12, most of a small call's time
// (NVIDIA H100 80GB HBM3, 700.00 W). The
// arithmetic is the first kernel's: sy = A y + B, floorf, w0 = 1 - w1,
// t0 + t1, so the output equals the plain version's value for value.
// The entry point refuses tensors of 2^31 elements or more and grids
// past 65535 strips or batches.
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
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 8;
constexpr int kThreads = 256;

// The forward's strip: kFwdRows output rows of kFwdCols adjacent
// columns a thread; a block of kFwdThreads x kFwdStrips threads.
constexpr int kFwdRows = 1, kFwdCols = 2, kFwdThreads = 32, kFwdStrips = 4;
static_assert(kFwdCols == 2, "vert_fwd stores a row's columns as a float2");

// Grid (ceil(TW / (kFwdCols kFwdThreads)), ceil(TH / (kFwdRows
// kFwdStrips)), Bn). vec: TW even and out 8-byte aligned, so a thread's
// columns of one output row are one float2.
__global__ void __launch_bounds__(kFwdThreads * kFwdStrips)
vert_fwd(const float* __restrict__ inter, const float* __restrict__ A,
         const float* __restrict__ B, float* __restrict__ out, int C,
         int OH, int TH, int TW, int vec) {
  const int x0 = (blockIdx.x * kFwdThreads + threadIdx.x) * kFwdCols;
  const int y0 = (blockIdx.y * kFwdStrips + threadIdx.y) * kFwdRows;
  const int b = blockIdx.z;
  if (x0 >= TW || y0 >= TH) return;

  // each (row, column) of the strip: its two taps, weights and validity
  float w0[kFwdRows][kFwdCols], w1[kFwdRows][kFwdCols];
  int k0[kFwdRows][kFwdCols], k1[kFwdRows][kFwdCols];
  bool ok0[kFwdRows][kFwdCols], ok1[kFwdRows][kFwdCols];
#pragma unroll
  for (int e = 0; e < kFwdCols; ++e) {
    const bool col = x0 + e < TW;
    const float a = col ? A[b * TW + x0 + e] : 0.0f;
    const float bb = col ? B[b * TW + x0 + e] : 0.0f;
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) {
      const float sy = a * (float)(y0 + r) + bb;
      const float k0f = floorf(sy);
      w1[r][e] = sy - k0f;
      w0[r][e] = 1.0f - w1[r][e];
      const bool in = col && y0 + r < TH;
      ok0[r][e] = in && k0f >= 0.0f && k0f < (float)OH;
      ok1[r][e] = in && k0f + 1.0f >= 0.0f && k0f + 1.0f < (float)OH;
      k0[r][e] = ok0[r][e] ? (int)k0f : 0;
      k1[r][e] = ok1[r][e] ? (int)k0f + 1 : 0;
    }
  }

  // every tap load of the strip before the first store
  const float* src = inter + b * C * OH * TW + x0;
  float v0[kFwdRows][kMaxChannels][kFwdCols];
  float v1[kFwdRows][kMaxChannels][kFwdCols];
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r) {
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
#pragma unroll
      for (int e = 0; e < kFwdCols; ++e) {
        v0[r][c][e] = v1[r][c][e] = 0.0f;
        if (c < C) {
          if (ok0[r][e]) v0[r][c][e] = src[(c * OH + k0[r][e]) * TW + e];
          if (ok1[r][e]) v1[r][c][e] = src[(c * OH + k1[r][e]) * TW + e];
        }
      }
    }
  }
  float* dst = out + b * C * TH * TW + x0;
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r) {
    if (y0 + r >= TH) break;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c >= C) continue;
      float o[kFwdCols];
#pragma unroll
      for (int e = 0; e < kFwdCols; ++e) {
        const float t0 = ok0[r][e] ? v0[r][c][e] * w0[r][e] : 0.0f;
        const float t1 = ok1[r][e] ? v1[r][c][e] * w1[r][e] : 0.0f;
        o[e] = t0 + t1;
      }
      float* d = dst + (c * TH + y0 + r) * TW;
      if (vec) {
        *reinterpret_cast<float2*>(d) = make_float2(o[0], o[1]);
      } else {
#pragma unroll
        for (int e = 0; e < kFwdCols; ++e) {
          if (x0 + e < TW) d[e] = o[e];
        }
      }
    }
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

}  // namespace

extern "C" int vertical_resample_fwd(const float* inter, const float* A,
                                     const float* B, float* out, int Bn,
                                     int C, int OH, int TH, int TW,
                                     cudaStream_t stream) {
  if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
  if (Bn <= 0 || TH <= 0 || TW <= 0) return (int)cudaGetLastError();
  constexpr long long kMaxGrid = 65535;  // the grid's y and z limits
  constexpr int kStripRows = kFwdRows * kFwdStrips;
  constexpr int kBlockCols = kFwdCols * kFwdThreads;
  const long long strips = (TH + kStripRows - 1) / kStripRows;
  const long long rows = (long long)Bn * C * (TH > OH ? TH : OH);
  if (Bn > kMaxGrid || strips > kMaxGrid || rows * TW > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = TW % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const dim3 grid((TW + kBlockCols - 1) / kBlockCols, (unsigned)strips, Bn);
  vert_fwd<<<grid, dim3(kFwdThreads, kFwdStrips), 0, stream>>>(
      inter, A, B, out, C, OH, TH, TW, vec);
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
