// The ResNet stem's 3x3 / stride 2 / pad 1 max pool (torch
// MaxPool2d(3, 2, 1)) on NCHW float32, and its equality-routed
// backward.
//
// Replaces the Pallas TPU kernels of depthmodelhardening_tpu/ops/
// pallas_pool.py: _fwd_kernel (:63) by maxpool3x3s2_fwd and _bwd_kernel
// (:77) by maxpool3x3s2_bwd. Those work on the TPU's f=4 width-packed
// stem layout; the function is the same on the plain layout here.
//
// Padding is -inf, as in flax nn.max_pool and torch. Tie rule of the
// backward (the TPU kernel's): every input bit-equal to the max of a
// window that covers it receives that window's full cotangent, so a tie
// duplicates the mass. After a relu every tied zero has a zero
// cotangent upstream, so the model's input gradient does not depend on
// the rule.
//
// What bounds it on an H100: bytes (one read of x and one write of y
// forward; one read of x and g and one write of dx backward; no
// arithmetic to speak of). The forward is one thread per output, with
// neighbouring threads on neighbouring output columns. The backward is
// the gather form, one thread per input element: it visits the <= 2x2
// windows that cover the element, recomputes each window's max from x
// (the nine reads of a window hit L1/L2, shared with the neighbouring
// threads), and adds g where the element equals it. No atomics, so the
// result is deterministic, and windows are visited in the same order
// (row-major over (oy, ox)) as the plain version (ops/pool.py) adds
// them, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float window_max(const float* __restrict__ p,
                                            int H, int W, int oy, int ox) {
  float m = -CUDART_INF_F;
  for (int dy = -1; dy <= 1; ++dy) {
    const int h = 2 * oy + dy;
    if (h < 0 || h >= H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int w = 2 * ox + dx;
      if (w < 0 || w >= W) continue;
      m = fmaxf(m, p[(long long)h * W + w]);
    }
  }
  return m;
}

__global__ void pool_fwd(const float* __restrict__ x, float* __restrict__ y,
                         long long planes, int H, int W, int Ho, int Wo) {
  const long long n = planes * Ho * Wo;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ox = (int)(i % Wo);
  const long long t = i / Wo;
  const int oy = (int)(t % Ho);
  const long long plane = t / Ho;
  y[i] = window_max(x + plane * H * W, H, W, oy, ox);
}

__global__ void pool_bwd(const float* __restrict__ x,
                         const float* __restrict__ g,
                         float* __restrict__ dx, long long planes, int H,
                         int W, int Ho, int Wo) {
  const long long n = planes * H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = (int)(i % W);
  const long long t = i / W;
  const int h = (int)(t % H);
  const long long plane = t / H;
  const float* xp = x + plane * H * W;
  const float* gp = g + plane * Ho * Wo;
  const float v = x[i];
  // windows covering row h: oy in [h >> 1, (h + 1) >> 1], within [0, Ho)
  const int oy0 = h >> 1, oy1 = min((h + 1) >> 1, Ho - 1);
  const int ox0 = w >> 1, ox1 = min((w + 1) >> 1, Wo - 1);
  float acc = 0.0f;
  for (int oy = oy0; oy <= oy1; ++oy) {
    for (int ox = ox0; ox <= ox1; ++ox) {
      if (v == window_max(xp, H, W, oy, ox)) {
        acc += gp[(long long)oy * Wo + ox];
      }
    }
  }
  dx[i] = acc;
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int maxpool3x3s2_fwd(const float* x, float* y, int B, int C,
                                int H, int W, int Ho, int Wo,
                                cudaStream_t stream) {
  const long long planes = (long long)B * C;
  const long long n = planes * Ho * Wo;
  if (n > 0) {
    pool_fwd<<<blocks_for(n), kThreads, 0, stream>>>(x, y, planes, H, W, Ho,
                                                     Wo);
  }
  return (int)cudaGetLastError();
}

extern "C" int maxpool3x3s2_bwd(const float* x, const float* g, float* dx,
                                int B, int C, int H, int W, int Ho, int Wo,
                                cudaStream_t stream) {
  const long long planes = (long long)B * C;
  const long long n = planes * H * W;
  if (n > 0) {
    pool_bwd<<<blocks_for(n), kThreads, 0, stream>>>(x, g, dx, planes, H, W,
                                                     Ho, Wo);
  }
  return (int)cudaGetLastError();
}
