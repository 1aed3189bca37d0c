// The photometric reprojection loss of self-supervised depth training,
// per pixel
//   0.85 * mean_c clip((1 - SSIM(x, y)) / 2, 0, 1) + 0.15 * mean_c |x - y|
// with reflect padding 1 and 3x3 mean pools for the five SSIM moments
// (C1 = 0.01^2, C2 = 0.03^2), on planar (B, C, H, W) float32, and its
// analytic backward.
//
// Replaces kernel C of depthmodelhardening_tpu/ops/pallas_reproj.py:
// _make_kernel (:68) / _compute_chunk (:31), called by _pallas_forward
// (:114), by reproj_loss_fwd; and that file's XLA backward _analytic_bwd
// (:172-237) by reproj_loss_bwd_q + reproj_loss_bwd_grad.
//
// What bounds it on an H100: bytes. The forward reads x and y once from
// device memory (the nine taps of each pixel's window hit L1/L2, shared
// with the neighbouring threads) and writes one float per pixel; the
// arithmetic is ~100 flops per pixel and channel. The design is the
// simple one: one thread per pixel, neighbouring threads on
// neighbouring columns, so every load and store is coalesced.
//
// The backward is two gathers, no atomics, so it is deterministic:
// 1. reproj_loss_bwd_q, one thread per output pixel: recompute the five
//    moments, then the derivatives of the pixel's SSIM term with
//    respect to them, q0 (mu_x), q1 (mu_y), q23 (E[x^2] and E[y^2]),
//    q4 (E[xy]), each already divided by 9, into a (B, 4C, H, W)
//    scratch.
// 2. reproj_loss_bwd_grad, one thread per input pixel: the 3x3 mean
//    pool's adjoint (the sum of the <= 9 windows that cover a padded
//    position) at each padded position that reflects onto the pixel
//    (itself, plus its mirror images in padded rows/cols 0 and H+1 /
//    W+1), combined with the pixel's values as u0 + 2x u2 + y u4; then
//    the L1 term.
//
// Tie rules are JAX autodiff's, which the reference gradient follows:
// the clip passes 0.5 at exactly 0 or 1 (x == y gives exactly 0) and
// |.|' is +1 at 0. Every expression keeps the plain version's operand
// order (ops/reproj.py), divisions by 9 and by C are products with the
// rounded reciprocal (as PyTorch's division by a scalar is on the card),
// and the library is built with -fmad=false, so the kernel rounds as the
// plain version does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);
constexpr float kNinth = 1.0f / 9.0f;

// numpy's reflect rule for a pad of 1: -1 -> 1 and n -> n - 2, clamped
// for n == 1 (a single line is its own reflection)
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) return min(1, n - 1);
  if (i >= n) return max(n - 2, 0);
  return i;
}

struct Moments {
  float mx, my, sxx, syy, sxy;  // 3x3 means of x, y, x^2, y^2, xy
};

// The five moments of the window centred on (h, w) of one plane, taps
// summed row by row as the plain version adds its shifted slices.
__device__ __forceinline__ Moments moments(const float* __restrict__ xp,
                                           const float* __restrict__ yp,
                                           int H, int W, int h, int w) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
  for (int dy = -1; dy <= 1; ++dy) {
    const long long row = (long long)reflect(h + dy, H) * W;
    for (int dx = -1; dx <= 1; ++dx) {
      const long long o = row + reflect(w + dx, W);
      const float a = xp[o], b = yp[o];
      s0 = s0 + a;
      s1 = s1 + b;
      s2 = s2 + a * a;
      s3 = s3 + b * b;
      s4 = s4 + a * b;
    }
  }
  return {s0 * kNinth, s1 * kNinth, s2 * kNinth, s3 * kNinth, s4 * kNinth};
}

__global__ void fwd_kernel(const float* __restrict__ x,
                           const float* __restrict__ y,
                           float* __restrict__ out, int B, int C, int H,
                           int W) {
  const long long plane = (long long)H * W;
  const long long n = (long long)B * plane;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = (int)(i % W);
  const int h = (int)((i / W) % H);
  const long long b = i / plane;
  float ssim_sum = 0.0f, l1_sum = 0.0f;
  for (int c = 0; c < C; ++c) {
    const long long base = (b * C + c) * plane;
    const Moments m = moments(x + base, y + base, H, W, h, w);
    const float sigma_x = m.sxx - m.mx * m.mx;
    const float sigma_y = m.syy - m.my * m.my;
    const float sigma_xy = m.sxy - m.mx * m.my;
    const float num = (2.0f * m.mx * m.my + kC1) * (2.0f * sigma_xy + kC2);
    const float den = (m.mx * m.mx + m.my * m.my + kC1) *
                      (sigma_x + sigma_y + kC2);
    const float v = (1.0f - num / den) / 2.0f;
    ssim_sum = ssim_sum + fminf(fmaxf(v, 0.0f), 1.0f);
    const long long o = base + (long long)h * W + w;
    l1_sum = l1_sum + fabsf(x[o] - y[o]);
  }
  const float inv_c = 1.0f / (float)C;
  out[i] = 0.85f * (ssim_sum * inv_c) + 0.15f * (l1_sum * inv_c);
}

__global__ void bwd_q_kernel(const float* __restrict__ x,
                             const float* __restrict__ y,
                             const float* __restrict__ g,
                             float* __restrict__ q, int B, int C, int H,
                             int W, float k_ssim) {
  const long long plane = (long long)H * W;
  const long long n = (long long)B * plane;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long p = i % plane;
  const int w = (int)(p % W);
  const int h = (int)(p / W);
  const long long b = i / plane;
  const float gi = g[i];
  for (int c = 0; c < C; ++c) {
    const long long base = (b * C + c) * plane;
    const Moments m = moments(x + base, y + base, H, W, h, w);
    const float p0 = m.mx, p1 = m.my, p2 = m.sxx, p3 = m.syy, p4 = m.sxy;
    const float A = p0 * p0 + p1 * p1 + kC1;
    const float Bn = 2.0f * p0 * p1 + kC1;
    const float T = (p2 - p0 * p0) + (p3 - p1 * p1) + kC2;
    const float S = 2.0f * (p4 - p0 * p1) + kC2;
    const float d = A * T;
    const float r = (Bn * S) / d;
    const float v = (1.0f - r) / 2.0f;
    const float mask = ((v > 0.0f && v < 1.0f) ? 1.0f : 0.0f) +
                       ((v == 0.0f || v == 1.0f) ? 0.5f : 0.0f);
    const float gm = k_ssim * gi * -0.5f * mask;
    const float rd = r / d;
    const float q0 = gm * (2.0f * p1 * (S - Bn) / d - rd * 2.0f * p0 * (T - A));
    const float q1 = gm * (2.0f * p0 * (S - Bn) / d - rd * 2.0f * p1 * (T - A));
    const float q23 = gm * (-rd * A);
    const float q4 = gm * (2.0f * Bn / d);
    float* qb = q + b * 4 * C * plane + p;
    qb[(0 * C + c) * plane] = q0 * kNinth;
    qb[(1 * C + c) * plane] = q1 * kNinth;
    qb[(2 * C + c) * plane] = q23 * kNinth;
    qb[(3 * C + c) * plane] = q4 * kNinth;
  }
}

// The mean pool's adjoint at padded position (pr, pc) in
// [0, H+2) x [0, W+2): the sum of q over the output windows (h, w) in
// [pr-2, pr] x [pc-2, pc] that lie in the image, in the plain version's
// order (a full correlation with ones(3, 3) on q padded by 2 zeros).
__device__ __forceinline__ float box_adjoint(const float* __restrict__ s,
                                             int H, int W, int pr,
                                             int pc) {
  float acc = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const int h = pr + a - 2;
    if (h < 0 || h >= H) continue;
    for (int bb = 0; bb < 3; ++bb) {
      const int w = pc + bb - 2;
      if (w < 0 || w >= W) continue;
      acc = acc + s[(long long)h * W + w];
    }
  }
  return acc;
}

__global__ void bwd_grad_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ g,
                                const float* __restrict__ q,
                                float* __restrict__ dx,
                                float* __restrict__ dy, int B, int C,
                                int H, int W, float k_l1) {
  const long long plane = (long long)H * W;
  const long long n = (long long)B * C * plane;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long p = i % plane;
  const int j = (int)(p % W);
  const int r = (int)(p / W);
  const long long bc = i / plane;
  const int c = (int)(bc % C);
  const long long b = bc / C;
  const float xv = x[i], yv = y[i];
  const float* qb = q + b * 4 * C * plane;
  const float* s0 = qb + (long long)(0 * C + c) * plane;
  const float* s1 = qb + (long long)(1 * C + c) * plane;
  const float* s2 = qb + (long long)(2 * C + c) * plane;
  const float* s4 = qb + (long long)(3 * C + c) * plane;

  // the padded positions that reflect onto (r, j), in the order of the
  // plain version's pad adjoint: interior, top, bottom, left, right,
  // then the four corners
  const int r1 = min(1, H - 1), rm = max(H - 2, 0);
  const int c1 = min(1, W - 1), cm = max(W - 2, 0);
  const bool top = r == r1, bottom = r == rm;
  const bool left = j == c1, right = j == cm;
  const int pr[9] = {r + 1, 0, H + 1, r + 1, r + 1, 0, 0, H + 1, H + 1};
  const int pc[9] = {j + 1, j + 1, j + 1, 0, W + 1, 0, W + 1, 0, W + 1};
  const bool on[9] = {true, top, bottom, left, right, top && left,
                      top && right, bottom && left, bottom && right};

  float gx = 0.0f, gy = 0.0f;
  for (int k = 0; k < 9; ++k) {
    if (!on[k]) continue;
    const float u0 = box_adjoint(s0, H, W, pr[k], pc[k]);
    const float u2 = box_adjoint(s2, H, W, pr[k], pc[k]);
    const float u4 = box_adjoint(s4, H, W, pr[k], pc[k]);
    const float vx = u0 + 2.0f * xv * u2 + yv * u4;
    gx = (k == 0) ? vx : gx + vx;
    if (dy != nullptr) {
      const float u1 = box_adjoint(s1, H, W, pr[k], pc[k]);
      const float vy = u1 + 2.0f * yv * u2 + xv * u4;
      gy = (k == 0) ? vy : gy + vy;
    }
  }
  const float l1 = k_l1 * g[b * plane + p] * (xv >= yv ? 1.0f : -1.0f);
  dx[i] = gx + l1;
  if (dy != nullptr) dy[i] = gy - l1;
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

// x, y: (B, C, H, W); out: (B, H, W).
extern "C" int reproj_loss_fwd(const float* x, const float* y, float* out,
                               int B, int C, int H, int W,
                               cudaStream_t stream) {
  const long long n = (long long)B * H * W;
  if (n > 0) {
    fwd_kernel<<<blocks_for(n), kThreads, 0, stream>>>(x, y, out, B, C, H,
                                                       W);
  }
  return (int)cudaGetLastError();
}

// x, y: (B, C, H, W); g: (B, H, W); q: (B, 4C, H, W) scratch.
extern "C" int reproj_loss_bwd_q(const float* x, const float* y,
                                 const float* g, float* q, int B, int C,
                                 int H, int W, cudaStream_t stream) {
  const long long n = (long long)B * H * W;
  if (n > 0) {
    bwd_q_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        x, y, g, q, B, C, H, W, (float)(0.85 / C));
  }
  return (int)cudaGetLastError();
}

// dx, dy: (B, C, H, W); dy may be null (no gradient for the target).
extern "C" int reproj_loss_bwd_grad(const float* x, const float* y,
                                    const float* g, const float* q,
                                    float* dx, float* dy, int B, int C,
                                    int H, int W, cudaStream_t stream) {
  const long long n = (long long)B * C * H * W;
  if (n > 0) {
    bwd_grad_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        x, y, g, q, dx, dy, B, C, H, W, (float)(0.15 / C));
  }
  return (int)cudaGetLastError();
}
