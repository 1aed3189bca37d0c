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
// 2. reproj_loss_bwd_grad: the 3x3 mean pool's adjoint (the sum of the
//    <= 9 windows that cover a padded position) at each padded position
//    that reflects onto an input pixel (itself, plus its mirror images
//    in padded rows/cols 0 and H+1 / W+1), combined with the pixel's
//    values as u0 + 2x u2 + y u4; then the L1 term.
//
// What bounds bwd_grad: bytes (x, y, g, three q planes, four with dy,
// and dx, dy once each), if every q element is read from device memory
// once and the taps cost no more than the loads. One thread per pixel
// reading its taps from global memory made 27 (36 with dy) bounds-
// checked loads a pixel, each q element fetched by nine threads through
// L1, and ran at a fifth of that bound. So a block owns a tile of
// kBwdTileH x kBwdTileW pixels of one (b, c) plane (blockIdx.z = b C +
// c) and stages the tile's q window, rows r0 - 1 .. r0 + kBwdTileH and
// columns c0 - 4 .. c0 + kBwdTileW + 3 (whole 16-byte groups, loaded as
// float4 where W % 4 == 0), with zeros outside the image: the plain
// version's 2-zero pad of q. A halo of one covers every tap: the
// interior position pr = r + 1 reads q rows r - 1 .. r + 1; the top
// reflection pr = 0 occurs only for r == r1 = min(1, H - 1) and reads
// row 0 <= r; the bottom reflection pr = H + 1 occurs only for
// r == rm = max(H - 2, 0) and reads row H - 1 <= r + 1; columns alike.
// A thread owns one column and kBwdRows consecutive rows: it loads
// their x, y and g before the staging, so that both are in flight
// together (the block has one round trip to memory, not two), and it
// slides a 3 x 3 register window of each plane down its rows: 3 shared
// loads a plane and pixel, not 9. Of the tile shapes measured on the
// card (32 x 8 to 64 x 16 pixels, 1 to 4 rows a thread) 32 x 32 with 4
// rows a thread and 32 x 8 with 2 were the fastest, and more rows a
// thread won over taller blocks. Every box sum adds its taps in the
// plain version's order (rows, then columns, from 0); a staged zero
// adds nothing (the sum is never -0), so adding it equals skipping it.
// The reflected positions, only on the image's edge rows and columns,
// skip their taps outside the image. Index math inside a plane is
// 32-bit; the entry point refuses H W >= 2^31 and launches at most
// 65535 planes at a time.
//
// Tie rules are JAX autodiff's, which the reference gradient follows:
// the clip passes 0.5 at exactly 0 or 1 (x == y gives exactly 0) and
// |.|' is +1 at 0. Every expression keeps the plain version's operand
// order (ops/reproj.py), divisions by 9 and by C are products with the
// rounded reciprocal (as PyTorch's division by a scalar is on the card),
// and the library is built with -fmad=false, so the kernel rounds as the
// plain version does.

#include <algorithm>
#include <climits>
#include <cstdint>

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

// The backward's tile: kBwdTileW columns (one a thread) by kBwdTileH
// rows (kBwdRows a thread) of one plane, and its staged q window.
constexpr int kBwdTileW = 32, kBwdThreadRows = 8, kBwdRows = 4;
constexpr int kBwdTileH = kBwdThreadRows * kBwdRows;
// the window: q rows r0 - 1 .. r0 + kBwdTileH, columns c0 - 4 ..
// c0 + kBwdTileW + 3 (whole 16-byte groups)
constexpr int kBwdWinH = kBwdTileH + 2, kBwdWinW = kBwdTileW + 8;

// Three consecutive rows of three q taps, the 3 x 3 box of one pixel.
struct Box {
  float t[3][3];

  // slide down one row: rows 1, 2 move up, `row` (3 taps) comes in last
  __device__ __forceinline__ void push(const float* row) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      t[0][d] = t[1][d];
      t[1][d] = t[2][d];
      t[2][d] = row[d];
    }
  }

  // the mean pool's adjoint at an interior padded position: the taps
  // added row by row from 0, as the plain version adds its shifted
  // slices of the 2-zero-padded q
  __device__ __forceinline__ float sum() const {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) acc = acc + t[a][bb];
    return acc;
  }
};

// The mean pool's adjoint at a reflected padded position (pr, pc) in
// [0, H+2) x [0, W+2): the sum of q over the output windows (h, w) in
// [pr-2, pr] x [pc-2, pc] that lie in the image, in the plain version's
// order, read from the staged window whose (0, 0) is image (h0, w0).
__device__ __forceinline__ float box_edge(const float* __restrict__ s,
                                          int H, int W, int h0, int w0,
                                          int pr, int pc) {
  float acc = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const int h = pr + a - 2;
    if (h < 0 || h >= H) continue;
    for (int bb = 0; bb < 3; ++bb) {
      const int w = pc + bb - 2;
      if (w < 0 || w >= W) continue;
      acc = acc + s[(h - h0) * kBwdWinW + (w - w0)];
    }
  }
  return acc;
}

// Grid (ceil(W / kBwdTileW), ceil(H / kBwdTileH), planes), block
// (kBwdTileW, kBwdThreadRows). vec: W % 4 == 0 and q 16-byte aligned, so
// every staged group of 4 columns is one aligned float4 wholly inside or
// outside the row.
__global__ void __launch_bounds__(kBwdTileW * kBwdThreadRows)
bwd_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ g, const float* __restrict__ q,
                float* __restrict__ dx, float* __restrict__ dy, int C,
                int H, int W, float k_l1, int vec) {
  constexpr int kTW = kBwdTileW, kR = kBwdRows, kWW = kBwdWinW;
  constexpr int kBlock = kTW * kBwdThreadRows;
  constexpr int kGroups = kBwdWinH * (kWW / 4);
  // q0, q1, q23, q4 of the plane; q1 only with dy
  __shared__ __align__(16) float sq[4][kBwdWinH][kWW];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTW + tx;
  const int c0 = blockIdx.x * kTW, r0 = blockIdx.y * kBwdTileH;
  const int bc = blockIdx.z, b = bc / C, c = bc - b * C;
  const int h0 = r0 - 1, w0 = c0 - 4;  // image position of window (0, 0)
  const size_t plane = (size_t)H * W;
  const bool need_dy = dy != nullptr;
  const int j = c0 + tx, rb = ty * kR;  // the thread's column, first row

  // the thread's pixels, loaded before the staging so that both are in
  // flight together
  const float* xp = x + bc * plane;
  const float* yp = y + bc * plane;
  const float* gp = g + b * plane;
  float xs[kR], ys[kR], gs[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    xs[i] = ys[i] = gs[i] = 0.0f;
    if (j < W && r0 + rb + i < H) {
      const int o = (r0 + rb + i) * W + j;
      xs[i] = xp[o];
      ys[i] = yp[o];
      gs[i] = gp[o];
    }
  }

  // the q window: every load of the block issued before the first
  // store to shared memory
  constexpr int kIters = (kGroups + kBlock - 1) / kBlock;
  float4 v[4][kIters];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* src = q + ((size_t)b * 4 * C + (size_t)k * C + c) * plane;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kBlock;
      const int wr = i / (kWW / 4), wc = (i % (kWW / 4)) * 4;
      const int h = h0 + wr, w = w0 + wc;
      v[k][it] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if ((k != 1 || need_dy) && i < kGroups && h >= 0 && h < H) {
        const float* row = src + h * W;
        if (vec) {
          if (w >= 0 && w < W) {
            v[k][it] = *reinterpret_cast<const float4*>(row + w);
          }
        } else {
          if (w >= 0 && w < W) v[k][it].x = row[w];
          if (w + 1 >= 0 && w + 1 < W) v[k][it].y = row[w + 1];
          if (w + 2 >= 0 && w + 2 < W) v[k][it].z = row[w + 2];
          if (w + 3 >= 0 && w + 3 < W) v[k][it].w = row[w + 3];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kBlock;
      if ((k != 1 || need_dy) && i < kGroups) {
        *reinterpret_cast<float4*>(
            &sq[k][i / (kWW / 4)][(i % (kWW / 4)) * 4]) = v[k][it];
      }
    }
  }
  __syncthreads();

  if (j >= W) return;
  float* dxp = dx + bc * plane;
  float* dyp = need_dy ? dy + bc * plane : nullptr;
  const int r1 = min(1, H - 1), rm = max(H - 2, 0);
  const int c1 = min(1, W - 1), cm = max(W - 2, 0);
  const bool left = j == c1, right = j == cm;

  // window row rb + i + 1 holds the thread's i-th pixel row; column
  // tx + 3 holds image column j - 1
  const int wc = tx + 3;
  Box t0, t1, t2, t4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    t0.push(&sq[0][rb + i][wc]);
    if (need_dy) t1.push(&sq[1][rb + i][wc]);
    t2.push(&sq[2][rb + i][wc]);
    t4.push(&sq[3][rb + i][wc]);
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = r0 + rb + i;
    t0.push(&sq[0][rb + i + 2][wc]);
    if (need_dy) t1.push(&sq[1][rb + i + 2][wc]);
    t2.push(&sq[2][rb + i + 2][wc]);
    t4.push(&sq[3][rb + i + 2][wc]);
    if (r >= H) continue;
    const int o = r * W + j;
    const float xv = xs[i], yv = ys[i];
    const float u2 = t2.sum(), u4 = t4.sum();
    float gx = t0.sum() + 2.0f * xv * u2 + yv * u4;
    float gy = 0.0f;
    if (need_dy) gy = t1.sum() + 2.0f * yv * u2 + xv * u4;

    // the reflected positions, in the plain version's pad-adjoint
    // order: top, bottom, left, right, then the four corners
    const bool top = r == r1, bottom = r == rm;
    if (top || bottom || left || right) {
      auto add = [&](int pr, int pc) {
        const float e0 = box_edge(&sq[0][0][0], H, W, h0, w0, pr, pc);
        const float e2 = box_edge(&sq[2][0][0], H, W, h0, w0, pr, pc);
        const float e4 = box_edge(&sq[3][0][0], H, W, h0, w0, pr, pc);
        const float vx = e0 + 2.0f * xv * e2 + yv * e4;
        gx = gx + vx;
        if (need_dy) {
          const float e1 = box_edge(&sq[1][0][0], H, W, h0, w0, pr, pc);
          const float vy = e1 + 2.0f * yv * e2 + xv * e4;
          gy = gy + vy;
        }
      };
      if (top) add(0, j + 1);
      if (bottom) add(H + 1, j + 1);
      if (left) add(r + 1, 0);
      if (right) add(r + 1, W + 1);
      if (top && left) add(0, 0);
      if (top && right) add(0, W + 1);
      if (bottom && left) add(H + 1, 0);
      if (bottom && right) add(H + 1, W + 1);
    }
    const float l1 = k_l1 * gs[i] * (xv >= yv ? 1.0f : -1.0f);
    dxp[o] = gx + l1;
    if (need_dy) dyp[o] = gy - l1;
  }
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
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  constexpr int kMaxZ = 65535;  // the grid's z limit
  if ((long long)H * W > INT_MAX || C > kMaxZ) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const long long plane = (long long)H * W;
  const int per = kMaxZ / C;  // whole batches a launch
  for (int b0 = 0; b0 < B; b0 += per) {
    const int nb = std::min(per, B - b0);
    const dim3 grid((W + kBwdTileW - 1) / kBwdTileW,
                    (H + kBwdTileH - 1) / kBwdTileH, nb * C);
    const dim3 block(kBwdTileW, kBwdThreadRows);
    const long long o = (long long)b0 * C * plane;
    bwd_grad_kernel<<<grid, block, 0, stream>>>(
        x + o, y + o, g + b0 * plane, q + 4 * o, dx + o,
        dy == nullptr ? nullptr : dy + o, C, H, W, (float)(0.15 / C), vec);
  }
  return (int)cudaGetLastError();
}
