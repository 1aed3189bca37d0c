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
// What bounds the forward on an H100: instruction throughput, not bytes.
// Its byte bound (x and y read once, one float a pixel written) is
// 0.0876 ms at (32, 3, 320, 1024), but the SSIM arithmetic is large: the
// library is built with -fmad=false, so every add and every product is its own
// instruction, and bit-exactness with the plain version fixes the order
// of each moment's sum (the nine taps row by row, left to right, as
// ops/ssim.py:sum_taps adds them: 8 sequential adds, no separable
// row-then-column sum). Per pixel and channel that is 40 adds, the
// products, 5 scalings and ~30 instructions for the quotient, clip and
// L1. The first kernel, one thread per pixel, spent as much again on
// 18 global loads a channel, a branchy reflect() on every tap, 64-bit
// index math and 27 products a pixel: 0.3000 ms, 29% of the byte bound
// (NVIDIA H100 80GB HBM3, 700.00 W). So a block owns a tile
// of kTileH x kTileW pixels of one batch item and loops over its C
// channels: it stages the tile's reflect-padded window of x and y for one
// channel, rows r0 - 1 .. r0 + kTileH and columns c0 - 4 .. c0 + kTileW
// + 3 (whole 16-byte groups), in shared memory, the halo holding the
// reflected pixels (reflect()'s rule, n == 1 included) and zeros beyond
// it, so the inner loop has no reflect logic and no bounds checks. The
// window is copied with cp.async (16 bytes a group where W % 4 == 0 and
// the group lies in the row, else 4 bytes an element), double-buffered:
// channel c + 1's copies are in flight while channel c computes. A
// thread owns one column and kFwdRows consecutive rows and walks down
// their window rows: each row brings 3 taps of x and 3 of y from shared
// memory and their products x x, y y, x y, computed once per row, not
// once per window, and goes into the moment sums of the (at most three)
// pixel rows it serves, from their top row to their bottom row, so each
// moment still adds its taps in the plain version's order while only
// three pixels' sums and one row are live (a window of three rows
// holds 45 taps and products), which leaves room for more blocks an SM.
// The L1 term reads the centre tap from the same rows. ssim_sum and
// l1_sum accumulate over c = 0, 1, ... in registers and each pixel is
// written once. Of the layouts kernel_variants.py measures on the card
// (4 or 8 rows a thread, 1 to 7 blocks an SM), 8 rows a thread on 32 x 4
// threads at 6 blocks an SM (80 registers, no spill) is the fastest.
// Index math inside a plane is 32-bit; the entry point refuses H W >=
// 2^31 and launches at most 65535 batch items at a time.
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
// kTileH x kTileW pixels of one (b, c) plane (blockIdx.z = b C +
// c) and stages the tile's q window, rows r0 - 1 .. r0 + kTileH and
// columns c0 - 4 .. c0 + kTileW + 3 (whole 16-byte groups, loaded as
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

// The tile of both fwd_kernel and bwd_grad_kernel: kTileW columns (one
// a thread) by kTileH rows of one plane, and its staged window: rows
// r0 - 1 .. r0 + kTileH, columns c0 - 4 .. c0 + kTileW + 3 (whole 16-byte
// groups).
constexpr int kTileW = 32, kTileH = 32;
constexpr int kWinH = kTileH + 2, kWinW = kTileW + 8;
constexpr int kGroups = kWinH * (kWinW / 4);  // 16-byte groups a window
// The forward's threads: kFwdRows consecutive rows of one column each,
// at least kFwdMinBlocks blocks an SM (80 registers, no spill); the
// backward's: kBwdRows rows each.
constexpr int kFwdRows = 8, kFwdThreadRows = kTileH / kFwdRows;
constexpr int kFwdMinBlocks = 6;
constexpr int kBwdRows = 4, kBwdThreadRows = kTileH / kBwdRows;

// cp.async of 16 bytes, or of 4 with zero fill where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One window row at a thread's three columns j - 1, j, j + 1: x, y, x^2,
// y^2 and xy, each product computed once.
struct Row {
  float t[5][3];
};

__device__ __forceinline__ Row load_row(const float* xr, const float* yr) {
  Row r;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float a = xr[d], b = yr[d];
    r.t[0][d] = a;
    r.t[1][d] = b;
    r.t[2][d] = a * a;
    r.t[3][d] = b * b;
    r.t[4][d] = a * b;
  }
  return r;
}

// clip((1 - SSIM) / 2, 0, 1) from the five window sums, in the plain
// version's operand order (__saturatef is the clip: NaN gives 0 as
// fminf(fmaxf(v, 0), 1) does)
__device__ __forceinline__ float ssim_term(const float (&s)[5]) {
  const float mx = s[0] * kNinth, my = s[1] * kNinth;
  const float sxx = s[2] * kNinth, syy = s[3] * kNinth;
  const float sxy = s[4] * kNinth;
  const float sigma_x = sxx - mx * mx;
  const float sigma_y = syy - my * my;
  const float sigma_xy = sxy - mx * my;
  const float num = (2.0f * mx * my + kC1) * (2.0f * sigma_xy + kC2);
  const float den = (mx * mx + my * my + kC1) * (sigma_x + sigma_y + kC2);
  return __saturatef((1.0f - num / den) / 2.0f);
}

// Grid (ceil(W / kTileW), ceil(H / kTileH), batch items), block (kTileW,
// kFwdThreadRows). vec: W % 4 == 0 and x, y 16-byte aligned.
__global__ void __launch_bounds__(kTileW * kFwdThreadRows, kFwdMinBlocks)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
           float* __restrict__ out, int C, int H, int W, int vec) {
  constexpr int kBlock = kTileW * kFwdThreadRows;
  constexpr int kIters = (kGroups + kBlock - 1) / kBlock;  // groups a thread
  // [buffer][x, y][window row][window column]; channel c in buffer c % 2
  __shared__ __align__(16) float sw[2][2][kWinH][kWinW];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTileW + tx;
  const int c0 = blockIdx.x * kTileW, r0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const float* xb = x + (size_t)b * C * plane;
  const float* yb = y + (size_t)b * C * plane;

  // The thread's staging groups, the same for every channel: group i
  // is window row i / (kWinW / 4), columns 4 (i % (kWinW / 4)) .. + 3,
  // that is image row r0 - 1 + its row and columns c0 - 4 + its column;
  // its source row offset, reflected, or -1 where the row lies beyond
  // the halo (zeros), and its first image column.
  int src_row[kIters], src_col[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * kBlock;
    const int h = r0 - 1 + i / (kWinW / 4);
    src_row[it] = h >= -1 && h <= H ? reflect(h, H) * W : -1;
    src_col[it] = c0 - 4 + (i % (kWinW / 4)) * 4;
  }
  // copy channel c's window of x and y into buffer buf
  auto stage = [&](int c, int buf) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float* src = (p == 0 ? xb : yb) + c * plane;
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int i = tid + it * kBlock;
        if (i >= kGroups) continue;
        float* dst = &sw[buf][p][0][0] + 4 * i;
        const int ro = src_row[it], w = src_col[it];
        if (vec && ro >= 0 && w >= 0 && w + 4 <= W) {
          cp_async16(dst, src + ro + w);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = ro >= 0 && w + e >= -1 && w + e <= W;
            cp_async4(dst + e, ok ? src + ro + reflect(w + e, W) : src, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  stage(0, 0);
  // window row rb + q holds image row r0 + rb + q - 1, so it is the top
  // row of taps of the thread's pixel row q, the middle of q - 1 and the
  // bottom of q - 2; columns tx + 3 .. tx + 5 hold image columns j - 1 ..
  // j + 1
  const int j = c0 + tx, rb = ty * kFwdRows, wc = tx + 3;
  float ssim_sum[kFwdRows], l1_sum[kFwdRows];
#pragma unroll
  for (int i = 0; i < kFwdRows; ++i) ssim_sum[i] = l1_sum[i] = 0.0f;
  for (int c = 0; c < C; ++c) {
    cp_async_wait_all();  // this thread's copies of channel c
    __syncthreads();      // everyone's; and channel c - 1 is computed
    if (c + 1 < C) stage(c + 1, (c + 1) & 1);
    const float(*sx)[kWinW] = sw[c & 1][0];
    const float(*sy)[kWinW] = sw[c & 1][1];
    // Each window row, with its products, goes into the moment sums of
    // the (at most three) pixel rows it serves, which are open from
    // their top row to their bottom row: so every moment adds its nine
    // taps row by row, left to right, from tap (0, 0), the plain
    // version's order, and only three pixels' sums are live at a time.
    float s[kFwdRows][5];
#pragma unroll
    for (int q = 0; q < kFwdRows + 2; ++q) {
      const Row t = load_row(&sx[rb + q][wc], &sy[rb + q][wc]);
#pragma unroll
      for (int i = q - 2; i <= q; ++i) {
        if (i < 0 || i >= kFwdRows) continue;
#pragma unroll
        for (int m = 0; m < 5; ++m) {
          s[i][m] = i == q ? t.t[m][0] : s[i][m] + t.t[m][0];
          s[i][m] = s[i][m] + t.t[m][1];
          s[i][m] = s[i][m] + t.t[m][2];
        }
      }
      if (q >= 1 && q <= kFwdRows) {
        l1_sum[q - 1] = l1_sum[q - 1] + fabsf(t.t[0][1] - t.t[1][1]);
      }
      if (q >= 2) ssim_sum[q - 2] = ssim_sum[q - 2] + ssim_term(s[q - 2]);
    }
  }
  if (j >= W) return;
  const float inv_c = 1.0f / (float)C;
  float* ob = out + (size_t)b * plane;
#pragma unroll
  for (int i = 0; i < kFwdRows; ++i) {
    const int r = r0 + rb + i;
    if (r < H) {
      ob[r * W + j] = 0.85f * (ssim_sum[i] * inv_c) +
                      0.15f * (l1_sum[i] * inv_c);
    }
  }
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
      acc = acc + s[(h - h0) * kWinW + (w - w0)];
    }
  }
  return acc;
}

// Grid (ceil(W / kTileW), ceil(H / kTileH), planes), block
// (kTileW, kBwdThreadRows). vec: W % 4 == 0 and q 16-byte aligned, so
// every staged group of 4 columns is one aligned float4 wholly inside or
// outside the row.
__global__ void __launch_bounds__(kTileW * kBwdThreadRows)
bwd_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ g, const float* __restrict__ q,
                float* __restrict__ dx, float* __restrict__ dy, int C,
                int H, int W, float k_l1, int vec) {
  constexpr int kTW = kTileW, kR = kBwdRows, kWW = kWinW;
  constexpr int kBlock = kTW * kBwdThreadRows;
  // q0, q1, q23, q4 of the plane; q1 only with dy
  __shared__ __align__(16) float sq[4][kWinH][kWW];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTW + tx;
  const int c0 = blockIdx.x * kTW, r0 = blockIdx.y * kTileH;
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
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  constexpr int kMaxZ = 65535;  // the grid's z limit
  if ((long long)H * W > INT_MAX) return (int)cudaErrorInvalidValue;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long plane = (long long)H * W;
  for (int b0 = 0; b0 < B; b0 += kMaxZ) {
    const int nb = std::min(kMaxZ, B - b0);
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH,
                    nb);
    const long long o = (long long)b0 * C * plane;
    fwd_kernel<<<grid, dim3(kTileW, kFwdThreadRows), 0, stream>>>(
        x + o, y + o, out + b0 * plane, C, H, W, vec);
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
    const dim3 grid((W + kTileW - 1) / kTileW,
                    (H + kTileH - 1) / kTileH, nb * C);
    const dim3 block(kTileW, kBwdThreadRows);
    const long long o = (long long)b0 * C * plane;
    bwd_grad_kernel<<<grid, block, 0, stream>>>(
        x + o, y + o, g + b0 * plane, q + 4 * o, dx + o,
        dy == nullptr ? nullptr : dy + o, C, H, W, (float)(0.15 / C), vec);
  }
  return (int)cudaGetLastError();
}
