// The ResNet stem's 3x3 / stride 2 / pad 1 max pool (torch
// MaxPool2d(3, 2, 1)) on NCHW float32 or bfloat16, and its
// equality-routed backward.
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
// tiled: a block owns kBY x kBX windows and writes the input rows and
// columns those windows start (2 oy, 2 oy + 1 and the same for columns).
// It stages the x region its windows and the next tile's first row and
// column of windows read, halo included, in shared memory with 16-byte
// loads where the rows are 16-byte aligned, then computes each window's
// max once, with its cotangent beside it. Each input element then checks
// its <= 2x2 covering windows in shared memory and dx is written once.
// No atomics, so the result is deterministic, and windows are visited in
// the same order (row-major over (oy, ox)) as the plain version
// (ops/pool.py) adds them, so the two agree bit for bit.
//
// The bfloat16 instances (the kernels are templates on the element type
// E) compare and stage in float32, which holds every bf16 value exactly,
// so the forward's max is exact and its rounding to bf16 changes
// nothing; the backward adds a window's cotangents in float32, in the
// same order, and rounds the sum to bf16 once (to nearest even), as the
// plain version does. The vector path moves 4 elements at a time (16
// bytes of float32, 8 of bf16).

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f32(float v) {
  if constexpr (std::is_same_v<E, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// four consecutive elements at an address aligned to 4 elements
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

constexpr int kThreads = 256;
constexpr int kBY = 16, kBX = 64;  // windows per backward block
constexpr int kXR = 2 * kBY + 3;   // staged rows: 2 oy0 - 1 .. 2 (oy0 + kBY) + 1
constexpr int kXC = 2 * kBX + 8;   // staged columns: 2 ox0 - 4 .. 2 (ox0 + kBX) + 3

template <typename E>
__device__ __forceinline__ float window_max(const E* __restrict__ p,
                                            int H, int W, int oy, int ox) {
  float m = -CUDART_INF_F;
  for (int dy = -1; dy <= 1; ++dy) {
    const int h = 2 * oy + dy;
    if (h < 0 || h >= H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int w = 2 * ox + dx;
      if (w < 0 || w >= W) continue;
      m = fmaxf(m, to_f32(p[(long long)h * W + w]));
    }
  }
  return m;
}

template <typename E>
__global__ void pool_fwd(const E* __restrict__ x, E* __restrict__ y,
                         long long planes, int H, int W, int Ho, int Wo) {
  const long long n = planes * Ho * Wo;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ox = (int)(i % Wo);
  const long long t = i / Wo;
  const int oy = (int)(t % Ho);
  const long long plane = t / Ho;
  y[i] = from_f32<E>(window_max(x + plane * H * W, H, W, oy, ox));
}

// Grid (Wo / kBX, Ho / kBY, planes), rounded up; vec: W % 4 == 0 and x,
// dx aligned to 4 elements, so every staged or written group of 4 columns
// is one aligned vector that lies wholly inside or outside the row.
template <typename E>
__global__ void __launch_bounds__(kThreads)
pool_bwd(const E* __restrict__ x, const E* __restrict__ g,
         E* __restrict__ dx, int H, int W, int Ho, int Wo, int vec) {
  __shared__ __align__(16) float sx[kXR][kXC];
  __shared__ float smax[kBY + 1][kBX + 1];  // -inf outside the map
  __shared__ float sg[kBY + 1][kBX + 1];

  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * kBX, oy0 = blockIdx.y * kBY;
  const long long plane = blockIdx.z;
  const E* xp = x + plane * H * W;
  const E* gp = g + plane * Ho * Wo;
  E* dxp = dx + plane * H * W;
  const int h0 = 2 * oy0 - 1, w0 = 2 * ox0 - 4;

  for (int i = tid; i < kXR * (kXC / 4); i += kThreads) {
    const int r = i / (kXC / 4), c = (i % (kXC / 4)) * 4;
    const int h = h0 + r, w = w0 + c;
    float4 v = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                           -CUDART_INF_F);
    if (h >= 0 && h < H) {
      const E* row = xp + (long long)h * W;
      if (vec && w >= 0 && w < W) {
        v = load4(row + w);
      } else if (!vec) {
        if (w >= 0 && w < W) v.x = to_f32(row[w]);
        if (w + 1 >= 0 && w + 1 < W) v.y = to_f32(row[w + 1]);
        if (w + 2 >= 0 && w + 2 < W) v.z = to_f32(row[w + 2]);
        if (w + 3 >= 0 && w + 3 < W) v.w = to_f32(row[w + 3]);
      }
    }
    *reinterpret_cast<float4*>(&sx[r][c]) = v;
  }
  for (int i = tid; i < (kBY + 1) * (kBX + 1); i += kThreads) {
    const int wy = i / (kBX + 1), wx = i % (kBX + 1);
    const bool ok = oy0 + wy < Ho && ox0 + wx < Wo;
    sg[wy][wx] =
        ok ? to_f32(gp[(long long)(oy0 + wy) * Wo + ox0 + wx]) : 0.0f;
  }
  __syncthreads();

  // window (oy0 + wy, ox0 + wx) reads staged rows 2 wy .. 2 wy + 2 and
  // columns 2 wx + 3 .. 2 wx + 5
  for (int i = tid; i < (kBY + 1) * (kBX + 1); i += kThreads) {
    const int wy = i / (kBX + 1), wx = i % (kBX + 1);
    float m = -CUDART_INF_F;
    if (oy0 + wy < Ho && ox0 + wx < Wo) {
      for (int dy = 0; dy < 3; ++dy)
        for (int dxx = 0; dxx < 3; ++dxx)
          m = fmaxf(m, sx[2 * wy + dy][2 * wx + 3 + dxx]);
    }
    smax[wy][wx] = m;
  }
  __syncthreads();

  // input (2 oy0 + r, 2 ox0 + c), 4 columns per thread; it is covered by
  // window (r >> 1, c >> 1), by the next column's if c is odd and by the
  // next row's if r is odd, where those windows exist
  for (int i = tid; i < 2 * kBY * (2 * kBX / 4); i += kThreads) {
    const int r = i / (2 * kBX / 4), c0 = (i % (2 * kBX / 4)) * 4;
    const int h = 2 * oy0 + r;
    if (h >= H) continue;
    const int wy = r >> 1;
    const bool row2 = (r & 1) && oy0 + wy + 1 < Ho;
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j, wx = c >> 1;
      const bool col2 = (c & 1) && ox0 + wx + 1 < Wo;
      const float v = sx[r + 1][c + 4];
      float acc = 0.0f;
      if (v == smax[wy][wx]) acc += sg[wy][wx];
      if (col2 && v == smax[wy][wx + 1]) acc += sg[wy][wx + 1];
      if (row2 && v == smax[wy + 1][wx]) acc += sg[wy + 1][wx];
      if (row2 && col2 && v == smax[wy + 1][wx + 1]) {
        acc += sg[wy + 1][wx + 1];
      }
      out[j] = acc;
    }
    E* row = dxp + (long long)h * W;
    const int w = 2 * ox0 + c0;
    if (vec && w < W) {
      store4(row + w, out);
    } else if (!vec) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (w + j < W) row[w + j] = from_f32<E>(out[j]);
    }
  }
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

template <typename E>
int launch_fwd(const E* x, E* y, int B, int C, int H, int W, int Ho, int Wo,
               cudaStream_t stream) {
  const long long planes = (long long)B * C;
  const long long n = planes * Ho * Wo;
  if (n > 0) {
    pool_fwd<E><<<blocks_for(n), kThreads, 0, stream>>>(x, y, planes, H, W,
                                                        Ho, Wo);
  }
  return (int)cudaGetLastError();
}

template <typename E>
int launch_bwd(const E* x, const E* g, E* dx, int B, int C, int H, int W,
               int Ho, int Wo, cudaStream_t stream) {
  const long long planes = (long long)B * C;
  if (planes > 0 && H > 0 && W > 0) {
    constexpr uintptr_t kAlign = 4 * sizeof(E);
    const int vec = W % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % kAlign == 0 &&
                    reinterpret_cast<uintptr_t>(dx) % kAlign == 0;
    constexpr long long kMaxZ = 65535;  // the grid's z limit
    for (long long p0 = 0; p0 < planes; p0 += kMaxZ) {
      const dim3 grid((Wo + kBX - 1) / kBX, (Ho + kBY - 1) / kBY,
                      (unsigned)std::min(kMaxZ, planes - p0));
      pool_bwd<E><<<grid, kThreads, 0, stream>>>(
          x + p0 * H * W, g + p0 * Ho * Wo, dx + p0 * H * W, H, W, Ho, Wo,
          vec);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int maxpool3x3s2_fwd(const float* x, float* y, int B, int C,
                                int H, int W, int Ho, int Wo,
                                cudaStream_t stream) {
  return launch_fwd(x, y, B, C, H, W, Ho, Wo, stream);
}

extern "C" int maxpool3x3s2_bwd(const float* x, const float* g, float* dx,
                                int B, int C, int H, int W, int Ho, int Wo,
                                cudaStream_t stream) {
  return launch_bwd(x, g, dx, B, C, H, W, Ho, Wo, stream);
}

extern "C" int maxpool3x3s2_fwd_bf16(const bf16* x, bf16* y, int B, int C,
                                     int H, int W, int Ho, int Wo,
                                     cudaStream_t stream) {
  return launch_fwd(x, y, B, C, H, W, Ho, Wo, stream);
}

extern "C" int maxpool3x3s2_bwd_bf16(const bf16* x, const bf16* g, bf16* dx,
                                     int B, int C, int H, int W, int Ho,
                                     int Wo, cudaStream_t stream) {
  return launch_bwd(x, g, dx, B, C, H, W, Ho, Wo, stream);
}
