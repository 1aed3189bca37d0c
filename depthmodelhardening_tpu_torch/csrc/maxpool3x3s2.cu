// The ResNet stem's 3x3 / stride 2 / pad 1 max pool (torch
// MaxPool2d(3, 2, 1)) on NCHW float32 or bfloat16, and its
// equality-routed backward.
//
// Replaces the Pallas TPU kernels of depthmodelhardening_tpu/ops/
// pallas_pool.py: _fwd_kernel (:63) by maxpool3x3s2_fwd and
// maxpool3x3s2_fwd_bf16, _bwd_kernel (:77) by maxpool3x3s2_bwd and
// maxpool3x3s2_bwd_bf16. Those work on the TPU's f=4 width-packed stem
// layout; the function is the same on the plain layout here.
//
// Padding is -inf, as in flax nn.max_pool and torch. Tie rule of the
// backward (the TPU kernel's): every input bit-equal to the max of a
// window that covers it receives that window's full cotangent, so a tie
// duplicates the mass. After a relu every tied zero has a zero
// cotangent upstream, so the model's input gradient does not depend on
// the rule. The backward adds a window's cotangents in float32 in the
// order (wy, wx), (wy, wx + 1), (wy + 1, wx), (wy + 1, wx + 1), as the
// plain version (ops/pool.py) does, and in bf16 rounds the sum once (to
// nearest even), so kernel and plain version agree bit for bit.
//
// What bounds both on an H100: bytes (one read of x and one write of y
// forward; one read of x and g and one write of dx backward; no
// arithmetic to speak of).
//
// float32 (pool_fwd<float>, pool_bwd<float>). The forward is one thread
// per output, with neighbouring threads on neighbouring output columns.
// The backward is tiled: a block owns kBY x kBX windows and writes the
// input rows and columns those windows start (2 oy, 2 oy + 1 and the same
// for columns). It stages the x region its windows and the next tile's
// first row and column of windows read, halo included, in shared memory
// with 16-byte loads where the rows are 16-byte aligned, then computes
// each window's max once, with its cotangent beside it. Each input element
// then checks its <= 2x2 covering windows in shared memory and dx is
// written once. No atomics, so the result is deterministic.
//
// bfloat16 (pool_fwd_bf16, pool_bwd_bf16): kernels of their own. The
// float32 template in bf16 cost what it cost in float32 per element
// (forward 7.9 ps an output against 8.6, backward 4.0 ps an input element
// against 3.6, at the bench step's crop on an H100): halving the bytes
// saved nothing, because it was bound by the instructions it issued and
// their latency (64-bit index division, nine guarded 2-byte loads an
// output, float32 staging), not by memory. So both work on bf16 pairs:
// bf16 -> float32 is exact and a max returns one of its inputs, so
// __hmax2_nan on __nv_bfloat162 gives the bits the float32 max gives,
// and an equality test of bf16 values (__heq2_mask) is the float32 one.
// Every max of the four kernels keeps a NaN, as jnp.maximum and the
// plain version's amax do (a NaN in a window makes the window's max
// NaN, so a run that diverges shows it): float32 by max.NaN (max_nan),
// bf16 pairs by __hmax2_nan. No input equals a
// NaN max, so in both backwards a window whose max is NaN routes its
// cotangent nowhere, and a NaN input receives nothing, as in the plain
// version. +0 against -0 is as the max instructions rank them; the
// stem's relu outputs hold +0 only.
//
// pool_fwd_bf16 runs row strips: a thread owns kFwdRows output rows of
// kFwdCols = 8 columns (one 16-byte store each). It reads the 2 kFwdRows +
// 1 input rows under them with two 16-byte loads a row, takes the column
// max over each window's 3 rows, then the max of columns (2j - 1, 2j, 2j
// + 1) from bf16 pairs (__byte_perm + __hmax2_nan); the column left of its 16
// comes from the neighbouring lane (__shfl_up_sync), or from memory at a
// warp's first lane. kFwdRows = 1: 2 and 4 rows, which read a row shared
// by two windows once, were slower (kernel_variants.py B). Indices are
// 32-bit inside a plane; the plane is blockIdx.y. Rows that are not whole
// 16-byte groups (W % 8 != 0, or x not aligned) are read element by
// element, and outputs likewise written (Wo % 8 != 0, or y not aligned),
// in the same kernel: the same function.
//
// pool_bwd_bf16 runs row strips too: a thread owns kBwdRows = 1 window
// row and kBwdCols = 16 input columns (8 windows, two 16-byte stores a
// row) and walks window rows k0 .. k0 + kBwdRows down, holding the input
// rows in registers (16-byte loads, and the pair each side of its columns
// from the neighbours' cache lines): a window row's max is computed from
// bf16 pairs and packed beside its cotangent in one word; input row 2 wy
// is routed as soon as window row wy is known, row 2 wy - 1 once window
// rows wy - 1 and wy are, each element by packed bf16 equality tests
// (__heq2_mask) against its <= 2 x 2 covering windows, the sum in
// float32, one rounding, 16-byte stores (the strip's last window row is
// the next strip's first: both compute it). A first version staged 16 x
// 16-window tiles of x and g in shared memory with 16-byte cp.async:
// 0.1046 ms at the crop on an H100 80GB HBM3 at 700 W, where this takes
// 0.0744 (kernel_variants.py B; PERF.md has the sweep of rows, columns,
// threads and blocks an SM). The strips fit any width: the flat thread
// index covers ceil(W / kBwdCols) groups a row, so Wo = 80 (the crop) and
// 256 (full frame) leave no lane idle. Rows that are not whole 16-byte
// groups, and cotangent rows with Wo % 4 != 0, are read and written
// element by element in the same kernel. No atomics: deterministic.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }

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

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

constexpr int kThreads = 256;
constexpr int kBY = 16, kBX = 64;  // windows per backward block
constexpr int kXR = 2 * kBY + 3;   // staged rows: 2 oy0 - 1 .. 2 (oy0 + kBY) + 1
constexpr int kXC = 2 * kBX + 8;   // staged columns: 2 ox0 - 4 .. 2 (ox0 + kBX) + 3

// max(a, b), NaN if either is (fmaxf returns the other input): PTX's
// max.NaN (sm_80 and later), one instruction. The explicit tests a != a
// ? a : (b != b ? b : fmaxf(a, b)) cost B1 15% (0.1571 against 0.1365 ms
// at the attack's stem on an H100).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

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
      m = max_nan(m, to_f32(p[(long long)h * W + w]));
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
          m = max_nan(m, sx[2 * wy + dy][2 * wx + 3 + dxx]);
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

// -- bfloat16 ----------------------------------------------------------------
// Pairs of bf16 travel as 32-bit words (lo half = the lower column).
using bf162 = __nv_bfloat162;
constexpr uint32_t kNegInf2 = 0xff80ff80u;  // (-inf, -inf)

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  const bf162 m = __hmax2_nan(*reinterpret_cast<const bf162*>(&a),
                              *reinterpret_cast<const bf162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// 0xffff in each half where a's and b's bf16 values are equal
__device__ __forceinline__ uint32_t eq2(uint32_t a, uint32_t b) {
  return __heq2_mask(*reinterpret_cast<const bf162*>(&a),
                     *reinterpret_cast<const bf162*>(&b));
}

// (a.lo, b.lo) and (a.hi, b.hi)
__device__ __forceinline__ uint32_t lows(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410);
}
__device__ __forceinline__ uint32_t highs(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// The max of windows (2 i - 1, 2 i, 2 i + 1) and (2 i + 1, 2 i + 2,
// 2 i + 3) of a row of column maxima, as one pair: `a` holds columns
// (2 i, 2 i + 1), `b` (2 i + 2, 2 i + 3) and the hi half of `prev`
// column 2 i - 1.
__device__ __forceinline__ uint32_t window_max2(uint32_t prev, uint32_t a,
                                                uint32_t b) {
  return max2(max2(lows(a, b), highs(a, b)), highs(prev, a));
}

constexpr int kFwdThreads = 64;  // threads a block of pool_fwd_bf16
constexpr int kFwdRows = 1;      // output rows a thread
constexpr int kFwdCols = 8;      // output columns a thread: one 16-byte store
static_assert(kFwdCols % 4 == 0, "a thread reads whole 16-byte groups");

// Row h of a plane, columns w0 .. w0 + 2 N - 1, as N pairs; -inf outside
// the map. vec: rows are whole 16-byte groups (W % 8 == 0, x aligned) and
// w0 % 8 == 0 (N >= 4: 16-byte loads) or w0 even (N < 4: 4-byte loads),
// so each load lies wholly inside or outside the row.
template <int N>
__device__ __forceinline__ void load_pairs(
    const unsigned short* __restrict__ xp, int H, int W, int h, int w0,
    bool vec, uint32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = kNegInf2;
  if (h < 0 || h >= H) return;
  const unsigned short* row = xp + h * W;
  if (vec) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      if (w0 + 8 * j < W) {
        const uint4 u = *reinterpret_cast<const uint4*>(row + w0 + 8 * j);
        v[4 * j] = u.x;
        v[4 * j + 1] = u.y;
        v[4 * j + 2] = u.z;
        v[4 * j + 3] = u.w;
      }
    }
#pragma unroll
    for (int i = N / 4 * 4; i < N; ++i) {
      const int w = w0 + 2 * i;
      if (w >= 0 && w < W) v[i] = *reinterpret_cast<const uint32_t*>(row + w);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 2 * N; ++c) {
      const int w = w0 + c;
      if (w >= 0 && w < W) {
        const uint32_t e = row[w];
        v[c / 2] = c % 2 ? (v[c / 2] & 0xffffu) | (e << 16)
                         : (v[c / 2] & 0xffff0000u) | e;
      }
    }
  }
}

// Grid (ceil(strips * ceil(Ho / kFwdRows) / kFwdThreads), planes). Thread
// t = q strips + s of a plane writes output rows kFwdRows q .. kFwdRows q
// + kFwdRows - 1, columns kFwdCols s .. kFwdCols (s + 1) - 1 (strips =
// ceil(Wo / kFwdCols)). vec_in: see load_pairs; vec_out: Wo % 8 == 0 and y
// aligned to 16 bytes.
__global__ void __launch_bounds__(kFwdThreads)
pool_fwd_bf16(const bf16* __restrict__ x, bf16* __restrict__ y, int H, int W,
              int Ho, int Wo, int strips, int vec_in, int vec_out) {
  const int t = blockIdx.x * kFwdThreads + threadIdx.x;
  const int q = t / strips, s = t - q * strips;
  const int oy0 = kFwdRows * q, ox0 = kFwdCols * s, w0 = 2 * ox0;
  const bool live = oy0 < Ho;
  const unsigned short* xp = reinterpret_cast<const unsigned short*>(x) +
                             (long long)blockIdx.y * H * W;
  // cm[k][i]: columns w0 + 2 i, w0 + 2 i + 1, each the max over the 3
  // input rows of output row oy0 + k (input rows 2 oy0 - 1 + r, r = 2 k ..
  // 2 k + 2: with kFwdRows > 1 a row between two output rows is loaded
  // once)
  uint32_t cm[kFwdRows][kFwdCols];
#pragma unroll
  for (int k = 0; k < kFwdRows; ++k) {
#pragma unroll
    for (int i = 0; i < kFwdCols; ++i) cm[k][i] = kNegInf2;
  }
  if (live) {
#pragma unroll
    for (int r = 0; r <= 2 * kFwdRows; ++r) {
      uint32_t v[kFwdCols];
      load_pairs(xp, H, W, 2 * oy0 - 1 + r, w0, vec_in, v);
#pragma unroll
      for (int k = 0; k < kFwdRows; ++k) {
        if (r < 2 * k || r > 2 * k + 2) continue;
#pragma unroll
        for (int i = 0; i < kFwdCols; ++i) cm[k][i] = max2(cm[k][i], v[i]);
      }
    }
  }
  // column w0 - 1 is the hi half of the previous strip's last pair: the
  // previous lane's (every lane shuffles, live or not), but read from
  // memory at a warp's first lane, and -inf at a row's first strip
  uint32_t left[kFwdRows];
#pragma unroll
  for (int k = 0; k < kFwdRows; ++k) {
    left[k] = __shfl_up_sync(0xffffffffu, cm[k][kFwdCols - 1], 1);
  }
  if (!live) return;
  if (s == 0 || threadIdx.x % 32 == 0) {
#pragma unroll
    for (int k = 0; k < kFwdRows; ++k) left[k] = kNegInf2;
    if (s > 0) {
#pragma unroll
      for (int r = 0; r <= 2 * kFwdRows; ++r) {
        const int h = 2 * oy0 - 1 + r;
        if (h < 0 || h >= H) continue;
        const uint32_t e = ((uint32_t)xp[h * W + w0 - 1] << 16) | 0xff80u;
#pragma unroll
        for (int k = 0; k < kFwdRows; ++k) {
          if (r >= 2 * k && r <= 2 * k + 2) left[k] = max2(left[k], e);
        }
      }
    }
  }
  unsigned short* yp =
      reinterpret_cast<unsigned short*>(y) + (long long)blockIdx.y * Ho * Wo;
#pragma unroll
  for (int k = 0; k < kFwdRows; ++k) {
    const int oy = oy0 + k;
    if (oy >= Ho) break;
    uint32_t o[kFwdCols / 2];
#pragma unroll
    for (int i = 0; i < kFwdCols / 2; ++i) {
      o[i] = window_max2(i == 0 ? left[k] : cm[k][2 * i - 1], cm[k][2 * i],
                         cm[k][2 * i + 1]);
    }
    unsigned short* row = yp + oy * Wo + ox0;
    if (vec_out && kFwdCols == 4) {
      *reinterpret_cast<uint2*>(row) = make_uint2(o[0], o[1]);
    } else if (vec_out) {
#pragma unroll
      for (int j = 0; j < kFwdCols / 8; ++j) {
        if (ox0 + 8 * j < Wo) {
          *reinterpret_cast<uint4*>(row + 8 * j) =
              make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kFwdCols; ++j) {
        if (ox0 + j < Wo) row[j] = (unsigned short)(o[j / 2] >> (16 * (j % 2)));
      }
    }
  }
}

constexpr int kBwdThreads = 64;   // threads a block of pool_bwd_bf16
constexpr int kBwdRows = 1;       // window rows a thread (2 input rows each)
constexpr int kBwdCols = 16;      // input columns a thread: 16-byte groups
constexpr int kBwdMinBlocks = 1;  // blocks an SM, at least
static_assert(kBwdCols % 8 == 0, "a thread owns whole 16-byte groups");
constexpr int kBwdPairs = kBwdCols / 2;  // pairs of a row, windows a row

// Row h of a plane around a thread's input columns w0 .. w0 + kBwdCols -
// 1: the pair left of them (w0 - 2, w0 - 1), their kBwdPairs pairs, the
// pair right of them; -inf outside the map (vec: see load_pairs).
struct Row {
  uint32_t left, v[kBwdPairs], right;
};

__device__ __forceinline__ Row load_row_bwd(
    const unsigned short* __restrict__ xp, int H, int W, int h, int w0,
    bool vec) {
  Row r;
  uint32_t halo[1];
  load_pairs(xp, H, W, h, w0, vec, r.v);
  load_pairs(xp, H, W, h, w0 - 2, vec, halo);
  r.left = halo[0];
  load_pairs(xp, H, W, h, w0 + kBwdCols, vec, halo);
  r.right = halo[0];
  return r;
}

// The words (max in the lo half, g in the hi half) of windows (wy, wx0 +
// i), i = 0 .. kBwdPairs, from input rows 2 wy - 1 .. 2 wy + 1 (a, b, c;
// wx0 = w0 / 2). g is 0 outside the map: such a window adds +0, which
// leaves a float32 sum from +0 unchanged. vec: Wo % 4 == 0 and g aligned
// to 8 bytes.
__device__ __forceinline__ void window_words(
    const Row& a, const Row& b, const Row& c,
    const unsigned short* __restrict__ gp, int Ho, int Wo, int wy, int wx0,
    bool vec, uint32_t (&wd)[kBwdPairs + 1]) {
  // column maxima of columns w0 - 2 .. w0 + kBwdCols + 1, pairs
  uint32_t cm[kBwdPairs + 2];
  cm[0] = max2(max2(a.left, b.left), c.left);
#pragma unroll
  for (int i = 0; i < kBwdPairs; ++i) {
    cm[1 + i] = max2(max2(a.v[i], b.v[i]), c.v[i]);
  }
  cm[kBwdPairs + 1] = max2(max2(a.right, b.right), c.right);
  // windows (2 i, 2 i + 1): columns 2 i - 1 .. 2 i + 3 of w0; the last
  // pair's hi half (window kBwdPairs + 1) is not used
  uint32_t m[kBwdPairs / 2 + 1];
#pragma unroll
  for (int i = 0; i <= kBwdPairs / 2; ++i) {
    m[i] = window_max2(cm[2 * i], cm[2 * i + 1],
                       cm[i < kBwdPairs / 2 ? 2 * i + 2 : 2 * i + 1]);
  }
  uint32_t g[kBwdPairs / 2 + 1] = {};  // (g0, g1), (g2, g3), ...
  if (wy < Ho) {
    const unsigned short* row = gp + wy * Wo;
    if (vec) {
#pragma unroll
      for (int j = 0; j < kBwdPairs / 4; ++j) {
        if (wx0 + 4 * j < Wo) {
          const uint2 u = *reinterpret_cast<const uint2*>(row + wx0 + 4 * j);
          g[2 * j] = u.x;
          g[2 * j + 1] = u.y;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBwdPairs; ++i) {
        if (wx0 + i < Wo) g[i / 2] |= (uint32_t)row[wx0 + i] << (i % 2 * 16);
      }
    }
    if (wx0 + kBwdPairs < Wo) g[kBwdPairs / 2] = row[wx0 + kBwdPairs];
  }
#pragma unroll
  for (int i = 0; i <= kBwdPairs; ++i) {
    wd[i] = i % 2 ? highs(m[i / 2], g[i / 2]) : lows(m[i / 2], g[i / 2]);
  }
}

// Adds to acc the cotangents of one row of covering windows, wd: windows
// wx0 .. wx0 + kBwdPairs, for the input elements xs of columns w0 .. w0 +
// kBwdCols - 1. Element 2 k is covered by window k alone, element 2 k + 1
// by windows k and k + 1, in that order.
__device__ __forceinline__ void route_row(const uint32_t (&wd)[kBwdPairs + 1],
                                          const uint32_t (&xs)[kBwdPairs],
                                          float (&acc)[kBwdCols]) {
#pragma unroll
  for (int k = 0; k < kBwdPairs; k += 2) {
    // odd elements 2 k + 1, 2 k + 3 against windows k + 1, k + 2
    const uint32_t next = eq2(highs(xs[k], xs[k + 1]),
                              lows(wd[k + 1], wd[k + 2]));
#pragma unroll
    for (int j = k; j < k + 2; ++j) {
      const uint32_t hit = eq2(xs[j], __byte_perm(wd[j], 0, 0x1010));
      const uint32_t hit_next = next >> ((j - k) * 16);
      const float gj = __uint_as_float(wd[j] & 0xffff0000u);
      const float gj1 = __uint_as_float(wd[j + 1] & 0xffff0000u);
      if (hit & 0xffffu) acc[2 * j] += gj;
      if (hit >> 16) acc[2 * j + 1] += gj;
      if (hit_next & 0xffffu) acc[2 * j + 1] += gj1;
    }
  }
}

// dx of input row h, columns w0 .. w0 + kBwdCols - 1: acc rounded to
// bf16 once
__device__ __forceinline__ void store_row_bwd(unsigned short* __restrict__ dxp,
                                              int W, int h, int w0, bool vec,
                                              const float (&acc)[kBwdCols]) {
  uint32_t o[kBwdPairs];
#pragma unroll
  for (int k = 0; k < kBwdPairs; ++k) {
    const bf162 p = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
    o[k] = *reinterpret_cast<const uint32_t*>(&p);
  }
  unsigned short* row = dxp + h * W;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kBwdCols / 8; ++j) {
      if (w0 + 8 * j < W) {
        *reinterpret_cast<uint4*>(row + w0 + 8 * j) =
            make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBwdCols; ++j) {
      if (w0 + j < W) row[w0 + j] = (unsigned short)(o[j / 2] >> (j % 2 * 16));
    }
  }
}

// Grid (ceil(groups * ceil(Ho / kBwdRows) / kBwdThreads), planes). Thread
// t = q groups + gi of a plane writes dx at input rows 2 k0 .. 2 k0 + 2
// kBwdRows - 1 (k0 = kBwdRows q) and columns w0 = kBwdCols gi .. w0 +
// kBwdCols - 1 (groups = ceil(W / kBwdCols)). It walks window rows k0 ..
// k0 + kBwdRows down, each one's max and cotangent computed once from
// the rows in its registers: input row 2 wy is covered by window row wy
// alone, row 2 wy - 1 by wy - 1 and wy. vec_x: W % 8 == 0 and x, dx
// aligned to 16 bytes; vec_g: Wo % 4 == 0 and g aligned to 8 bytes.
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
pool_bwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
              bf16* __restrict__ dx, int H, int W, int Ho, int Wo, int groups,
              int vec_x, int vec_g) {
  const int t = blockIdx.x * kBwdThreads + threadIdx.x;
  const int q = t / groups, gi = t - q * groups;
  const int k0 = kBwdRows * q, w0 = kBwdCols * gi;
  if (k0 >= Ho) return;
  const long long plane = blockIdx.y;
  const unsigned short* xp =
      reinterpret_cast<const unsigned short*>(x) + plane * H * W;
  const unsigned short* gp =
      reinterpret_cast<const unsigned short*>(g) + plane * Ho * Wo;
  unsigned short* dxp = reinterpret_cast<unsigned short*>(dx) + plane * H * W;

  Row prev = load_row_bwd(xp, H, W, 2 * k0 - 1, w0, vec_x);  // 2 wy - 1
  uint32_t wprev[kBwdPairs + 1];  // window row wy - 1
#pragma unroll
  for (int j = 0; j <= kBwdRows; ++j) {
    const int wy = k0 + j;
    const Row even = load_row_bwd(xp, H, W, 2 * wy, w0, vec_x);
    const Row odd = load_row_bwd(xp, H, W, 2 * wy + 1, w0, vec_x);
    uint32_t wd[kBwdPairs + 1];
    window_words(prev, even, odd, gp, Ho, Wo, wy, w0 / 2, vec_g, wd);
    if (j > 0 && 2 * wy - 1 < H) {
      float acc[kBwdCols] = {};
      route_row(wprev, prev.v, acc);
      route_row(wd, prev.v, acc);
      store_row_bwd(dxp, W, 2 * wy - 1, w0, vec_x, acc);
    }
    if (j < kBwdRows && 2 * wy < H) {
      float acc[kBwdCols] = {};
      route_row(wd, even.v, acc);
      store_row_bwd(dxp, W, 2 * wy, w0, vec_x, acc);
    }
    prev = odd;
#pragma unroll
    for (int i = 0; i <= kBwdPairs; ++i) wprev[i] = wd[i];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

constexpr long long kMaxPlanes = 65535;  // the grid's y and z limit

int launch_fwd_bf16(const bf16* x, bf16* y, int B, int C, int H, int W,
                    int Ho, int Wo, cudaStream_t stream) {
  const long long planes = (long long)B * C;
  if (planes > 0 && Ho > 0 && Wo > 0) {
    if ((long long)H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const int strips = (Wo + kFwdCols - 1) / kFwdCols;
    const long long threads =
        (long long)strips * ((Ho + kFwdRows - 1) / kFwdRows);
    const int vec_in = W % 8 == 0 && aligned16(x);
    const int vec_out = Wo % 8 == 0 && aligned16(y);
    for (long long p0 = 0; p0 < planes; p0 += kMaxPlanes) {
      const dim3 grid((unsigned)((threads + kFwdThreads - 1) / kFwdThreads),
                      (unsigned)std::min(kMaxPlanes, planes - p0));
      pool_fwd_bf16<<<grid, kFwdThreads, 0, stream>>>(
          x + p0 * H * W, y + p0 * Ho * Wo, H, W, Ho, Wo, strips, vec_in,
          vec_out);
    }
  }
  return (int)cudaGetLastError();
}

int launch_bwd_bf16(const bf16* x, const bf16* g, bf16* dx, int B, int C,
                    int H, int W, int Ho, int Wo, cudaStream_t stream) {
  const long long planes = (long long)B * C;
  if (planes > 0 && H > 0 && W > 0) {
    if ((long long)H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const int groups = (W + kBwdCols - 1) / kBwdCols;
    const long long threads =
        (long long)groups * ((Ho + kBwdRows - 1) / kBwdRows);
    const int vec_x = W % 8 == 0 && aligned16(x) && aligned16(dx);
    const int vec_g = Wo % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 8 == 0;
    for (long long p0 = 0; p0 < planes; p0 += kMaxPlanes) {
      const dim3 grid((unsigned)((threads + kBwdThreads - 1) / kBwdThreads),
                      (unsigned)std::min(kMaxPlanes, planes - p0));
      pool_bwd_bf16<<<grid, kBwdThreads, 0, stream>>>(
          x + p0 * H * W, g + p0 * Ho * Wo, dx + p0 * H * W, H, W, Ho, Wo,
          groups, vec_x, vec_g);
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
  return launch_fwd_bf16(x, y, B, C, H, W, Ho, Wo, stream);
}

extern "C" int maxpool3x3s2_bwd_bf16(const bf16* x, const bf16* g, bf16* dx,
                                     int B, int C, int H, int W, int Ho,
                                     int Wo, cudaStream_t stream) {
  return launch_bwd_bf16(x, g, dx, B, C, H, W, Ho, Wo, stream);
}
