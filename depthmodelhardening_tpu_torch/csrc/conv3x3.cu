// 3x3 VALID convolution of the depth decoder's narrow layers (Cin, Co
// <= 64) on NCHW float32 or bfloat16, with an optional bias + ELU
// epilogue, and the same kernel run as its input gradient.
//
// Replaces the Pallas TPU kernel D of depthmodelhardening_tpu/ops/
// pallas_conv.py: _make_kernel (:42), called by _pallas_conv3x3_valid
// (:94) forward and, with the flipped and transposed weights on a
// cotangent zero-padded by 2, by its custom VJP (:146-152). The
// prototypes P1/P2 (scripts/bench_pallas_conv2.py:54, :133) compute the
// same function, and P3 (scripts/proto_pallas_wconv.py:40) the same with
// bias + ELU fused, which is the epilogue here. P3 takes bf16 in,
// accumulates in float32, applies bias and ELU in float32 and rounds to
// bf16 once (:60-80): the bfloat16 instance (conv3x3_fwd_bf16) computes
// that function on the plain layout instead of P3's width-packed one.
// The TPU kernel's lane-padded flattened rows and junk row are layout and
// do not carry over.
//
//   out[b, co, y, x] = epi(bias[co] + sum_{ci, dy, dx}
//                          in[b, ci, y + dy - pad, x + dx - pad] * w[co, ci, dy, dx])
//
// with in = 0 outside the map. conv3x3_fwd: pad 0 on the reflect-padded
// input. conv3x3_dgrad: the input gradient d xp of the forward, pad 2 on
// the cotangent (bounds checks, nothing materialised), with the caller's
// flipped, in/out-transposed weights w[ci, co, 2 - dy, 2 - dx]
// (ops/conv.py:dgrad_weights).
//
// What bounds it on an H100: at float32 accuracy, the tensor cores'
// operations for the 32- and 64-channel convs and bytes for the rest. The
// decoder's convs at batch 32 do 24-48 GFLOP over 0.26-1.35 GB; on the
// CUDA cores (67 TFLOP/s) every conv but the 16 -> 1 head is bound by
// operations, on the tensor cores at three TF32 products per float32 one
// (3 x flops over 495 TFLOP/s) only the 64 -> 32 conv still is.
//
// The design, for Co >= 2 (conv3x3_mma): an implicit GEMM on the tensor
// cores with warp-level mma.sync.m16n8k8 TF32. M is a block's tile of
// output pixels (8 warps, each WR rows x 32 columns, two m16 tiles a
// row), N its group of 8 NT output channels (zero-padded), K = 9 Cin
// taken as chunks of 8 input channels, one k8 step per tap. TF32 alone
// keeps about 3 decimal digits, so each operand is split in registers as
// it is loaded into big = tf32(a) and small = tf32(a - big) (to nearest,
// ties away, as cvt.rna), and each product is small*big + big*small +
// big*big in three MMAs with float32 accumulation ("3xTF32"; only
// small*small, about 2^-22 of the product, is dropped). Shared memory
// holds float32 only: the (8 channels, rows + 2, 34) input chunk and its
// (9 taps, 8 channels, 8 NT) weights, double-buffered and filled by
// 4-byte cp.async with zero fill at the borders, so chunk k + 1 loads
// while chunk k multiplies. The channel and weight-row strides are
// 8 mod 16 floats, so the fragment loads of a warp (lane = 4 g + t reads
// [t * stride + g]) hit 32 distinct banks. A staged row's fragment is
// split once per column shift and feeds the up to three output rows that
// read it. Two blocks an SM (at most 128 registers a thread, 64 of them
// accumulators) are what keeps the tensor cores fed between the barriers
// of a chunk. The 16 -> 1 head (Co = 1, conv3x3_co1) is bound by bytes
// and stays on the CUDA cores: a block stages an (8 channels, 34, 34)
// patch and computes a 32 x 32 tile, 4 rows per thread.
//
// The bfloat16 instance (the kernels are templates on the element type
// E) is the same implicit GEMM on mma.sync.m16n8k16 bf16 with float32
// accumulation: one MMA a product, as the operands are already bf16.
// Shared memory holds 32-bit words in both instances: one float32
// channel, or a pair of bf16 channels (2c, 2c + 1, the lower channel in
// the low half), so a chunk is 8 float32 or 16 bf16 channels and every
// fragment load reads the same word of the same layout (the k16
// fragments' element pairs are exactly such channel pairs). The bf16
// input is staged with 2-byte loads packed in registers (cp.async copies
// 4 bytes at the least, and a row of bf16 need not start 4-byte
// aligned). Bias and ELU run in float32 on the accumulator and the
// result is rounded to bf16 once (to nearest even) on store; the Co = 1
// kernel converts its bf16 loads to float32 and does the same.
//
// Products are summed in another order than im2col + SGEMM (and in
// three parts on the tensor cores), so kernel and plain version agree to
// rounding, not bit for bit: within one bf16 ulp in the bf16 instance,
// whose one rounding may fall either side of a float32 sum that differs
// in its last bits. The build's -fmad=false keeps the split's
// subtraction and the CUDA-core route's explicit fmaf as written.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// bias and ELU in float32 on the accumulator, one rounding to E
template <typename E>
__device__ __forceinline__ E epilogue(float v, const E* bias, int co,
                                      int elu) {
  if (bias != nullptr) v += to_f32(bias[co]);
  if (elu) v = v > 0.0f ? v : expm1f(v);
  return from_f32<E>(v);
}

// -- Co = 1: CUDA cores ------------------------------------------------------
constexpr int kTW = 32;             // output columns per block: one warp
constexpr int kWarps = 8;           // warps per block, stacked in rows
constexpr int kPY = 4;              // output rows per thread
constexpr int kTH = kWarps * kPY;   // output rows per block
constexpr int kCIC = 8;             // input channels staged per pass
constexpr int kSH = kTH + 2;        // staged rows
constexpr int kSW = kTW + 2;        // staged columns
constexpr int kThreads = kTW * kWarps;

template <typename E>
__global__ void __launch_bounds__(kThreads)
conv3x3_co1(const E* __restrict__ in, const E* __restrict__ w,
            const E* __restrict__ bias, E* __restrict__ out,
            int Cin, int Hin, int Win, int H, int W, int pad, int elu) {
  __shared__ float sx[kCIC][kSH][kSW];
  __shared__ float sw[kCIC][9];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const int b = blockIdx.z;

  float acc[kPY];
#pragma unroll
  for (int p = 0; p < kPY; ++p) acc[p] = 0.0f;

  const E* inb = in + (long long)b * Cin * Hin * Win;
  for (int c0 = 0; c0 < Cin; c0 += kCIC) {
    const int cn = min(kCIC, Cin - c0);
    for (int i = tid; i < cn * kSH * kSW; i += kThreads) {
      const int ci = i / (kSH * kSW);
      const int r = (i / kSW) % kSH;
      const int c = i % kSW;
      const int gy = y0 + r - pad, gx = x0 + c - pad;
      float v = 0.0f;
      if (gy >= 0 && gy < Hin && gx >= 0 && gx < Win) {
        v = to_f32(inb[((long long)(c0 + ci) * Hin + gy) * Win + gx]);
      }
      sx[ci][r][c] = v;
    }
    for (int i = tid; i < cn * 9; i += kThreads) {
      sw[i / 9][i % 9] = to_f32(w[c0 * 9 + i]);
    }
    __syncthreads();
    for (int ci = 0; ci < cn; ++ci) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float col[kPY + 2];
#pragma unroll
        for (int r = 0; r < kPY + 2; ++r) col[r] = sx[ci][ty * kPY + r][tx + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float wv = sw[ci][dy * 3 + dx];
#pragma unroll
          for (int p = 0; p < kPY; ++p) acc[p] = fmaf(col[p + dy], wv, acc[p]);
        }
      }
    }
    __syncthreads();
  }

  const int xo = x0 + tx;
  if (xo >= W) return;
#pragma unroll
  for (int p = 0; p < kPY; ++p) {
    const int yo = y0 + ty * kPY + p;
    if (yo >= H) break;
    out[((long long)b * H + yo) * W + xo] = epilogue(acc[p], bias, 0, elu);
  }
}

// -- Co >= 2: tensor cores, 3xTF32 (float32) or bf16 -------------------------
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTileW = 32;          // output columns per block: two m16 tiles
constexpr int kStW = kTileW + 2;    // staged columns
constexpr int kK = 8;               // 32-bit words of channels per chunk

// input channels per chunk: the MMA's k (8 float32, or 16 bf16 in pairs)
template <typename E>
__host__ __device__ constexpr int chunk_channels() {
  return kK * (int)(4 / sizeof(E));
}

// the least n' >= n with n' = 8 (mod 16): lanes t = 0..3 at t * n' start
// 8 banks apart (mod 32), so [t * n' + g], g = 0..7, are 32 banks
__host__ __device__ constexpr int bank_stride(int n) {
  return n + (24 - n % 16) % 16;
}

// A block: 8 warps of WR output rows x 32 columns, 8 NT output channels;
// sizes in 32-bit words
template <int NT, int WR>
struct MmaTile {
  static constexpr int kTH = kMmaWarps * WR;           // output rows
  static constexpr int kStH = kTH + 2;                 // staged rows
  static constexpr int kCS = bank_stride(kStH * kStW); // staged channel stride
  static constexpr int kNS = bank_stride(8 * NT);      // weight row stride
  static constexpr int kXs = kK * kCS;                 // staged input words
  static constexpr int kStage = kXs + 9 * kK * kNS;    // words per stage
  static constexpr int kSmem = 2 * kStage * (int)sizeof(float);
};

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero: add half
// a TF32 ulp to the magnitude, drop the 13 low bits) in two integer
// operations; cvt.rna itself compiles to these plus a NaN/Inf test
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = big + small, both TF32, to about 2^-22 of a
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(a);
  small = to_tf32(a - __uint_as_float(big));
}

// c += a b: a 16 x 8 (row g / g + 8, column t / t + 4 of lane 4 g + t),
// b 8 x 8 (row t / t + 4, column g), c 16 x 8 (row g / g + 8, columns 2t,
// 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in bf16 with k16: each register a pair of k (the lower k in
// the low half); a rows g / g + 8, k pairs t / t + 4; b k pairs t / t + 4,
// column g; c as mma_tf32's
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Grid (W / 32 x groups, H / kTH, B), rounded up, with the channel groups
// of 8 NT fastest (the groups of one tile share its input in L2);
// kMmaThreads threads and MmaTile::kSmem bytes of dynamic shared memory a
// block. Warp v computes output rows y0 + v WR .. + WR - 1, columns x0 ..
// x0 + 31, channels co0 .. co0 + 8 NT - 1.
template <typename E, int NT, int WR>
__global__ void __launch_bounds__(kMmaThreads, 2)
conv3x3_mma(const E* __restrict__ in, const E* __restrict__ w,
            const E* __restrict__ bias, E* __restrict__ out,
            int Cin, int Hin, int Win, int Co, int H, int W, int pad,
            int elu, int groups) {
  using T = MmaTile<NT, WR>;
  constexpr bool kF32 = std::is_same_v<E, float>;
  constexpr int kCh = chunk_channels<E>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int co0 = (blockIdx.x % groups) * 8 * NT;
  const int x0 = (blockIdx.x / groups) * kTileW, y0 = blockIdx.y * T::kTH;
  const int b = blockIdx.z;
  const E* inb = in + (long long)b * Cin * Hin * Win;
  const int chunks = (Cin + kCh - 1) / kCh;

  // chunk c (input channels kCh c .. kCh c + kCh - 1) into stage buf: word
  // k of a pixel is channel kCh c + k (float32) or the pair kCh c + 2k,
  // + 1 (bf16); the input as sx[k][r][col] at (y0 + r - pad,
  // x0 + col - pad) and the weights as sw[tap][k][n] of output channel
  // co0 + n; zero outside the map and the channels
  auto stage = [&](int c, int buf) {
    float* sx = smem + buf * T::kStage;
    float* sw = sx + T::kXs;
    const int c0 = c * kCh;
    if constexpr (kF32) {
      for (int i = tid; i < kK * T::kStH * kStW; i += kMmaThreads) {
        const int row = i / kStW, col = i - row * kStW;
        const int ci = row / T::kStH, r = row - ci * T::kStH;
        const int gy = y0 + r - pad, gx = x0 + col - pad;
        const bool ok = c0 + ci < Cin && gy >= 0 && gy < Hin && gx >= 0 &&
                        gx < Win;
        cp_async4(sx + ci * T::kCS + r * kStW + col,
                  ok ? inb + ((long long)(c0 + ci) * Hin + gy) * Win + gx
                     : in,
                  ok);
      }
      for (int i = tid; i < 8 * NT * kK; i += kMmaThreads) {
        const int n = i / kK, ci = i % kK;
        const bool ok = co0 + n < Co && c0 + ci < Cin;
        const float* src = w + ((long long)(co0 + n) * Cin + c0 + ci) * 9;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          cp_async4(sw + (tap * kK + ci) * T::kNS + n, ok ? src + tap : w,
                    ok);
        }
      }
      cp_async_commit();
    } else {
      const uint16_t* inh = reinterpret_cast<const uint16_t*>(inb);
      const uint16_t* wh = reinterpret_cast<const uint16_t*>(w);
      uint32_t* sxw = reinterpret_cast<uint32_t*>(sx);
      uint32_t* sww = reinterpret_cast<uint32_t*>(sw);
      const long long plane = (long long)Hin * Win;
      for (int i = tid; i < kK * T::kStH * kStW; i += kMmaThreads) {
        const int row = i / kStW, col = i - row * kStW;
        const int k = row / T::kStH, r = row - k * T::kStH;
        const int gy = y0 + r - pad, gx = x0 + col - pad;
        const int ci = c0 + 2 * k;
        uint32_t lo = 0, hi = 0;
        if (gy >= 0 && gy < Hin && gx >= 0 && gx < Win) {
          const long long o = ci * plane + (long long)gy * Win + gx;
          if (ci < Cin) lo = inh[o];
          if (ci + 1 < Cin) hi = inh[o + plane];
        }
        sxw[k * T::kCS + r * kStW + col] = lo | (hi << 16);
      }
      for (int i = tid; i < 8 * NT * kK; i += kMmaThreads) {
        const int n = i / kK, k = i % kK;
        const int ci = c0 + 2 * k;
        const bool ok = co0 + n < Co;
        const uint16_t* src = wh + ((long long)(co0 + n) * Cin + ci) * 9;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t lo = ok && ci < Cin ? src[tap] : 0u;
          const uint32_t hi = ok && ci + 1 < Cin ? src[9 + tap] : 0u;
          sww[(tap * kK + k) * T::kNS + n] = lo | (hi << 16);
        }
      }
    }
  };

  float acc[2 * WR][NT][4];
#pragma unroll
  for (int m = 0; m < 2 * WR; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;

  stage(0, 0);
  for (int c = 0; c < chunks; ++c) {
    // bf16 stages with plain stores: the next chunk goes into the other
    // buffer, which every thread finished reading before the last barrier
    if (c + 1 < chunks) {
      stage(c + 1, (c + 1) & 1);
      if constexpr (kF32) cp_async_wait<1>();
    } else if constexpr (kF32) {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = smem + (c & 1) * T::kStage;
    const float* sw = sx + T::kXs;
    // column shift dx: the B fragments of its three taps, then each staged
    // row the warp reads, loaded (and split) once and used by every output
    // row it feeds (row sr - dy for tap (dy, dx)): WR + 2 fragment loads
    // where a loop over the taps would make 3 WR
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint32_t bb[3][NT][2], bs[3][NT][2];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* q = sw + ((dy * 3 + dx) * kK + t) * T::kNS + n * 8 + g;
          if constexpr (kF32) {
            split(q[0], bb[dy][n][0], bs[dy][n][0]);
            split(q[4 * T::kNS], bb[dy][n][1], bs[dy][n][1]);
          } else {
            bb[dy][n][0] = __float_as_uint(q[0]);
            bb[dy][n][1] = __float_as_uint(q[4 * T::kNS]);
          }
        }
      }
#pragma unroll
      for (int sr = 0; sr < WR + 2; ++sr) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // pixel row g of the m-tile is output column 16 half + g
          const float* p = sx + t * T::kCS + (warp * WR + sr) * kStW +
                           half * 16 + g + dx;
          uint32_t ab[4], as[4];
          if constexpr (kF32) {
            split(p[0], ab[0], as[0]);
            split(p[8], ab[1], as[1]);
            split(p[4 * T::kCS], ab[2], as[2]);
            split(p[4 * T::kCS + 8], ab[3], as[3]);
          } else {
            ab[0] = __float_as_uint(p[0]);
            ab[1] = __float_as_uint(p[8]);
            ab[2] = __float_as_uint(p[4 * T::kCS]);
            ab[3] = __float_as_uint(p[4 * T::kCS + 8]);
          }
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int r = sr - dy;
            if (r < 0 || r >= WR) continue;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if constexpr (kF32) {
                mma_tf32(acc[2 * r + half][n], as, bb[dy][n]);
                mma_tf32(acc[2 * r + half][n], ab, bs[dy][n]);
                mma_tf32(acc[2 * r + half][n], ab, bb[dy][n]);
              } else {
                mma_bf16(acc[2 * r + half][n], ab, bb[dy][n]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < 2 * WR; ++m) {
    const int y = y0 + warp * WR + m / 2;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + (m % 2) * 16 + g + 8 * h;
      if (x >= W) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = co0 + n * 8 + 2 * t + j;
          if (co >= Co) continue;
          out[(((long long)b * Co + co) * H + y) * W + x] =
              epilogue(acc[m][n][2 * h + j], bias, co, elu);
        }
      }
    }
  }
}

template <typename E, int NT, int WR>
int launch_mma(const E* in, const E* w, const E* bias, E* out, int B,
               int Cin, int Hin, int Win, int Co, int H, int W, int pad,
               int elu, cudaStream_t stream) {
  using T = MmaTile<NT, WR>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_mma<E, NT, WR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int groups = (Co + 8 * NT - 1) / (8 * NT);
  const dim3 grid(((W + kTileW - 1) / kTileW) * groups,
                  (H + T::kTH - 1) / T::kTH, B);
  conv3x3_mma<E, NT, WR><<<grid, kMmaThreads, T::kSmem, stream>>>(
      in, w, bias, out, Cin, Hin, Win, Co, H, W, pad, elu, groups);
  return (int)cudaGetLastError();
}

// mma != 0: the tensor-core kernel (any Co <= 64); else the CUDA-core
// kernel, which takes Co = 1 only. ops/conv.py chooses by Co.
template <typename E>
int launch(const E* in, const E* w, const E* bias, E* out, int B, int Cin,
           int Hin, int Win, int Co, int pad, int elu, int mma,
           cudaStream_t stream) {
  const int H = Hin + 2 * pad - 2, W = Win + 2 * pad - 2;
  if (B <= 0 || Cin <= 0 || Co <= 0 || Co > 64 || H <= 0 || W <= 0 ||
      B > 65535 || (!mma && Co != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!mma) {
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    conv3x3_co1<E><<<grid, dim3(kTW, kWarps), 0, stream>>>(
        in, w, bias, out, Cin, Hin, Win, H, W, pad, elu);
    return (int)cudaGetLastError();
  }
  // at most 128 registers a thread (two blocks an SM) hold 64 float32
  // accumulators: 32 rows x 16 channels, or 16 rows x 32 channels in one
  // or two channel groups
  if (Co <= 16) {
    return launch_mma<E, 2, 4>(in, w, bias, out, B, Cin, Hin, Win, Co, H,
                               W, pad, elu, stream);
  }
  return launch_mma<E, 4, 2>(in, w, bias, out, B, Cin, Hin, Win, Co, H, W,
                             pad, elu, stream);
}

}  // namespace

// xp (B, Cin, H + 2, W + 2), w (Co, Cin, 3, 3), bias (Co) or null ->
// out (B, Co, H, W); elu != 0 applies ELU after the bias.
extern "C" int conv3x3_fwd(const float* xp, const float* w,
                           const float* bias, float* out, int B, int Cin,
                           int Hp, int Wp, int Co, int elu, int mma,
                           cudaStream_t stream) {
  return launch(xp, w, bias, out, B, Cin, Hp, Wp, Co, 0, elu, mma, stream);
}

// g (B, Co, H, W), wt (Cin, Co, 3, 3) the forward's weights flipped and
// in/out-transposed -> dxp (B, Cin, H + 2, W + 2), the gradient with
// respect to the forward's xp.
extern "C" int conv3x3_dgrad(const float* g, const float* wt, float* dxp,
                             int B, int Co, int H, int W, int Cin, int mma,
                             cudaStream_t stream) {
  return launch(g, wt, static_cast<const float*>(nullptr), dxp, B, Co, H, W,
                Cin, 2, 0, mma, stream);
}

// The bfloat16 instances of the two entry points above: bf16 in and
// out, float32 accumulation, bias and ELU in float32, one rounding.
extern "C" int conv3x3_fwd_bf16(const bf16* xp, const bf16* w,
                                const bf16* bias, bf16* out, int B, int Cin,
                                int Hp, int Wp, int Co, int elu, int mma,
                                cudaStream_t stream) {
  return launch(xp, w, bias, out, B, Cin, Hp, Wp, Co, 0, elu, mma, stream);
}

extern "C" int conv3x3_dgrad_bf16(const bf16* g, const bf16* wt, bf16* dxp,
                                  int B, int Co, int H, int W, int Cin,
                                  int mma, cudaStream_t stream) {
  return launch(g, wt, static_cast<const bf16*>(nullptr), dxp, B, Co, H, W,
                Cin, 2, 0, mma, stream);
}
