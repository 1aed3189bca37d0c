// 3x3 convolution of the depth decoder's narrow layers (Cin, Co <= 64) on
// NCHW float32 or bfloat16, with an optional bias + ELU epilogue, and its
// input gradient.
//
// Replaces the Pallas TPU kernel D of depthmodelhardening_tpu/ops/
// pallas_conv.py: _make_kernel (:42), called by _pallas_conv3x3_valid
// (:94) forward and, with the flipped and transposed weights on a
// cotangent zero-padded by 2, by its custom VJP (:146-152). The
// prototypes P1/P2 (scripts/bench_pallas_conv2.py:54, :133) compute the
// same function, and P3 (scripts/proto_pallas_wconv.py:40) the same with
// bias + ELU fused, which is the epilogue here. P3 takes bf16 in,
// accumulates in float32, applies bias and ELU in float32 and rounds to
// bf16 once (:60-80): the bfloat16 kernels compute that function on the
// plain layout instead of P3's width-packed one. The TPU kernel's
// lane-padded flattened rows and junk row are layout and do not carry
// over.
//
//   out[b, co, y, x] = epi(bias[co] + sum_{ci, dy, dx}
//                          in[b, ci, y + dy - pad, x + dx - pad] * w[co, ci, dy, dx])
//
// -- float32 (conv3x3_fwd, conv3x3_dgrad) ------------------------------------
// in = 0 outside the map. conv3x3_fwd: pad 0 on the reflect-padded input.
// conv3x3_dgrad: the input gradient d xp of the forward, pad 2 on the
// cotangent (bounds checks, nothing materialised), with the caller's
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
// holds the (8 channels, rows + 2, 34) input chunk and its (9 taps, 8
// channels, 8 NT) weights, double-buffered and filled by 4-byte cp.async
// with zero fill at the borders, so chunk k + 1 loads while chunk k
// multiplies. The channel and weight-row strides are 8 mod 16 words, so
// the fragment loads of a warp (lane = 4 g + t reads [t * stride + g])
// hit 32 distinct banks. A staged row's fragment is split once per column
// shift and feeds the up to three output rows that read it. Two blocks an
// SM (at most 128 registers a thread, 64 of them accumulators) are what
// keeps the tensor cores fed between the barriers of a chunk. The 16 -> 1
// head (Co = 1, conv3x3_co1) is bound by bytes and stays on the CUDA
// cores: a block stages an (8 channels, 34, 34) patch and computes a
// 32 x 32 tile, 4 rows per thread.
//
// -- bfloat16 (conv3x3_fwd_bf16, conv3x3_dgrad_bf16) --------------------------
// The decoder's reflect pad is folded in. Forward, reflect mode: x (B,
// Cin, H, W) unpadded, staged at reflected indices (numpy's rule: -1 ->
// min(1, n - 1), n -> max(n - 2, 0)), out (B, Co, H, W). Input gradient,
// reflect mode: the cotangent g (B, Co, H, W) and the forward's weights w
// (read flipped and transposed in the weight staging), out dx (B, Cin, H,
// W) with the pad's adjoint folded in: the conv of g zero-padded by 1
// (the interior of d xp), plus the halo of d xp added onto the row or
// column it reflects to (1 and H - 2, 1 and W - 2, corners twice). Each
// halo row or column of d xp meets g through one tap row or column of
// the weights: d xp[p, 0] = sum_{co, a} g[co, p + a - 2, 0] w[co, ci,
// 2 - a, 0], so a block adds to its edge pixels' accumulators the
// products of g's edge rows and columns (already staged) with those taps,
// in float32. Zero-border mode (reflect = 0) is the same kernel on a
// padded input (forward: pad 0 on xp; input gradient: pad 2 on g, out
// d xp). Everything accumulates in float32 and is rounded to bf16 once,
// after bias and ELU.
//
// What bounds it: bytes. The crop pass's four convs do about 25 GFLOP
// over about 0.35 GB, some 70 flops a byte, far below the ~295 at which
// the bf16 tensor cores would bind; the pad folded in saves the padded
// copy and its gradient (two more passes over the maps). What the design
// does about the bytes and the instructions around them:
// - Co >= 2 (conv3x3_bf16_mma): the implicit GEMM on mma.sync.m16n8k16
//   bf16 (one MMA a product), kBfWarps warps of WR rows x 32 columns, 8 NT
//   output channels, K = 9 Cin in chunks of 16 channels. Persistent
//   blocks walk (tile, chunk) steps (two blocks an SM); a step's copies
//   are issued right after the previous step's repack, so they fly across
//   its MMAs and stores. The input is copied as it lies in memory (raw,
//   planar bf16): a row's 32 interior columns as four 16-byte cp.async
//   where Win % 8 == 0 and the base is 16-byte aligned, each halo column
//   as the 4-byte pair holding it (the reflection read there); other
//   shapes take a scalar path (2-byte loads) into the same layout. One
//   pass repacks raw into channel-pair words (__byte_perm, 16-byte shared
//   stores), the m16n8k16 fragments' element pairs. Every chunk's weights
//   of the block's channel group are staged once (the input gradient's
//   read flipped and transposed). The bias is the accumulators' first
//   term; ELU is exp(v) - 1 below -1/2 and a Taylor polynomial above
//   (float32-accurate, a few times cheaper than expm1f); each warp rounds
//   its rows into its own shared region and stores them with 16-byte
//   stores along x (kBfSmemStores), with no block barrier.
// - Co = 1, the head's forward (conv3x3_bf16_head): CUDA cores, 16
//   channels a chunk copied raw with the same staging, 32 x 32 outputs a
//   block, 4 rows a thread, float32 sums.
// - K = 1, the head's input gradient (conv3x3_bf16_head_dgrad): CUDA
//   cores, a thread reads g's 3 x 10 window once (the pad's adjoint folded
//   into it) and writes 8 pixels of every input channel (9 taps a pixel,
//   16-byte stores). On the tensor cores its K of 1 was padded to 16.
// kernel_variants.py measures the layout constants below on the card.
//
// Products are summed in another order than im2col + SGEMM (and in
// three parts on the tensor cores), so kernel and plain version agree to
// rounding, not bit for bit: within one bf16 ulp in the bf16 kernels,
// whose one rounding may fall either side of a float32 sum that differs
// in its last bits. The build's -fmad=false keeps the split's
// subtraction and the CUDA-core routes' explicit fmaf as written.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// bias and ELU in float32 on the accumulator
__device__ __forceinline__ float epilogue_f32(float v, const float* bias,
                                              int co, int elu) {
  if (bias != nullptr) v += bias[co];
  if (elu) v = v > 0.0f ? v : expm1f(v);
  return v;
}

// -- float32, Co = 1: CUDA cores ------------------------------------------
constexpr int kTW = 32;             // output columns per block: one warp
constexpr int kWarps = 8;           // warps per block, stacked in rows
constexpr int kPY = 4;              // output rows per thread
constexpr int kTH = kWarps * kPY;   // output rows per block
constexpr int kCIC = 8;             // input channels staged per pass
constexpr int kSH = kTH + 2;        // staged rows
constexpr int kSW = kTW + 2;        // staged columns
constexpr int kThreads = kTW * kWarps;

__global__ void __launch_bounds__(kThreads)
conv3x3_co1(const float* __restrict__ in, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out,
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

  const float* inb = in + (long long)b * Cin * Hin * Win;
  for (int c0 = 0; c0 < Cin; c0 += kCIC) {
    const int cn = min(kCIC, Cin - c0);
    for (int i = tid; i < cn * kSH * kSW; i += kThreads) {
      const int ci = i / (kSH * kSW);
      const int r = (i / kSW) % kSH;
      const int c = i % kSW;
      const int gy = y0 + r - pad, gx = x0 + c - pad;
      float v = 0.0f;
      if (gy >= 0 && gy < Hin && gx >= 0 && gx < Win) {
        v = inb[((long long)(c0 + ci) * Hin + gy) * Win + gx];
      }
      sx[ci][r][c] = v;
    }
    for (int i = tid; i < cn * 9; i += kThreads) {
      sw[i / 9][i % 9] = w[c0 * 9 + i];
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
    out[((long long)b * H + yo) * W + xo] = epilogue_f32(acc[p], bias, 0, elu);
  }
}

// -- float32, Co >= 2: tensor cores, 3xTF32 -----------------------------------
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTileW = 32;          // output columns per block: two m16 tiles
constexpr int kStW = kTileW + 2;    // staged columns
constexpr int kK = 8;               // 32-bit words of channels per chunk

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
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
template <int NT, int WR>
__global__ void __launch_bounds__(kMmaThreads, 2)
conv3x3_mma(const float* __restrict__ in, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out,
            int Cin, int Hin, int Win, int Co, int H, int W, int pad,
            int elu, int groups) {
  using T = MmaTile<NT, WR>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int co0 = (blockIdx.x % groups) * 8 * NT;
  const int x0 = (blockIdx.x / groups) * kTileW, y0 = blockIdx.y * T::kTH;
  const int b = blockIdx.z;
  const float* inb = in + (long long)b * Cin * Hin * Win;
  const int chunks = (Cin + kK - 1) / kK;

  // chunk c (input channels kK c .. kK c + kK - 1) into stage buf: the
  // input as sx[k][r][col] at (y0 + r - pad, x0 + col - pad) and the
  // weights as sw[tap][k][n] of output channel co0 + n; zero outside the
  // map and the channels
  auto stage = [&](int c, int buf) {
    float* sx = smem + buf * T::kStage;
    float* sw = sx + T::kXs;
    const int c0 = c * kK;
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
    if (c + 1 < chunks) {
      stage(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
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
          split(q[0], bb[dy][n][0], bs[dy][n][0]);
          split(q[4 * T::kNS], bb[dy][n][1], bs[dy][n][1]);
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
          split(p[0], ab[0], as[0]);
          split(p[8], ab[1], as[1]);
          split(p[4 * T::kCS], ab[2], as[2]);
          split(p[4 * T::kCS + 8], ab[3], as[3]);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int r = sr - dy;
            if (r < 0 || r >= WR) continue;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              mma_tf32(acc[2 * r + half][n], as, bb[dy][n]);
              mma_tf32(acc[2 * r + half][n], ab, bs[dy][n]);
              mma_tf32(acc[2 * r + half][n], ab, bb[dy][n]);
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
              epilogue_f32(acc[m][n][2 * h + j], bias, co, elu);
        }
      }
    }
  }
}

template <int NT, int WR>
int launch_mma(const float* in, const float* w, const float* bias,
               float* out, int B, int Cin, int Hin, int Win, int Co, int H,
               int W, int pad, int elu, cudaStream_t stream) {
  using T = MmaTile<NT, WR>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_mma<NT, WR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int groups = (Co + 8 * NT - 1) / (8 * NT);
  const dim3 grid(((W + kTileW - 1) / kTileW) * groups,
                  (H + T::kTH - 1) / T::kTH, B);
  conv3x3_mma<NT, WR><<<grid, kMmaThreads, T::kSmem, stream>>>(
      in, w, bias, out, Cin, Hin, Win, Co, H, W, pad, elu, groups);
  return (int)cudaGetLastError();
}

// mma != 0: the tensor-core kernel (any Co <= 64); else the CUDA-core
// kernel, which takes Co = 1 only. ops/conv.py chooses by Co.
int launch_f32(const float* in, const float* w, const float* bias,
               float* out, int B, int Cin, int Hin, int Win, int Co, int pad,
               int elu, int mma, cudaStream_t stream) {
  const int H = Hin + 2 * pad - 2, W = Win + 2 * pad - 2;
  if (B <= 0 || Cin <= 0 || Co <= 0 || Co > 64 || H <= 0 || W <= 0 ||
      B > 65535 || (!mma && Co != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!mma) {
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    conv3x3_co1<<<grid, dim3(kTW, kWarps), 0, stream>>>(
        in, w, bias, out, Cin, Hin, Win, H, W, pad, elu);
    return (int)cudaGetLastError();
  }
  // at most 128 registers a thread (two blocks an SM) hold 64 float32
  // accumulators: 32 rows x 16 channels, or 16 rows x 32 channels in one
  // or two channel groups
  if (Co <= 16) {
    return launch_mma<2, 4>(in, w, bias, out, B, Cin, Hin, Win, Co, H, W,
                            pad, elu, stream);
  }
  return launch_mma<4, 2>(in, w, bias, out, B, Cin, Hin, Win, Co, H, W, pad,
                          elu, stream);
}

// -- bfloat16 ------------------------------------------------------------
// Layout constants, chosen by kernel_variants.py's runs on the card:
constexpr int kBfRows16 = 2;        // rows a warp for Co <= 16 (NT = 2)
constexpr int kBfRows64 = 1;        // rows a warp for Co <= 64 (NT = 4)
constexpr int kBfWarps = 8;         // warps a block
constexpr int kBfBlocksPerSm = 2;   // __launch_bounds__' blocks an SM
constexpr int kBfPersistent = 1;    // 0: one tile a block
constexpr int kBfSmemStores = 1;    // 1: each warp stores through shared memory
constexpr int kBfCh = 16;           // input channels a chunk (8 pair words)
constexpr int kRawW = 48;           // raw row: staged column c at c + 8 - pad
constexpr int kPackW = 40;          // packed row (words): c at c + 4 - pad
constexpr int kMaxChunks = 4;       // Cin <= 64

// A convolution's geometry and modes, as the bf16 kernels take it: input
// (B, K, Hin, Win), output (B, N, H, W) with H = Hin + 2 pad - 2 (so the
// same for pad 1), the weights w (N, K, 3, 3), or with flip (K, N, 3, 3)
// read flipped and transposed (the input gradient's).
struct ConvArgs {
  const bf16* in;
  const bf16* w;
  const bf16* bias;
  bf16* out;
  int B, K, Hin, Win, N, H, W;
  int pad;      // 0, 1 or 2
  int reflect;  // stage the input at reflected indices (pad 1)
  int halo;     // add the reflect pad's adjoint (pad 1, input gradient)
  int flip;     // weights transposed and flipped
  int elu;
  int wide;     // 16-byte staging: Win % 8 == 0 and in 16-byte aligned
  int wide_out; // 16-byte stores: W % 8 == 0 and out 16-byte aligned
};

// row or column index i of an axis of n, as the staging reads it: -1 where
// it lies outside and the border is zero, the reflection where it is -1 or
// n and the border reflects (beyond those, -1: no output reads it)
__device__ __forceinline__ int src_index(int i, int n, int reflect) {
  if (i >= 0 && i < n) return i;
  if (reflect) {
    if (i == -1) return min(1, n - 1);
    if (i == n) return max(n - 2, 0);
  }
  return -1;
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_value(uint16_t u) {
  return __uint_as_float((uint32_t)u << 16);
}

// ELU in float32: for v <= 0, expm1(v) as exp(v) - 1 where that does not
// cancel (v < -1/2, |result| > 0.39; exp by ex2.approx, relative error
// ~2^-22), else its Taylor polynomial to v^8 (relative error below
// 0.5^8 / 9! ~ 1e-8): float32-accurate, so within the bf16 rounding of
// expm1, in 13 instructions where expm1f takes several times that
__device__ __forceinline__ float elu_f32(float v) {
  float p = 1.0f / 40320.0f;
  p = fmaf(p, v, 1.0f / 5040.0f);
  p = fmaf(p, v, 1.0f / 720.0f);
  p = fmaf(p, v, 1.0f / 120.0f);
  p = fmaf(p, v, 1.0f / 24.0f);
  p = fmaf(p, v, 1.0f / 6.0f);
  p = fmaf(p, v, 0.5f);
  p = fmaf(p, v, 1.0f);
  const float e = v < -0.5f ? __expf(v) - 1.0f : p * v;
  return v > 0.0f ? v : e;
}

// the bias (or 0) of output channel co, in float32
__device__ __forceinline__ float bias_f32(const uint16_t* bias, int co,
                                          int n) {
  return bias != nullptr && co < n ? bf16_value(bias[co]) : 0.0f;
}

// Copy input channels c0 .. c0 + 15 of batch item b, rows y0 - pad .. y0 -
// pad + SH - 1, columns x0 - pad .. x0 - pad + 33, into raw[ch][r][c + 8 -
// pad] (bf16, rows of kRawW), zero outside the map and the channels.
// wide: the 32 interior columns x0 .. x0 + 31 as four 16-byte cp.async a
// row (a group lies wholly inside or outside, Win % 8 == 0), and the
// columns left of x0 (at 6, 7) and right of x0 + 31 (at 40, 41) as one
// 4-byte pair each, whose one or two wanted elements land where the
// staged columns want them. Else 2-byte loads, synchronously.
template <int SH>
__device__ __forceinline__ void stage_raw(uint16_t* raw, const ConvArgs& a,
                                          int b, int c0, int y0, int x0,
                                          int tid, int nthreads) {
  const uint16_t* in = reinterpret_cast<const uint16_t*>(a.in);
  const long long plane = (long long)a.Hin * a.Win;
  const uint16_t* inb = in + (long long)b * a.K * plane;
  if (a.wide) {
    for (int i = tid; i < kBfCh * SH * 4; i += nthreads) {
      const int j = i & 3, row = i >> 2;
      const int ch = row / SH, r = row - ch * SH;
      const int gy = src_index(y0 + r - a.pad, a.Hin, a.reflect);
      const int gx = x0 + 8 * j;
      uint16_t* dst = raw + row * kRawW + 8 + 8 * j;
      if (a.reflect && gx == a.Win) {
        // the map ends inside the tile: this group's first column is the
        // reflection of Win - 2 (the pair Win - 2, Win - 1; no output
        // reads the group's other columns)
        const bool ok = c0 + ch < a.K && gy >= 0;
        cp_async4(dst,
                  ok ? inb + (c0 + ch) * plane + (long long)gy * a.Win +
                           a.Win - 2
                     : in,
                  ok);
        continue;
      }
      const bool ok = c0 + ch < a.K && gy >= 0 && gx < a.Win;
      cp_async16(dst,
                 ok ? inb + (c0 + ch) * plane + (long long)gy * a.Win + gx
                    : in,
                 ok);
    }
    for (int i = tid; i < kBfCh * SH * 2; i += nthreads) {
      const int right = i & 1, row = i >> 1;
      // left: staged columns 0 .. pad - 1 end at x0 - 1, the pair (e - 1,
      // e) at 6, 7; right: staged columns pad + 32 .. 33 start at x0 + 32,
      // the pair (e, e + 1) at 40, 41
      if (right ? a.pad == 2 : a.pad == 0) continue;
      const int ch = row / SH, r = row - ch * SH;
      const int gy = src_index(y0 + r - a.pad, a.Hin, a.reflect);
      const int e = src_index(right ? x0 + 32 : x0 - 1, a.Win, a.reflect);
      const int p = right ? e : e - 1;  // even: Win and x0 are
      const bool ok = c0 + ch < a.K && gy >= 0 && e >= 0;
      cp_async4(raw + row * kRawW + (right ? 40 : 6),
                ok ? inb + (c0 + ch) * plane + (long long)gy * a.Win + p
                   : in,
                ok);
    }
  } else {
    for (int i = tid; i < kBfCh * SH * kStW; i += nthreads) {
      const int row = i / kStW, c = i - row * kStW;
      const int ch = row / SH, r = row - ch * SH;
      const int gy = src_index(y0 + r - a.pad, a.Hin, a.reflect);
      const int gx = src_index(x0 + c - a.pad, a.Win, a.reflect);
      uint16_t v = 0;
      if (c0 + ch < a.K && gy >= 0 && gx >= 0) {
        v = inb[(c0 + ch) * plane + (long long)gy * a.Win + gx];
      }
      raw[row * kRawW + c + 8 - a.pad] = v;
    }
  }
}

// A block of the tensor-core kernel: kBfWarps warps of WR output rows x
// 32 columns, 8 NT output channels; sizes in bytes. Shared memory: the raw
// stage, the packed words, each warp's output rows (kBfSmemStores), the
// weights of every chunk.
template <int NT, int WR>
struct BfTile {
  static constexpr int kThreads = 32 * kBfWarps;
  static constexpr int kTH = kBfWarps * WR;
  static constexpr int kStH = kTH + 2;
  static constexpr int kRaw = kBfCh * kStH * kRawW * 2;
  static constexpr int kCS = bank_stride(kStH * kPackW);  // words
  static constexpr int kNS = bank_stride(8 * NT);         // words
  static constexpr int kPacked = kK * kCS * 4;
  // a warp's output rows [channel][row][32 columns], each channel 16
  // bytes longer so the 4 channels of a store instruction hit other banks
  static constexpr int kOutCh = WR * kTileW + 8;          // elements
  static constexpr int kOutWarp = 8 * NT * kOutCh * 2;
  static constexpr int kOut = kBfSmemStores ? kBfWarps * kOutWarp : 0;
  static constexpr int kWChunk = 9 * kK * kNS * 4;
  static constexpr int smem(int chunks) {
    return kRaw + kPacked + kOut + chunks * kWChunk;
  }
};

// The tensor-core kernel (see the header). Grid (blocks, groups): block
// (i, group) walks tiles i, i + blocks, ... of its channel group; a tile
// is (b, rows y0 .. y0 + kTH - 1, columns x0 .. x0 + 31), x fastest.
template <int NT, int WR>
__global__ void __launch_bounds__(32 * kBfWarps, kBfBlocksPerSm)
conv3x3_bf16_mma(const ConvArgs a) {
  using T = BfTile<NT, WR>;
  extern __shared__ __align__(16) unsigned char smem_bf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem_bf);
  uint32_t* packed = reinterpret_cast<uint32_t*>(smem_bf + T::kRaw);
  uint16_t* so = reinterpret_cast<uint16_t*>(smem_bf + T::kRaw +
                                             T::kPacked) +
                 warp * (T::kOutWarp / 2);  // this warp's rows
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem_bf + T::kRaw +
                                             T::kPacked + T::kOut);
  const int g = lane >> 2, t = lane & 3;
  const int co0 = blockIdx.y * 8 * NT;
  const int chunks = (a.K + kBfCh - 1) / kBfCh;
  const int tiles_x = (a.W + kTileW - 1) / kTileW;
  const int tiles_y = (a.H + T::kTH - 1) / T::kTH;
  const int tiles = tiles_x * tiles_y * a.B;
  const int my_tiles =
      (int)blockIdx.x < tiles
          ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int steps = my_tiles * chunks;
  const int pos0 = 4 - a.pad;  // packed position of staged column 0

  auto tile_of = [&](int s, int& b, int& y0, int& x0) {
    const int tile = (int)blockIdx.x + (s / chunks) * (int)gridDim.x;
    const int tx = tile % tiles_x, rest = tile / tiles_x;
    x0 = tx * kTileW;
    y0 = (rest % tiles_y) * T::kTH;
    b = rest / tiles_y;
  };
  // a step's input copies run one step ahead of its MMAs
  auto issue = [&](int s) {
    int b, y0, x0;
    tile_of(s, b, y0, x0);
    stage_raw<T::kStH>(raw, a, b, (s % chunks) * kBfCh, y0, x0, tid,
                       T::kThreads);
    cp_async_commit();
  };
  if (steps > 0) issue(0);

  // while they fly, every chunk's weights of the group, once:
  // sw[chunk][tap][k][n] holds the pair (input channels 16 chunk + 2k,
  // + 1) of output channel co0 + n
  {
    const uint16_t* wh = reinterpret_cast<const uint16_t*>(a.w);
    for (int i = tid; i < chunks * kK * 8 * NT; i += T::kThreads) {
      const int n = i % (8 * NT), ck = i / (8 * NT);
      const int k = ck % kK, c = ck / kK;
      const int kc = c * kBfCh + 2 * k, co = co0 + n;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t v[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (co < a.N && kc + j < a.K) {
            v[j] = a.flip
                       ? wh[((long long)(kc + j) * a.N + co) * 9 + 8 - tap]
                       : wh[((long long)co * a.K + kc + j) * 9 + tap];
          }
        }
        sw[((c * 9 + tap) * kK + k) * T::kNS + n] = v[0] | (v[1] << 16);
      }
    }
  }

  float acc[2 * WR][NT][4];
  for (int s = 0; s < steps; ++s) {
    int b, y0, x0;
    tile_of(s, b, y0, x0);
    const int c = s % chunks;
    cp_async_wait<0>();
    __syncthreads();  // raw(s) landed; packed no longer read
    // raw -> channel-pair words: staged column c of pair k at packed[k *
    // kCS + r * kPackW + c + pos0]; the interior 8 columns at a time
    for (int i = tid; i < kK * T::kStH * 4; i += T::kThreads) {
      const int j = i & 3, kr = i >> 2;
      const int k = kr / T::kStH, r = kr - k * T::kStH;
      const uint4 lo = *reinterpret_cast<const uint4*>(
          raw + ((2 * k) * T::kStH + r) * kRawW + 8 + 8 * j);
      const uint4 hi = *reinterpret_cast<const uint4*>(
          raw + ((2 * k + 1) * T::kStH + r) * kRawW + 8 + 8 * j);
      uint32_t* dst = packed + k * T::kCS + r * kPackW + 4 + 8 * j;
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          __byte_perm(lo.x, hi.x, 0x5410), __byte_perm(lo.x, hi.x, 0x7632),
          __byte_perm(lo.y, hi.y, 0x5410), __byte_perm(lo.y, hi.y, 0x7632));
      *reinterpret_cast<uint4*>(dst + 4) = make_uint4(
          __byte_perm(lo.z, hi.z, 0x5410), __byte_perm(lo.z, hi.z, 0x7632),
          __byte_perm(lo.w, hi.w, 0x5410), __byte_perm(lo.w, hi.w, 0x7632));
    }
    for (int i = tid; i < kK * T::kStH * 2; i += T::kThreads) {
      const int kr = i >> 1, k = kr / T::kStH, r = kr - k * T::kStH;
      const int cl = (i & 1) ? a.pad + 32 : 0;    // first halo column
      const int ce = (i & 1) ? kStW : a.pad;      // past the last
      for (int col = cl; col < ce; ++col) {
        const uint16_t* q = raw + ((2 * k) * T::kStH + r) * kRawW + col + 8 -
                            a.pad;
        packed[k * T::kCS + r * kPackW + col + pos0] =
            (uint32_t)q[0] | ((uint32_t)q[T::kStH * kRawW] << 16);
      }
    }
    __syncthreads();  // packed ready; raw free
    // step s + 1's copies fly across this step's MMAs and stores
    if (s + 1 < steps) issue(s + 1);

    if (c == 0) {  // the bias is the sum's first term
      const uint16_t* bh = reinterpret_cast<const uint16_t*>(a.bias);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int co = co0 + n * 8 + 2 * t;
        const float b0 = bias_f32(bh, co, a.N), b1 = bias_f32(bh, co + 1, a.N);
#pragma unroll
        for (int m = 0; m < 2 * WR; ++m) {
          acc[m][n][0] = acc[m][n][2] = b0;
          acc[m][n][1] = acc[m][n][3] = b1;
        }
      }
    }
    const uint32_t* wc = sw + c * 9 * kK * T::kNS;
    // column shift dx: the B fragments of its three taps, then each staged
    // row the warp reads, loaded once and used by every output row it
    // feeds (row sr - dy for tap (dy, dx))
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint32_t bb[3][NT][2];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t* q = wc + ((dy * 3 + dx) * kK + t) * T::kNS + n * 8 + g;
          bb[dy][n][0] = q[0];
          bb[dy][n][1] = q[4 * T::kNS];
        }
      }
#pragma unroll
      for (int sr = 0; sr < WR + 2; ++sr) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // pixel row g of the m-tile is output column 16 half + g
          const uint32_t* p = packed + t * T::kCS +
                              (warp * WR + sr) * kPackW + half * 16 + g +
                              dx + pos0;
          const uint32_t ab[4] = {p[0], p[8], p[4 * T::kCS],
                                  p[4 * T::kCS + 8]};
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int r = sr - dy;
            if (r < 0 || r >= WR) continue;
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16(acc[2 * r + half][n], ab, bb[dy][n]);
          }
        }
      }
    }

    // the reflect pad's adjoint (input gradient, pad 1): output row r1 =
    // min(1, H - 1) gains g's row 0 through tap row 2, rm = max(H - 2, 0)
    // g's row H - 1 through tap row 0; column c1 gains g's column 0
    // through tap column 2 (at every tap row, and at the corners through
    // the rows' halo taps), cm g's column W - 1 through tap column 0.
    // Only warps with such a pixel take part, one tap at a time; the
    // fragments are the staged rows' (row halo) or masked to the one edge
    // column (column halo, its element at staged column esrc)
    const int yw = y0 + warp * WR;
    const int r1 = min(1, a.H - 1), rm = max(a.H - 2, 0);
    const int c1 = min(1, a.W - 1), cm = max(a.W - 2, 0);
    if (a.halo &&
        ((r1 >= yw && r1 < yw + WR) || (rm >= yw && rm < yw + WR) ||
         x0 == 0 || (cm >= x0 && cm < x0 + kTileW))) {
      const int sr_top = 1 - y0, sr_bot = a.H - y0;  // g's rows 0, H - 1
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        if (dy == 1 && dx == 1) continue;  // no halo term reads it
        uint32_t bb[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t* q = wc + (tap * kK + t) * T::kNS + n * 8 + g;
          bb[n][0] = q[0];
          bb[n][1] = q[4 * T::kNS];
        }
        // the row halo this tap row serves (top at dy = 2, bottom at
        // dy = 0; H = 1: both are row 0) and the edge column this tap
        // column serves (c1 at dx = 2, cm at dx = 0; W = 1: both column 0)
        const int erow = dy == 2 ? r1 : (dy == 0 ? rm : -1);
        const int esr = dy == 2 ? sr_top : sr_bot;
        const int ecol = dx == 2 ? c1 : (dx == 0 ? cm : -1);
        const int esrc = dx == 2 ? 1 - x0 : a.W - x0;  // staged column
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int slot = ecol - x0 - 16 * half;  // 0..15 if in this half
          const bool col_here = ecol >= 0 && slot >= 0 && slot < 16;
#pragma unroll
          for (int r = 0; r < WR; ++r) {
            const int y = yw + r;
            if (y >= a.H) continue;
            if (y == erow) {  // row halo: normal columns
              const uint32_t* p = packed + t * T::kCS + esr * kPackW +
                                  half * 16 + g + dx + pos0;
              const uint32_t ab[4] = {p[0], p[8], p[4 * T::kCS],
                                      p[4 * T::kCS + 8]};
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_bf16(acc[2 * r + half][n], ab, bb[n]);
            }
            if (!col_here) continue;
            // column halo: g's edge column at the edge pixel only, from
            // the staged row tap row dy reads, then at a corner from the
            // row halo's staged row
#pragma unroll
            for (int corner = 0; corner < 2; ++corner) {
              if (corner && y != erow) continue;
              const int sr = corner ? esr : y - y0 + dy;
              const uint32_t* p =
                  packed + t * T::kCS + sr * kPackW + esrc + pos0;
              const uint32_t ab[4] = {g == slot ? p[0] : 0u,
                                      g + 8 == slot ? p[0] : 0u,
                                      g == slot ? p[4 * T::kCS] : 0u,
                                      g + 8 == slot ? p[4 * T::kCS] : 0u};
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_bf16(acc[2 * r + half][n], ab, bb[n]);
            }
          }
        }
      }
    }

    if (c != chunks - 1) continue;
    if (kBfSmemStores) {
      // this warp's rows through its own shared region: ELU, one
      // rounding, 2-byte shared stores, then 16-byte global stores along x
      // (4 lanes a 64-byte row of one channel); no block barrier
#pragma unroll
      for (int m = 0; m < 2 * WR; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (m % 2) * 16 + g + 8 * h;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float v = acc[m][n][2 * h + j];
              so[(n * 8 + 2 * t + j) * T::kOutCh + (m / 2) * kTileW + col] =
                  bf16_bits(a.elu ? elu_f32(v) : v);
            }
          }
        }
      }
      __syncwarp();
      uint16_t* out = reinterpret_cast<uint16_t*>(a.out);
#pragma unroll
      for (int i = lane; i < 8 * NT * WR * 4; i += 32) {
        const int seg = i & 3, cr = i >> 2;
        const int ch = cr / WR, row = cr - ch * WR;
        const int co = co0 + ch, y = yw + row, x = x0 + 8 * seg;
        if (co >= a.N || y >= a.H || x >= a.W) continue;
        const uint16_t* src = so + ch * T::kOutCh + row * kTileW + 8 * seg;
        uint16_t* dst = out + (((long long)b * a.N + co) * a.H + y) * a.W + x;
        if (a.wide_out && x + 8 <= a.W) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && x + e < a.W; ++e) dst[e] = src[e];
        }
      }
      __syncwarp();  // the region is free for the next tile
    } else {
      uint16_t* out = reinterpret_cast<uint16_t*>(a.out);
#pragma unroll
      for (int m = 0; m < 2 * WR; ++m) {
        const int y = yw + m / 2;
        if (y >= a.H) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = x0 + (m % 2) * 16 + g + 8 * h;
          if (x >= a.W) continue;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int co = co0 + n * 8 + 2 * t + j;
              if (co >= a.N) continue;
              const float v = acc[m][n][2 * h + j];
              out[(((long long)b * a.N + co) * a.H + y) * a.W + x] =
                  bf16_bits(a.elu ? elu_f32(v) : v);
            }
          }
        }
      }
    }
  }
}

// The head's forward (N = 1) on the CUDA cores: a block stages 16 input
// channels of its 34 x 34 window raw (stage_raw) and computes 32 x 32
// outputs, 4 rows a thread, in float32; bias + ELU, one rounding.
constexpr int kHeadSH = kTH + 2;
constexpr int kHeadSmem = kBfCh * kHeadSH * kRawW * 2;

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_head(const ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_head[];
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem_head);
  __shared__ float sw[kBfCh * kMaxChunks * 9];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, b = blockIdx.z;
  const uint16_t* wh = reinterpret_cast<const uint16_t*>(a.w);
  for (int i = tid; i < a.K * 9; i += kThreads) sw[i] = bf16_value(wh[i]);

  float acc[kPY];
  const float b0 = bias_f32(reinterpret_cast<const uint16_t*>(a.bias), 0, 1);
#pragma unroll
  for (int p = 0; p < kPY; ++p) acc[p] = b0;  // the bias is the first term
  for (int c0 = 0; c0 < a.K; c0 += kBfCh) {
    stage_raw<kHeadSH>(raw, a, b, c0, y0, x0, tid, kThreads);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int cn = min(kBfCh, a.K - c0);
    for (int ch = 0; ch < cn; ++ch) {
      const uint16_t* q = raw + (ch * kHeadSH + ty * kPY) * kRawW + tx + 8 -
                          a.pad;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float col[kPY + 2];
#pragma unroll
        for (int r = 0; r < kPY + 2; ++r) col[r] = bf16_value(q[r * kRawW + dx]);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float wv = sw[(c0 + ch) * 9 + dy * 3 + dx];
#pragma unroll
          for (int p = 0; p < kPY; ++p) acc[p] = fmaf(col[p + dy], wv, acc[p]);
        }
      }
    }
    __syncthreads();
  }
  const int xo = x0 + tx;
  if (xo >= a.W) return;
  uint16_t* out = reinterpret_cast<uint16_t*>(a.out);
#pragma unroll
  for (int p = 0; p < kPY; ++p) {
    const int yo = y0 + ty * kPY + p;
    if (yo >= a.H) break;
    out[((long long)b * a.H + yo) * a.W + xo] =
        bf16_bits(a.elu ? elu_f32(acc[p]) : acc[p]);
  }
}

// The head's input gradient (K = 1) on the CUDA cores: a thread owns 8
// adjacent output pixels of one row (threads in row-major order over all
// (b, y, 8-pixel group), so a warp's stores are contiguous), reads g's
// 3 x 10 window once and, for each of the N input channels, sums its 9
// flipped taps (pad 1 or 2, g zero outside), rounds once and stores the 8
// values (16 bytes where W % 8 == 0). The reflect pad's adjoint is folded
// into the window: on row r1 the window row of tap row 2 also holds g's
// row 0, on row rm the one of tap row 0 g's row H - 1 (a tap row meets
// both rows through the same weights); the edge pixels c1 / cm add g's
// column 0 / W - 1 (so folded too, for the corners) through tap column 2
// / 0, 3 products a channel.
constexpr int kDgPix = 8;

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_head_dgrad(const ConvArgs a, int groups) {
  __shared__ float sw[kBfCh * kMaxChunks * 9];
  const int tid = threadIdx.x;
  const uint16_t* gh = reinterpret_cast<const uint16_t*>(a.in);
  const uint16_t* wh = reinterpret_cast<const uint16_t*>(a.w);
  // wt[n][a][b] = w[0][n][2 - a][2 - b]
  for (int i = tid; i < a.N * 9; i += kThreads) {
    sw[i] = bf16_value(wh[(i / 9) * 9 + 8 - i % 9]);
  }
  __syncthreads();
  const long long item = (long long)blockIdx.x * kThreads + tid;
  if (item >= (long long)a.B * a.H * groups) return;
  const int x = (int)(item % groups) * kDgPix;
  const int y = (int)((item / groups) % a.H);
  const int b = (int)(item / ((long long)groups * a.H));
  const uint16_t* gb = gh + (long long)b * a.Hin * a.Win;
  auto gv = [&](int yy, int xx) {
    return yy >= 0 && yy < a.Hin && xx >= 0 && xx < a.Win
               ? bf16_value(gb[(long long)yy * a.Win + xx])
               : 0.0f;
  };
  float win[3][kDgPix + 2];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < kDgPix + 2; ++c) win[r][c] = gv(y + r - a.pad, x + c - a.pad);
  const int r1 = min(1, a.H - 1), rm = max(a.H - 2, 0);
  const int c1 = min(1, a.W - 1), cm = max(a.W - 2, 0);
  float lcol[3] = {0.0f, 0.0f, 0.0f}, rcol[3] = {0.0f, 0.0f, 0.0f};
  const bool left = a.halo && c1 >= x && c1 < x + kDgPix;
  const bool right = a.halo && cm >= x && cm < x + kDgPix;
  if (a.halo) {
    if (y == r1) {
#pragma unroll
      for (int c = 0; c < kDgPix + 2; ++c) win[2][c] += gv(0, x + c - 1);
    }
    if (y == rm) {
#pragma unroll
      for (int c = 0; c < kDgPix + 2; ++c) win[0][c] += gv(a.H - 1, x + c - 1);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (left) lcol[r] = gv(y + r - 1, 0);
      if (right) rcol[r] = gv(y + r - 1, a.W - 1);
    }
    if (y == r1) {
      lcol[2] += left ? gv(0, 0) : 0.0f;
      rcol[2] += right ? gv(0, a.W - 1) : 0.0f;
    }
    if (y == rm) {
      lcol[0] += left ? gv(a.H - 1, 0) : 0.0f;
      rcol[0] += right ? gv(a.H - 1, a.W - 1) : 0.0f;
    }
  }
  uint16_t* out = reinterpret_cast<uint16_t*>(a.out);
  for (int n = 0; n < a.N; ++n) {
    const float* wt = sw + n * 9;
    float acc[kDgPix];
#pragma unroll
    for (int p = 0; p < kDgPix; ++p) {
      float v = 0.0f;
#pragma unroll
      for (int ta = 0; ta < 3; ++ta)
#pragma unroll
        for (int tb = 0; tb < 3; ++tb) v = fmaf(win[ta][p + tb], wt[ta * 3 + tb], v);
      acc[p] = v;
    }
    if (left || right) {
      float el = 0.0f, er = 0.0f;
#pragma unroll
      for (int ta = 0; ta < 3; ++ta) {
        el = fmaf(lcol[ta], wt[ta * 3 + 2], el);
        er = fmaf(rcol[ta], wt[ta * 3], er);
      }
#pragma unroll
      for (int p = 0; p < kDgPix; ++p) {
        if (left && x + p == c1) acc[p] += el;
        if (right && x + p == cm) acc[p] += er;
      }
    }
    uint16_t* dst = out + (((long long)b * a.N + n) * a.H + y) * a.W + x;
    if (a.wide_out && x + kDgPix <= a.W) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = (uint32_t)bf16_bits(acc[2 * q]) |
               ((uint32_t)bf16_bits(acc[2 * q + 1]) << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int p = 0; p < kDgPix; ++p) {
        if (x + p < a.W) dst[p] = bf16_bits(acc[p]);
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int NT, int WR>
int launch_bf16_mma(const ConvArgs& a, cudaStream_t stream) {
  using T = BfTile<NT, WR>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_bf16_mma<NT, WR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::smem(kMaxChunks));
  if (attr != cudaSuccess) return (int)attr;
  const int chunks = (a.K + kBfCh - 1) / kBfCh;
  const int smem = T::smem(chunks);
  // blocks an SM at this shared memory, once per chunk count
  static int per_sm[kMaxChunks + 1] = {0};
  if (per_sm[chunks] == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[chunks], conv3x3_bf16_mma<NT, WR>, T::kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm[chunks] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int groups = (a.N + 8 * NT - 1) / (8 * NT);
  const long long tiles = (long long)((a.W + kTileW - 1) / kTileW) *
                          ((a.H + T::kTH - 1) / T::kTH) * a.B;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long resident = (long long)per_sm[chunks] * sm_count() / groups;
  const long long blocks =
      kBfPersistent ? (resident < tiles ? (resident > 0 ? resident : 1) : tiles)
                    : tiles;
  conv3x3_bf16_mma<NT, WR><<<dim3((unsigned)blocks, groups), T::kThreads,
                             smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The bf16 route: the head's forward (N = 1) and input gradient (K = 1)
// on the CUDA cores, every other launch on the tensor cores.
int launch_bf16(ConvArgs a, cudaStream_t stream) {
  a.H = a.Hin + 2 * a.pad - 2;
  a.W = a.Win + 2 * a.pad - 2;
  if (a.B <= 0 || a.K <= 0 || a.N <= 0 || a.K > kBfCh * kMaxChunks ||
      a.N > 64 || a.H <= 0 || a.W <= 0 || a.B > 65535 ||
      ((a.reflect || a.halo) && a.pad != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  a.wide = a.Win % 8 == 0 && aligned16(a.in);
  a.wide_out = a.W % 8 == 0 && aligned16(a.out);
  if (a.K == 1 && a.flip) {
    const int groups = (a.W + kDgPix - 1) / kDgPix;
    const long long blocks =
        ((long long)a.B * a.H * groups + kThreads - 1) / kThreads;
    conv3x3_bf16_head_dgrad<<<(unsigned)blocks, kThreads, 0, stream>>>(
        a, groups);
    return (int)cudaGetLastError();
  }
  if (a.N == 1 && !a.flip) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        conv3x3_bf16_head, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kHeadSmem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((a.W + kTW - 1) / kTW, (a.H + kTH - 1) / kTH, a.B);
    conv3x3_bf16_head<<<grid, dim3(kTW, kWarps), kHeadSmem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.N <= 16) return launch_bf16_mma<2, kBfRows16>(a, stream);
  return launch_bf16_mma<4, kBfRows64>(a, stream);
}

}  // namespace

// xp (B, Cin, H + 2, W + 2), w (Co, Cin, 3, 3), bias (Co) or null ->
// out (B, Co, H, W); elu != 0 applies ELU after the bias.
extern "C" int conv3x3_fwd(const float* xp, const float* w,
                           const float* bias, float* out, int B, int Cin,
                           int Hp, int Wp, int Co, int elu, int mma,
                           cudaStream_t stream) {
  return launch_f32(xp, w, bias, out, B, Cin, Hp, Wp, Co, 0, elu, mma,
                    stream);
}

// g (B, Co, H, W), wt (Cin, Co, 3, 3) the forward's weights flipped and
// in/out-transposed -> dxp (B, Cin, H + 2, W + 2), the gradient with
// respect to the forward's xp.
extern "C" int conv3x3_dgrad(const float* g, const float* wt, float* dxp,
                             int B, int Co, int H, int W, int Cin, int mma,
                             cudaStream_t stream) {
  return launch_f32(g, wt, nullptr, dxp, B, Co, H, W, Cin, 2, 0, mma,
                    stream);
}

// bf16 in and out, float32 accumulation, bias and ELU in float32, one
// rounding. reflect != 0: x (B, Cin, H, W), reflect-padded by 1 as it is
// staged -> out (B, Co, H, W). reflect == 0 (zero-border mode): x is the
// padded xp (B, Cin, H + 2, W + 2), Hin x Win its size.
extern "C" int conv3x3_fwd_bf16(const bf16* x, const bf16* w,
                                const bf16* bias, bf16* out, int B, int Cin,
                                int Hin, int Win, int Co, int elu,
                                int reflect, cudaStream_t stream) {
  ConvArgs a{};
  a.in = x;
  a.w = w;
  a.bias = bias;
  a.out = out;
  a.B = B;
  a.K = Cin;
  a.Hin = Hin;
  a.Win = Win;
  a.N = Co;
  a.pad = reflect ? 1 : 0;
  a.reflect = reflect != 0;
  a.elu = elu;
  return launch_bf16(a, stream);
}

// g (B, Co, H, W) and the forward's weights w (Co, Cin, 3, 3), read
// flipped and transposed. reflect != 0: dx (B, Cin, H, W), the gradient
// with respect to the unpadded x of the reflect-mode forward (the pad's
// adjoint folded in). reflect == 0: dxp (B, Cin, H + 2, W + 2), the
// gradient with respect to the zero-border forward's xp.
extern "C" int conv3x3_dgrad_bf16(const bf16* g, const bf16* w, bf16* dx,
                                  int B, int Co, int H, int W, int Cin,
                                  int reflect, cudaStream_t stream) {
  ConvArgs a{};
  a.in = g;
  a.w = w;
  a.out = dx;
  a.B = B;
  a.K = Co;
  a.Hin = H;
  a.Win = W;
  a.N = Cin;
  a.pad = reflect ? 1 : 2;
  a.halo = reflect != 0;
  a.flip = 1;
  return launch_bf16(a, stream);
}
