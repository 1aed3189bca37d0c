// 3x3 VALID convolution of the depth decoder's narrow layers (Cin, Co
// <= 64) on NCHW float32, with an optional bias + ELU epilogue, and the
// same kernel run as its input gradient.
//
// Replaces the Pallas TPU kernel D of depthmodelhardening_tpu/ops/
// pallas_conv.py: _make_kernel (:42), called by _pallas_conv3x3_valid
// (:94) forward and, with the flipped and transposed weights on a
// cotangent zero-padded by 2, by its custom VJP (:146-152). The
// prototypes P1/P2 (scripts/bench_pallas_conv2.py:54, :133) compute the
// same function, and P3 (scripts/proto_pallas_wconv.py:40) the same with
// bias + ELU fused, which is the epilogue here (float32 instead of its
// bf16 width-packed layout). The TPU kernel's lane-padded flattened rows
// and junk row are layout and do not carry over.
//
//   out[b, co, y, x] = epi(bias[co] + sum_{ci, dy, dx}
//                          in[b, ci, y + dy - pad, x + dx - pad] * w'[co, ci, dy, dx])
//
// with in = 0 outside the map. conv3x3_fwd: pad 0 on the reflect-padded
// input, w' = w. conv3x3_dgrad: the input gradient d xp of the forward,
// pad 2 on the cotangent (bounds checks, nothing materialised) and
// w'[ci, co, dy, dx] = w[co, ci, 2 - dy, 2 - dx] read in place.
//
// What bounds it on an H100: operations. The decoder's 16- and 32-channel
// maps at batch 32 do 24-48 GFLOP per conv over 0.3-0.7 GB, about 70
// flop per byte, above the card's float32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte); the 16 -> 1 disparity head alone is bound by
// bytes. The design keeps the CUDA cores busy without tensor cores: a
// block stages an (8 channels, 34, 34) input patch and the matching
// weights in shared memory and computes a 32 x 32 output tile for 8
// output channels; each thread holds 4 rows x 8 channels of float32
// accumulators, so every input value read from shared memory feeds 24
// FMAs and every weight (a broadcast read) feeds 4. Output-channel groups
// are the fastest grid index, so the groups of one tile reuse its input
// from L2. Products are summed with explicit fmaf (the build's
// -fmad=false does not apply), in another order than im2col + SGEMM, so
// kernel and plain version agree to rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;             // output columns per block: one warp
constexpr int kWarps = 8;           // warps per block, stacked in rows
constexpr int kPY = 4;              // output rows per thread
constexpr int kTH = kWarps * kPY;   // output rows per block
constexpr int kCIC = 8;             // input channels staged per pass
constexpr int kSH = kTH + 2;        // staged rows
constexpr int kSW = kTW + 2;        // staged columns
constexpr int kThreads = kTW * kWarps;

template <int COB>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ in, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int Cin, int Hin, int Win, int Co, int H, int W, int pad,
               int transposed, int elu, int groups) {
  __shared__ float sx[kCIC][kSH][kSW];
  __shared__ __align__(16) float sw[kCIC][9][COB];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int co0 = (blockIdx.x % groups) * COB;
  const int x0 = (blockIdx.x / groups) * kTW;
  const int y0 = blockIdx.y * kTH;
  const int b = blockIdx.z;

  float acc[kPY][COB];
#pragma unroll
  for (int p = 0; p < kPY; ++p)
#pragma unroll
    for (int k = 0; k < COB; ++k) acc[p][k] = 0.0f;

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
    for (int i = tid; i < cn * 9 * COB; i += kThreads) {
      const int k = i % COB;
      const int t = (i / COB) % 9;
      const int ci = i / (9 * COB);
      const int co = co0 + k;
      float v = 0.0f;
      if (co < Co) {
        // forward: w[co][ci][t]; input gradient: the forward's weights
        // (Cin_fwd = Co here, Co_fwd = Cin here) transposed and flipped
        v = transposed ? w[((long long)(c0 + ci) * Co + co) * 9 + 8 - t]
                       : w[((long long)co * Cin + c0 + ci) * 9 + t];
      }
      sw[ci][t][k] = v;
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
          float wv[COB];
#pragma unroll
          for (int k = 0; k < COB; ++k) wv[k] = sw[ci][dy * 3 + dx][k];
#pragma unroll
          for (int p = 0; p < kPY; ++p)
#pragma unroll
            for (int k = 0; k < COB; ++k)
              acc[p][k] = fmaf(col[p + dy], wv[k], acc[p][k]);
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
#pragma unroll
    for (int k = 0; k < COB; ++k) {
      const int co = co0 + k;
      if (co >= Co) break;
      float v = acc[p][k];
      if (bias != nullptr) v += bias[co];
      if (elu) v = v > 0.0f ? v : expm1f(v);
      out[(((long long)b * Co + co) * H + yo) * W + xo] = v;
    }
  }
}

int launch(const float* in, const float* w, const float* bias, float* out,
           int B, int Cin, int Hin, int Win, int Co, int pad, int transposed,
           int elu, cudaStream_t stream) {
  const int H = Hin + 2 * pad - 2, W = Win + 2 * pad - 2;
  if (B <= 0 || Cin <= 0 || Co <= 0 || H <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kTW, kWarps);
  if (Co == 1) {
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    conv3x3_kernel<1><<<grid, block, 0, stream>>>(
        in, w, bias, out, Cin, Hin, Win, Co, H, W, pad, transposed, elu, 1);
  } else {
    constexpr int kCOB = 8;
    const int groups = (Co + kCOB - 1) / kCOB;
    const dim3 grid(((W + kTW - 1) / kTW) * groups, (H + kTH - 1) / kTH, B);
    conv3x3_kernel<kCOB><<<grid, block, 0, stream>>>(
        in, w, bias, out, Cin, Hin, Win, Co, H, W, pad, transposed, elu,
        groups);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xp (B, Cin, H + 2, W + 2), w (Co, Cin, 3, 3), bias (Co) or null ->
// out (B, Co, H, W); elu != 0 applies ELU after the bias.
extern "C" int conv3x3_fwd(const float* xp, const float* w,
                           const float* bias, float* out, int B, int Cin,
                           int Hp, int Wp, int Co, int elu,
                           cudaStream_t stream) {
  return launch(xp, w, bias, out, B, Cin, Hp, Wp, Co, 0, 0, elu, stream);
}

// g (B, Co, H, W), the forward's w (Co, Cin, 3, 3) -> dxp
// (B, Cin, H + 2, W + 2), the gradient with respect to the forward's xp.
extern "C" int conv3x3_dgrad(const float* g, const float* w, float* dxp,
                             int B, int Co, int H, int W, int Cin,
                             cudaStream_t stream) {
  return launch(g, w, nullptr, dxp, B, Co, H, W, Cin, 2, 1, 0, stream);
}
