// Gated gray-guided non-local means, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel adaptiveisp_tpu/ops/pallas/nlm.py::_nlm_kernel
// (driven by _nlm_forward_uw, pallas_call at nlm.py:298).  Same function:
//   y      = 0.299 r + 0.587 g + 0.114 b of clip(rgb, 0, 1)
//   w_d(p) = exp(-sqrt(max(box5x5((y - S_d y)^2)(p), 0)) / (max(h, 0) + 1e-8))
//            for the 121 offsets d of the 11x11 search window, where
//            (S_d x)(p) = x(p - d) with circular (wrap-around) boundaries
//   W(p)   = sum_d w_d(p),  U_c(p) = sum_d w_d(p) rgb_c(p - d) / W(p)
// U (unclipped) and W are written, as the TPU kernel writes them, because the
// backward needs both.  An image whose gate is exactly 0 writes zeros and
// does no other work.
//
// Design: one thread per output pixel, a 32x8 block per output tile.  The
// block stages the tile's luminance with a 7-pixel halo (5 search + 2 patch)
// and its rgb with a 5-pixel halo in shared memory, reading the halo straight
// from the NHWC image with modular row and column indices, so any H and W
// work (the TPU's host-side halo concatenation and overlapping row windows
// exist only for its BlockSpecs).  Each thread keeps its own 5x5 luminance
// patch in registers and sums the 25 squared differences of every offset
// directly.
//
// What bounds it on this card: arithmetic, not memory.  Per pixel it moves
// 28 bytes but does 121 offsets x (25 subtract + 25 multiply-add + sqrt,
// divide, exp + 4 multiply-add); the sqrt/exp run on the special-function
// units, which have an eighth of the FP32 issue rate.  A separable box sum
// shared between neighbouring pixels would cut the 50 FP32 operations per
// offset to about 12; that is later work.  Built without --use_fast_math so
// expf/sqrtf/division stay IEEE-accurate and the result stays within 2e-5
// of the plain PyTorch version.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int SEARCH_R = 5;               // 11x11 search window
constexpr int PATCH_R = 2;                // 5x5 patch box sum
constexpr int HALO = SEARCH_R + PATCH_R;  // 7
constexpr int TW = 32;                    // output tile width  (= blockDim.x)
constexpr int TH = 8;                     // output tile height (= blockDim.y)
constexpr int YW = TW + 2 * HALO;         // luminance tile: 46 x 22
constexpr int YH = TH + 2 * HALO;
constexpr int CW = TW + 2 * SEARCH_R;     // rgb tile: 42 x 18 per channel
constexpr int CH = TH + 2 * SEARCH_R;

__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(TW * TH)
nlm_fwd_kernel(const float* __restrict__ rgb, const float* __restrict__ h,
               const float* __restrict__ gate, float* __restrict__ u,
               float* __restrict__ wsum, int H, int W) {
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int px = x0 + tx, py = y0 + ty;
  const bool inside = px < W && py < H;
  const size_t plane = (size_t)H * W;
  const size_t pix = (size_t)n * plane + (size_t)py * W + px;

  if (gate[n] == 0.0f) {  // uniform across the block: the whole block leaves
    if (inside) {
      u[3 * pix] = 0.0f;
      u[3 * pix + 1] = 0.0f;
      u[3 * pix + 2] = 0.0f;
      wsum[pix] = 0.0f;
    }
    return;
  }

  __shared__ float ys[YH][YW];
  __shared__ float cs[3][CH][CW];
  const float* img = rgb + (size_t)n * plane * 3;
  for (int i = ty * TW + tx; i < YH * YW; i += TW * TH) {
    const int r = i / YW, c = i % YW;
    const int gy = wrap(y0 - HALO + r, H), gx = wrap(x0 - HALO + c, W);
    const float* q = img + ((size_t)gy * W + gx) * 3;
    const float R = q[0], G = q[1], B = q[2];
    ys[r][c] = 0.299f * clip01(R) + 0.587f * clip01(G) + 0.114f * clip01(B);
    if (r >= PATCH_R && r < YH - PATCH_R && c >= PATCH_R &&
        c < YW - PATCH_R) {
      cs[0][r - PATCH_R][c - PATCH_R] = R;
      cs[1][r - PATCH_R][c - PATCH_R] = G;
      cs[2][r - PATCH_R][c - PATCH_R] = B;
    }
  }
  __syncthreads();
  if (!inside) return;

  const float hh = fmaxf(h[n], 0.0f) + 1e-8f;
  // centre patch y(p + (a - 2, b - 2)), kept in registers for all offsets
  float yc[5][5];
#pragma unroll
  for (int a = 0; a < 5; ++a)
#pragma unroll
    for (int b = 0; b < 5; ++b)
      yc[a][b] = ys[ty + SEARCH_R + a][tx + SEARCH_R + b];

  float acc_w = 0.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
#pragma unroll 1
  for (int dx = -SEARCH_R; dx <= SEARCH_R; ++dx) {
#pragma unroll 1
    for (int dy = -SEARCH_R; dy <= SEARCH_R; ++dy) {
      // shifted patch y(p + (a - 2, b - 2) - d) starts at ys[r0][c0];
      // the same (r0, c0) is rgb(p - d) in the rgb tile
      const int r0 = ty + SEARCH_R - dy, c0 = tx + SEARCH_R - dx;
      float box = 0.0f;
#pragma unroll
      for (int b = 0; b < 5; ++b) {
        float col = 0.0f;  // rows first, then columns, as the TPU kernel
#pragma unroll
        for (int a = 0; a < 5; ++a) {
          const float t = yc[a][b] - ys[r0 + a][c0 + b];
          col += t * t;
        }
        box += col;
      }
      const float w = expf(-sqrtf(fmaxf(box, 0.0f)) / hh);
      acc_w += w;
      acc_r += w * cs[0][r0][c0];
      acc_g += w * cs[1][r0][c0];
      acc_b += w * cs[2][r0][c0];
    }
  }
  const float inv = 1.0f / acc_w;
  u[3 * pix] = acc_r * inv;
  u[3 * pix + 1] = acc_g * inv;
  u[3 * pix + 2] = acc_b * inv;
  wsum[pix] = acc_w;
}

}  // namespace

// rgb [n, height, width, 3], h [n], gate [n], u [n, height, width, 3],
// wsum [n, height, width]: contiguous float32 on the current device.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int nlm_gray_fwd(const float* rgb, const float* h,
                            const float* gate, float* u, float* wsum, int n,
                            int height, int width, void* stream) {
  if (n == 0 || height == 0 || width == 0) return 0;
  const dim3 block(TW, TH);
  const dim3 grid((width + TW - 1) / TW, (height + TH - 1) / TH, n);
  nlm_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rgb, h, gate, u, wsum, height, width);
  return static_cast<int>(cudaGetLastError());
}
