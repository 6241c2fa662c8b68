// Gated gray-guided non-local means, forward, symmetric offsets, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel adaptiveisp_tpu/ops/pallas/nlm.py::_nlm_kernel_sym
// (pallas_call at nlm.py:298 with sym=True).  Same function as nlm_fwd.cu
// (K1): U (unclipped) and W of the 121-offset gated gray NLM, circular
// borders, zeros and no other work for an image whose gate is exactly 0.
//
// The weights are symmetric: with D_d(p) = box5x5((y - S_d y)^2)(p) and
// (S_d x)(p) = x(p - d), D_{-d}(p) = D_d(p + d), so w_{-d}(p) = w_d(p + d).
// One plane w_d serves both d and -d: 60 computed offsets (dy = 0, dx = 1..5
// and dy = 1..5, dx = -5..5, the TPU kernel's order) plus the centre, whose
// weight is exp(0) = 1:
//   W(p)   = 1 + sum_d [w_d(p) + w_d(p + d)]
//   U_c(p) = (rgb_c(p) + sum_d [w_d(p) rgb_c(p - d) + w_d(p + d) rgb_c(p + d)])
//            / W(p)
// Each weight is bit for bit K1's (the same 25 squared differences, summed
// rows first, then columns); only the order of the sum over offsets differs.
//
// Design: a 32x32 output tile per block of 32x8 threads (each thread 4
// pixels, one column).  The block stages luminance with a 7-pixel halo and
// rgb with a 5-pixel halo in shared memory (modular indices, any H and W).
// Per offset the reuse of w_d at p + d crosses threads, so the block builds
// the plane over the tile plus its |d| halo, (32 + dy) x (32 + |dx|), in
// two shared-memory stages behind one barrier each: the 5-row column sums of
// the squared differences, then the 5-column sums and the weights.  Each
// thread then reads w_d at p and at p + d.  With K1's 32x8 tile the halo
// would cost (8 + dy)(32 + |dx|) / 256, about 1.5x the tile per offset;
// at 32x32 it is about 1.2x, so the work is about 0.6 of K1's.
//
// What bounds it on this card: arithmetic and shared-memory traffic, not
// memory (28 bytes a pixel).  Built without --use_fast_math, as K1.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int SEARCH_R = 5;               // 11x11 search window
constexpr int PATCH_R = 2;                // 5x5 patch box sum
constexpr int HALO = SEARCH_R + PATCH_R;  // 7
constexpr int TW = 32, TH = 32;           // output tile
constexpr int BX = 32, BY = 8;            // block; each thread TH / BY rows
constexpr int NT = BX * BY;
constexpr int PER = TH / BY;
constexpr int YW = TW + 2 * HALO;         // luminance tile: 46 x 46
constexpr int YH = TH + 2 * HALO;
constexpr int CW = TW + 2 * SEARCH_R;     // rgb tile: 42 x 42 per channel
constexpr int CH = TH + 2 * SEARCH_R;
constexpr int N_HALF = SEARCH_R + SEARCH_R * (2 * SEARCH_R + 1);  // 60
// largest planes of one offset: column sums (32 + 5) x (32 + 5 + 4),
// weights (32 + 5) x (32 + 5)
constexpr int COLS_MAX = (TH + SEARCH_R) * (TW + SEARCH_R + 2 * PATCH_R);
constexpr int WS_MAX = (TH + SEARCH_R) * (TW + SEARCH_R);

__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(NT)
nlm_fwd_sym_kernel(const float* __restrict__ rgb, const float* __restrict__ h,
                   const float* __restrict__ gate, float* __restrict__ u,
                   float* __restrict__ wsum, int H, int W) {
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BX + tx;
  const int px = x0 + tx;
  const size_t plane = (size_t)H * W;

  if (gate[n] == 0.0f) {  // uniform across the block: the whole block leaves
    if (px < W) {
      for (int k = 0; k < PER; ++k) {
        const int py = y0 + ty + k * BY;
        if (py >= H) break;
        const size_t pix = (size_t)n * plane + (size_t)py * W + px;
        u[3 * pix] = 0.0f;
        u[3 * pix + 1] = 0.0f;
        u[3 * pix + 2] = 0.0f;
        wsum[pix] = 0.0f;
      }
    }
    return;
  }

  __shared__ float ys[YH][YW];
  __shared__ float cs[3][CH][CW];
  __shared__ float cols[COLS_MAX];
  __shared__ float ws[WS_MAX];
  const float* img = rgb + (size_t)n * plane * 3;
  for (int i = tid; i < YH * YW; i += NT) {
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

  const float hh = fmaxf(h[n], 0.0f) + 1e-8f;
  // the centre offset: weight 1, rgb(p)
  float acc_w[PER], acc_r[PER], acc_g[PER], acc_b[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int r = ty + k * BY + SEARCH_R, c = tx + SEARCH_R;
    acc_w[k] = 1.0f;
    acc_r[k] = cs[0][r][c];
    acc_g[k] = cs[1][r][c];
    acc_b[k] = cs[2][r][c];
  }

#pragma unroll 1
  for (int j = 0; j < N_HALF; ++j) {
    int dy, dx;
    if (j < SEARCH_R) {
      dy = 0;
      dx = j + 1;
    } else {
      dy = 1 + (j - SEARCH_R) / (2 * SEARCH_R + 1);
      dx = (j - SEARCH_R) % (2 * SEARCH_R + 1) - SEARCH_R;
    }
    // w_d is needed at image rows [y0, y0 + TH + dy) and columns
    // [x0 + lx, x0 + TW + max(dx, 0)), lx = min(dx, 0)
    const int lx = dx < 0 ? dx : 0;
    const int n_rows = TH + dy;
    const int n_w = TW + (dx < 0 ? -dx : dx);  // weight columns
    const int n_c = n_w + 2 * PATCH_R;         // column-sum columns

    // column sums at (y0 + r, x0 + lx - 2 + c): ys index (r + 5 + a, lx + 5 + c)
    for (int i = tid; i < n_rows * n_c; i += NT) {
      const int r = i / n_c, c = i % n_c;
      const int yr = r + HALO - PATCH_R, yc = lx + HALO - PATCH_R + c;
      float col = 0.0f;  // rows first, as K1
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        const float t = ys[yr + a][yc] - ys[yr + a - dy][yc - dx];
        col += t * t;
      }
      cols[i] = col;
    }
    __syncthreads();
    for (int i = tid; i < n_rows * n_w; i += NT) {
      const int r = i / n_w, c = i % n_w;
      const float* cr = cols + r * n_c + c;
      float box = 0.0f;  // then columns, as K1
#pragma unroll
      for (int b = 0; b < 5; ++b) box += cr[b];
      ws[i] = expf(-sqrtf(fmaxf(box, 0.0f)) / hh);
    }
    __syncthreads();
    // w_d(p) pairs with rgb(p - d), w_d(p + d) = w_{-d}(p) with rgb(p + d)
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int ry = ty + k * BY;
      const float wf = ws[ry * n_w + tx - lx];
      const float wb = ws[(ry + dy) * n_w + tx + dx - lx];
      const int cr = ry + SEARCH_R, cc = tx + SEARCH_R;
      acc_w[k] += wf + wb;
      acc_r[k] += wf * cs[0][cr - dy][cc - dx] + wb * cs[0][cr + dy][cc + dx];
      acc_g[k] += wf * cs[1][cr - dy][cc - dx] + wb * cs[1][cr + dy][cc + dx];
      acc_b[k] += wf * cs[2][cr - dy][cc - dx] + wb * cs[2][cr + dy][cc + dx];
    }
  }

  if (px >= W) return;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int py = y0 + ty + k * BY;
    if (py >= H) break;
    const size_t pix = (size_t)n * plane + (size_t)py * W + px;
    const float inv = 1.0f / acc_w[k];
    u[3 * pix] = acc_r[k] * inv;
    u[3 * pix + 1] = acc_g[k] * inv;
    u[3 * pix + 2] = acc_b[k] * inv;
    wsum[pix] = acc_w[k];
  }
}

}  // namespace

// rgb [n, height, width, 3], h [n], gate [n], u [n, height, width, 3],
// wsum [n, height, width]: contiguous float32 on the current device.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int nlm_gray_fwd_sym(const float* rgb, const float* h,
                                const float* gate, float* u, float* wsum,
                                int n, int height, int width, void* stream) {
  if (n == 0 || height == 0 || width == 0) return 0;
  const dim3 block(BX, BY);
  const dim3 grid((width + TW - 1) / TW, (height + TH - 1) / TH, n);
  nlm_fwd_sym_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rgb, h, gate, u, wsum, height, width);
  return static_cast<int>(cudaGetLastError());
}
