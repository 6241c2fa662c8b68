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
// What bounds it on this card: instruction issue and shared-memory reads,
// not memory (28 bytes a pixel) and not the special-function units.  The
// least work per gated-on pixel is 60 weights (the box sum, sqrt, a divide,
// exp) and 121 weighted terms, since the weights are symmetric:
// D_{-d}(p) = D_d(p + d), so w_{-d}(p) = w_d(p + d).
//
// Design: one weight plane per pair (d, -d) of the half set (dy = 0,
// dx = 1..5, then dy = 1..5, dx = -5..5; the TPU's symmetric order), built
// once and read at p and at p + d:
//   W(p)   = 1 + sum_d [w_d(p) + w_d(p + d)]
//   U_c(p) = (rgb_c(p) + sum_d [w_d(p) rgb_c(p - d) + w_d(p + d) rgb_c(p + d)])
//            / W(p)
// A block of 32x8 threads owns a 32x32 output tile (each thread 4 pixels of
// one column) and stages the tile's luminance with a 7-pixel halo and its
// rgb, padded to float4, with a 5-pixel halo, reading the halo straight from
// the NHWC image with modular indices (any H and W, smaller than the halo
// too).  Per pair, over the tile and its |d| halo, (32 + dy) x (32 + |dx|):
//   1. column 5-sums of the squared differences: a thread walks down an
//      8-row segment of one column, fully unrolled, with the segment's 12
//      differences in registers, so each is formed at most twice (once in
//      each of two segments) from two shared-memory reads (y and S_d y);
//   2. row 5-sums of those and the weights: a thread takes four
//      neighbouring cells, reads the eight column sums they need as two
//      16-byte loads, and writes the four weights as one;
//   3. each thread adds w_d(p) rgb(p - d) + w_d(p + d) rgb(p + d) to its own
//      pixels: two weights and two float4 rgb reads per pixel.
// Two barriers per pair.  Every 5-sum is an exact sum of its five terms in
// the TPU kernel's order (rows first, then columns; no running sum that
// subtracts), so each patch distance is bit for bit that of nlm_fwd_sym.cu:
// at h = 0 a weight is exactly 1 (distance 0) or 0 and a residue would flip
// it.  Only the order of the sum over offsets differs.  Plane
// widths are template parameters (|dx| = 0..5), so no loop over a plane
// divides by a runtime width.  Built without --use_fast_math (IEEE expf,
// sqrtf and 1 / W).  One change of rounding: the weight is
// exp(-s * (1 / hh)), 1 / hh formed once per block, where the plain version
// and nlm_fwd_sym.cu divide s / hh; a division per weight cost 11 % of the
// kernel's time on the H100, and U stays within 3e-7 of nlm_fwd_sym.cu's.

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
constexpr int CW = TW + 2 * SEARCH_R;     // rgb tile: 42 x 42 float4
constexpr int CH = TH + 2 * SEARCH_R;
constexpr int ROWS_MAX = TH + SEARCH_R;   // rows of a plane: 32 + dy
constexpr int CSP = 44;                   // column-sum pitch >= 32 + 5 + 4
constexpr int WSP = 40;                   // weight pitch >= 4 * ceil(37 / 4)
constexpr int LEN = 8;                    // rows of a column walk
constexpr int NSEG = (ROWS_MAX + LEN - 1) / LEN;

// shared-memory layout, in floats (the float4 plane first, 16-byte aligned)
constexpr int OFF_C = 0;
constexpr int OFF_Y = OFF_C + 4 * CH * CW;
constexpr int OFF_CS = OFF_Y + YH * YW;
constexpr int OFF_W = OFF_CS + ROWS_MAX * CSP;
constexpr int SMEM_FLOATS = OFF_W + ROWS_MAX * WSP;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(NSEG * (TW + SEARCH_R + 2 * PATCH_R) <= NT,
              "every column walk of a pair in one pass of the block");

__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// One pair (d, -d), d = (dy, dx) with |dx| = ADX: the weight plane w_d over
// image rows [y0, y0 + 32 + dy) and columns [x0 + lx, x0 + 32 + max(dx, 0)),
// lx = min(dx, 0), then each thread's pixels take both of its terms.
template <int ADX>
__device__ __forceinline__ void pair(int dy, int dx, float inv_hh,
                                     const float* __restrict__ ys,
                                     const float4* __restrict__ cs,
                                     float* __restrict__ csum,
                                     float* __restrict__ ws, int tid, int tx,
                                     int ty, float* acc_w, float* acc_r,
                                     float* acc_g, float* acc_b) {
  constexpr int NW = TW + ADX;            // weight columns
  constexpr int NC = NW + 2 * PATCH_R;    // column-sum columns
  constexpr int S2 = (NW + 3) / 4;        // four-cell groups of a row
  const int lx = dx < 0 ? dx : 0;
  const int rows = TH + dy;

  // 1. column sums at (y0 + r, x0 + lx - 2 + c): ys index (r + 7 + a - 2,
  //    lx + 5 + c) against its shift by d
  if (tid < NC * NSEG) {
    const int k = tid / NC, c = tid - k * NC;
    const int r0 = k * LEN;
    if (r0 < rows) {
      const float* ya =
          ys + (r0 + HALO - PATCH_R) * YW + (lx + SEARCH_R + c);
      const float* yb = ya - dy * YW - dx;
      float t[LEN + 2 * PATCH_R];
#pragma unroll
      for (int i = 0; i < LEN + 2 * PATCH_R; ++i)
        t[i] = r0 + i < rows + 2 * PATCH_R ? ya[i * YW] - yb[i * YW] : 0.0f;
#pragma unroll
      for (int i = 0; i < LEN; ++i) {
        if (r0 + i >= rows) break;
        float col = t[i] * t[i];  // rows first, as the TPU kernel
        col = fmaf(t[i + 1], t[i + 1], col);
        col = fmaf(t[i + 2], t[i + 2], col);
        col = fmaf(t[i + 3], t[i + 3], col);
        col = fmaf(t[i + 4], t[i + 4], col);
        csum[(r0 + i) * CSP + c] = col;
      }
    }
  }
  __syncthreads();

  // 2. then columns, and the weights, four cells at a time
  for (int i = tid; i < rows * S2; i += NT) {
    const int r = i / S2, c0 = 4 * (i - r * S2);
    const float4 lo = *reinterpret_cast<const float4*>(csum + r * CSP + c0);
    const float4 hi =
        *reinterpret_cast<const float4*>(csum + r * CSP + c0 + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float box = 0.0f;
#pragma unroll
      for (int b = 0; b < 5; ++b) box += v[j + b];
      w[j] = expf(-sqrtf(fmaxf(box, 0.0f)) * inv_hh);
    }
    *reinterpret_cast<float4*>(ws + r * WSP + c0) =
        make_float4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();

  // 3. w_d(p) pairs with rgb(p - d), w_d(p + d) = w_{-d}(p) with rgb(p + d)
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int ry = ty + k * BY;
    const float wf = ws[ry * WSP + tx - lx];
    const float wb = ws[(ry + dy) * WSP + tx + dx - lx];
    const int cr = ry + SEARCH_R, cc = tx + SEARCH_R;
    const float4 f = cs[(cr - dy) * CW + cc - dx];
    const float4 g = cs[(cr + dy) * CW + cc + dx];
    acc_w[k] += wf + wb;
    acc_r[k] += wf * f.x + wb * g.x;
    acc_g[k] += wf * f.y + wb * g.y;
    acc_b[k] += wf * f.z + wb * g.z;
  }
}

__global__ void __launch_bounds__(NT, 4)
nlm_fwd_kernel(const float* __restrict__ rgb, const float* __restrict__ h,
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

  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  float4* cs = sm4 + OFF_C / 4;
  float* ys = sm + OFF_Y;
  float* csum = sm + OFF_CS;
  float* ws = sm + OFF_W;
  const float* img = rgb + (size_t)n * plane * 3;
  for (int i = tid; i < YH * YW; i += NT) {
    const int r = i / YW, c = i % YW;
    const int gy = wrap(y0 - HALO + r, H), gx = wrap(x0 - HALO + c, W);
    const float* q = img + ((size_t)gy * W + gx) * 3;
    const float R = q[0], G = q[1], B = q[2];
    ys[i] = 0.299f * clip01(R) + 0.587f * clip01(G) + 0.114f * clip01(B);
    if (r >= PATCH_R && r < YH - PATCH_R && c >= PATCH_R &&
        c < YW - PATCH_R)
      cs[(r - PATCH_R) * CW + c - PATCH_R] = make_float4(R, G, B, 0.0f);
  }
  __syncthreads();

  const float inv_hh = 1.0f / (fmaxf(h[n], 0.0f) + 1e-8f);
  // the centre offset: weight 1, rgb(p)
  float acc_w[PER], acc_r[PER], acc_g[PER], acc_b[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const float4 c = cs[(ty + k * BY + SEARCH_R) * CW + tx + SEARCH_R];
    acc_w[k] = 1.0f;
    acc_r[k] = c.x;
    acc_g[k] = c.y;
    acc_b[k] = c.z;
  }

#pragma unroll 1
  for (int dy = 0; dy <= SEARCH_R; ++dy) {
#pragma unroll 1
    for (int dx = dy == 0 ? 1 : -SEARCH_R; dx <= SEARCH_R; ++dx) {
      switch (dx < 0 ? -dx : dx) {
#define NLM_PAIR(A)                                                       \
  case A:                                                                 \
    pair<A>(dy, dx, inv_hh, ys, cs, csum, ws, tid, tx, ty, acc_w, acc_r, acc_g, \
            acc_b);                                                       \
    break;
        NLM_PAIR(0)
        NLM_PAIR(1)
        NLM_PAIR(2)
        NLM_PAIR(3)
        NLM_PAIR(4)
        NLM_PAIR(5)
#undef NLM_PAIR
      }
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
// Launches on `stream`; returns the first CUDA error of the set-up or the
// launch.
extern "C" int nlm_gray_fwd(const float* rgb, const float* h,
                            const float* gate, float* u, float* wsum, int n,
                            int height, int width, void* stream) {
  if (n == 0 || height == 0 || width == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      nlm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(BX, BY);
  const dim3 grid((width + TW - 1) / TW, (height + TH - 1) / TH, n);
  nlm_fwd_kernel<<<grid, block, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(rgb, h, gate, u, wsum,
                                                        height, width);
  return static_cast<int>(cudaGetLastError());
}
