// Gated gray-guided non-local means, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel adaptiveisp_tpu/ops/pallas/nlm.py::_nlm_bwd_kernel
// (driven by _nlm_backward, pallas_call at nlm.py:489).  The forward
// (nlm_fwd.cu) computes, with S_d x(p) = x(p - d) circular,
//   y = lum(clip(rgb, 0, 1)),  b_d = box5x5((y - S_d y)^2),
//   s_d = sqrt(b_d) where b_d > 0 else 0,  w_d = exp(-s_d / hh),
//   W = sum_d w_d,  O_c = sum_d w_d S_d rgb_c,  U_c = O_c / W.
// Given v = dL/dU (after the output clip), this kernel returns dL/drgb and
// per-block partial sums of dL/dhh.  With a_c = v_c / W and
// q = -(sum_c v_c U_c) / W, dL/dw_d = g_d = sum_c a_c S_d rgb_c + q.
//
// The offsets come in pairs: b_{-d}(p) = b_d(p + d), so s and w too, and
// y - S_{-d} y = -S_{-d}(y - S_d y).  One weight chain (b_d, s_d, w_d) per
// offset d of the half set (dy = 0, dx = 1..5, then dy = 1..5,
// dx = -5..5) serves d and -d.  With g'_d = sum_c (S_d a_c) rgb_c + S_d q
// (dL/dw_{-d} moved onto the d-grid), each pair adds
//   direct:    dL/drgb_c += S_-d(w_d a_c) + w_d S_d a_c
//   strength:  dL/dhh    += sum_p w_d s_d (g_d + g'_d) / hh^2
//   luminance: db = -(g_d + g'_d) w_d / (2 hh s_d) where b_d > 0 else 0 (a
//              select, never inf * 0), Z = 2 (y - S_d y) box5x5(db),
//              dL/dy += Z - S_-d Z
// (one box sum of db serves both offsets: the box sum is linear), the
// centre adds dL/drgb_c += a_c, and dL/drgb_c += lum_c clipmask(rgb_c) dL/dy
// with clipmask = 1 inside (0, 1), 0.5 at an exact 0 or 1 (JAX's clip
// gradient), 0 outside.  An image whose gate is exactly 0 writes zeros: its
// forward W is 0 there, so 1/W is never formed.
//
// What bounds it on this card: shared-memory traffic and instruction issue,
// not memory (52 bytes a gated-on pixel) and not the special-function units.
// The arithmetic is 60 weight chains (sqrt, exp, a divide) a pixel and both
// offsets' adjoints; every cell of a chain reads (a, q) and rgb at two
// pixels, 16 shared words.
//
// Design: gather, never scatter.  A block of 32x8 threads owns a 32x32
// output tile (each thread 4 pixels of one column) and stages the luminance
// with a 9-pixel halo, rgb and (a_0, a_1, a_2, q) with a 7-pixel halo, both
// as float4, read straight from the NHWC tensors with modular indices (any
// H and W, smaller than the halo too).  Each thread keeps (a, q) and rgb of
// its own pixels in registers.  Per pair, over the region the adjoint
// gathers from (the tile and the tile moved by d, plus the box sum's 2
// pixels: (36 + dy) x (36 + |dx|) cells), four stages, one barrier after
// each:
//   1. column 5-sums of (y - S_d y)^2: a thread walks down a 10-row segment
//      of one column, fully unrolled, its 14 differences in registers;
//   2. row 5-sums of those, the weight chain, g_d + g'_d, the strength term
//      and db + db': the tile's cells by the threads that own them, which
//      read only (a, q) and rgb at r - d (two float4s) and add the direct
//      term w(r) a_c(r - d) at once; then the cells around the tile, one a
//      thread (four float4s; neighbouring lanes on neighbouring cells, so
//      no bank conflicts);
//   3. column 5-sums of db + db', a column walk as in 1;
//   4. row 5-sums of those times 2 (y - S_d y): Z on the tile and the tile
//      moved by d;
// then each thread gathers its pixels' Z(r) - Z(r + d) and w(r + d) a(r + d).
// Every 5-sum is an exact sum of its five terms in the forward's order
// (rows first; no running sum that subtracts), so each weight is the
// forward's: at h = 0 a weight is exactly 1 or 0 and a residue would flip
// it.  Plane widths are template parameters (|dx| = 0..5): no loop over a
// plane divides by a runtime width.  dL/dhh leaves as one partial sum per
// block (each thread's cells in a fixed order, then a fixed tree), summed
// by the wrapper: no float atomics, results repeat bit for bit.  Built
// without --use_fast_math (IEEE expf, sqrtf and division).  The weight is
// exp(-s * (1 / hh)), as the forward computes it (1 / hh formed once per
// block), where the plain version divides s / hh; db keeps its division.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int SEARCH_R = 5;  // 11x11 search window
constexpr int PATCH_R = 2;   // 5x5 patch box sum
constexpr int TW = 32;       // output tile width  (= blockDim.x)
constexpr int TH = 32;       // output tile height
constexpr int BX = 32, BY = 8;
constexpr int NT = BX * BY;
constexpr int PER = TH / BY;

constexpr int HC = SEARCH_R + PATCH_R;  // rgb and (a, q): 7
constexpr int HY = HC + PATCH_R;        // luminance: 9
constexpr int YW = TW + 2 * HY, YH = TH + 2 * HY;  // 50 x 50
constexpr int CW = TW + 2 * HC, CH = TH + 2 * HC;  // 46 x 46 float4

// planes of one pair, largest at |d| = 5: the chain region X is
// (32 + dy + 4) x (32 + |dx| + 4), its column sums 4 columns wider
constexpr int X_MAX = TW + SEARCH_R + 2 * PATCH_R;  // 41
constexpr int CSP = 45;   // column sums (and box sums of db), 41 + 4
constexpr int XP = 41;    // weights and db over X
constexpr int ZP = 37;    // Z
constexpr int LEN = 10;   // rows of a column walk
constexpr int NSEG = (X_MAX + LEN - 1) / LEN;

// shared-memory layout, in floats (float4 planes first, 16-byte aligned)
constexpr int OFF_C = 0;                    // rgb, float4
constexpr int OFF_AQ = OFF_C + 4 * CH * CW;  // (a_0, a_1, a_2, q), float4
constexpr int OFF_Y = OFF_AQ + 4 * CH * CW;
constexpr int OFF_CS = OFF_Y + YH * YW;      // column sums; box sums of db
constexpr int OFF_DB = OFF_CS + X_MAX * CSP;  // db; Z
constexpr int OFF_W = OFF_DB + X_MAX * XP;
constexpr int SMEM_FLOATS = OFF_W + X_MAX * XP;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(NSEG * (X_MAX + 2 * PATCH_R) <= NT,
              "every column walk of a pair in one pass of the block");
static_assert(X_MAX * CSP >= NT, "the column-sum plane doubles as the "
              "reduction");
static_assert((TH + SEARCH_R) * ZP <= X_MAX * XP, "Z fits the db plane");

__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float clip_mask(float x) {
  if (x > 0.0f && x < 1.0f) return 1.0f;
  return (x == 0.0f || x == 1.0f) ? 0.5f : 0.0f;
}

// (a, q) and rgb of the PER pixels a thread owns, kept in registers
struct Own {
  float4 aq[PER], rgb[PER];
};

struct Planes {
  const float4* rgb;  // [CH][CW], tile coordinates + 7
  const float4* aq;   // [CH][CW]
  const float* y;     // [YH][YW], tile coordinates + 9
  float* cs;          // column sums [X rows][CSP]; box sums of db [Z rows][CSP]
  float* db;          // db over X [X rows][XP]; Z [Z rows][ZP]
  float* w;           // weights over X [X rows][XP]
};

// a column walk over the rows [r0, r0 + LEN) of [0, rows), r0 = LEN seg,
// fully unrolled: out[r * CSP] = sum_{i=0..4} term(r + i) in that order,
// term(i) = a[i * pitch] - b[i * pitch] (squared) or a[i * pitch]
template <bool SQUARED_DIFF>
__device__ __forceinline__ void column_walk(const float* a, const float* b,
                                            int pitch, int rows, int seg,
                                            float* out) {
  const int r0 = seg * LEN;
  if (r0 >= rows) return;
  a += r0 * pitch;
  b += r0 * pitch;
  out += r0 * CSP;
  float t[LEN + 2 * PATCH_R];
#pragma unroll
  for (int i = 0; i < LEN + 2 * PATCH_R; ++i) {
    t[i] = 0.0f;
    if (r0 + i < rows + 2 * PATCH_R) {
      if constexpr (SQUARED_DIFF) t[i] = a[i * pitch] - b[i * pitch];
      else t[i] = a[i * pitch];
    }
  }
#pragma unroll
  for (int i = 0; i < LEN; ++i) {
    if (r0 + i >= rows) break;
    float s;
    if constexpr (SQUARED_DIFF) {  // as the forward: fma from the top row
      s = t[i] * t[i];
      s = fmaf(t[i + 1], t[i + 1], s);
      s = fmaf(t[i + 2], t[i + 2], s);
      s = fmaf(t[i + 3], t[i + 3], s);
      s = fmaf(t[i + 4], t[i + 4], s);
    } else {
      s = t[i] + t[i + 1] + t[i + 2] + t[i + 3] + t[i + 4];
    }
    out[i * CSP] = s;
  }
}

// the weight chain of one cell from its five column sums: b (rows first,
// then columns, as the forward), s = sqrt(b) where b > 0 else 0, and
// w = exp(-s * (1 / hh)) as the forward computes it
struct Chain {
  bool pos;
  float s, w;
};

__device__ __forceinline__ Chain chain(const float* v, float inv_hh) {
  float b = 0.0f;
#pragma unroll
  for (int e = 0; e < 5; ++e) b += v[e];
  Chain c;
  c.pos = b > 0.0f;
  c.s = c.pos ? sqrtf(b) : 0.0f;
  c.w = expf(-c.s * inv_hh);
  return c;
}

// (g_d + g'_d) at a cell x from (a, q) and rgb at x and at x - d
__device__ __forceinline__ float g_pair(float4 ax, float4 cx, float4 am,
                                        float4 cm) {
  float g = ax.w;  // dL/dw_d at x
  g += ax.x * cm.x;
  g += ax.y * cm.y;
  g += ax.z * cm.z;
  float g2 = am.w;  // dL/dw_{-d} at x - d
  g2 += am.x * cx.x;
  g2 += am.y * cx.y;
  g2 += am.z * cx.z;
  return g + g2;
}

// One pair (d, -d), d = (dy, dx) with |dx| = ADX, lx = min(dx, 0).  Plane
// coordinates: X row xr is tile row xr - 2, X column xc is tile column
// lx - 2 + xc; Z row zr is tile row zr, Z column zc is tile column lx + zc.
template <int ADX>
__device__ __forceinline__ void pair(int dy, int dx, float hh, float inv_hh,
                                     const Planes& p, const Own& own,
                                     int tid, int tx, int ty, int h_rows,
                                     int h_cols, float* acc_c, float* acc_y,
                                     float& acc_h) {
  constexpr int XC = TW + ADX + 2 * PATCH_R;  // X columns
  constexpr int NCS = XC + 2 * PATCH_R;       // column-sum columns
  constexpr int ZC = TW + ADX;                // Z columns
  constexpr int SIDE = 2 * PATCH_R + ADX;     // X columns beside the tile
  const int lx = dx < 0 ? dx : 0;
  const int xrows = TH + dy + 2 * PATCH_R;
  const int zrows = TH + dy;

  // 1. column sums of (y - S_d y)^2 at X rows, tile columns lx - 4 + c
  if (tid < NCS * NSEG) {
    const int k = tid / NCS, c = tid - k * NCS;
    const float* ya = p.y + (HY - 2 * PATCH_R) * YW + (lx + HY - 4 + c);
    column_walk<true>(ya, ya - dy * YW - dx, YW, xrows, k, p.cs + c);
  }
  __syncthreads();

  // 2. row sums, the weight chain and its adjoints over X.  First the
  //    tile's cells, each by the thread that owns the pixel: (a, q) and rgb
  //    at the pixel are in its registers, so it reads only those at
  //    r - d, and adds the direct term w(r) a_c(r - d) itself.
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int ry = ty + k * BY;
    const int xr = ry + PATCH_R, xc = tx - lx + PATCH_R;
    const Chain c = chain(p.cs + xr * CSP + xc, inv_hh);
    const int back = (ry - dy + HC) * CW + tx - dx + HC;
    const float4 am = p.aq[back];
    const float gww = g_pair(own.aq[k], own.rgb[k], am, p.rgb[back]) * c.w;
    p.w[xr * XP + xc] = c.w;
    p.db[xr * XP + xc] = c.pos ? -0.5f * gww / (hh * c.s) : 0.0f;
    if (ry < h_rows && tx < h_cols) acc_h += gww * c.s;
    acc_c[3 * k] += c.w * am.x;
    acc_c[3 * k + 1] += c.w * am.y;
    acc_c[3 * k + 2] += c.w * am.z;
  }
  //    Then the rest of X: the 2 + 2 + dy full rows above and below the
  //    tile, and the SIDE columns left and right of it on its rows
  const int left = PATCH_R - lx;
  const int bands = (2 * PATCH_R + dy) * XC;
  for (int i = tid; i < bands + TH * SIDE; i += NT) {
    int xr, xc;
    if (i < bands) {
      const int q = i / XC;
      xc = i - q * XC;
      xr = q < PATCH_R ? q : q + TH;
    } else {
      const int j = i - bands, q = j / SIDE, cc = j - q * SIDE;
      xr = q + PATCH_R;
      xc = cc < left ? cc : cc + TW;
    }
    const Chain c = chain(p.cs + xr * CSP + xc, inv_hh);
    const int here = (xr - PATCH_R + HC) * CW + lx - PATCH_R + xc + HC;
    const int back = here - dy * CW - dx;
    const float gww =
        g_pair(p.aq[here], p.rgb[here], p.aq[back], p.rgb[back]) * c.w;
    p.w[xr * XP + xc] = c.w;
    p.db[xr * XP + xc] = c.pos ? -0.5f * gww / (hh * c.s) : 0.0f;
  }
  __syncthreads();

  // 3. column sums of db at Z rows, X columns
  if (tid < XC * NSEG) {
    const int k = tid / XC, c = tid - k * XC;
    column_walk<false>(p.db + c, p.db + c, XP, zrows, k, p.cs + c);
  }
  __syncthreads();

  // 4. Z = 2 (y - S_d y) box5x5(db) on the tile and the tile moved by d,
  //    one cell a thread
  for (int i = tid; i < zrows * ZC; i += NT) {
    const int zr = i / ZC, zc = i - zr * ZC;
    const float* v = p.cs + zr * CSP + zc;
    float dd = 0.0f;
#pragma unroll
    for (int e = 0; e < 5; ++e) dd += v[e];
    const float* yr = p.y + (zr + HY) * YW + lx + HY + zc;
    p.db[zr * ZP + zc] = 2.0f * (yr[0] - yr[-dy * YW - dx]) * dd;
  }
  __syncthreads();

  // 5. this thread's pixels r gather Z(r) - Z(r + d) and w(r + d) a_c(r + d);
  //    the next writes of these planes are a barrier away
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int ry = ty + k * BY;
    acc_y[k] += p.db[ry * ZP + tx - lx];
    acc_y[k] -= p.db[(ry + dy) * ZP + tx + dx - lx];
    const float wb = p.w[(ry + dy + PATCH_R) * XP + tx + dx - lx + PATCH_R];
    const float4 ap = p.aq[(ry + dy + HC) * CW + tx + dx + HC];
    acc_c[3 * k] += wb * ap.x;
    acc_c[3 * k + 1] += wb * ap.y;
    acc_c[3 * k + 2] += wb * ap.z;
  }
}

__global__ void __launch_bounds__(NT, 2)
nlm_bwd_kernel(const float* __restrict__ rgb, const float* __restrict__ h,
               const float* __restrict__ gate, const float* __restrict__ v,
               const float* __restrict__ u, const float* __restrict__ wsum,
               float* __restrict__ drgb, float* __restrict__ dh_part, int H,
               int W) {
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  const int px = x0 + tx;
  const size_t plane = (size_t)H * W;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t part = (size_t)n * gridDim.x * gridDim.y + blk;

  if (gate[n] == 0.0f) {  // uniform across the block: the whole block leaves
    if (px < W) {
      for (int k = 0; k < PER; ++k) {
        const int py = y0 + ty + k * BY;
        if (py >= H) break;
        const size_t pix = (size_t)n * plane + (size_t)py * W + px;
        drgb[3 * pix] = 0.0f;
        drgb[3 * pix + 1] = 0.0f;
        drgb[3 * pix + 2] = 0.0f;
      }
    }
    if (tid == 0) dh_part[part] = 0.0f;
    return;
  }

  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  float4* cs = sm4 + OFF_C / 4;
  float4* aq = sm4 + OFF_AQ / 4;
  float* ys = sm + OFF_Y;

  const size_t img = (size_t)n * plane;
  for (int i = tid; i < YH * YW; i += NT) {
    const int r = i / YW - HY, c = i % YW - HY;
    const size_t g = img + (size_t)wrap(y0 + r, H) * W + wrap(x0 + c, W);
    const float* q = rgb + 3 * g;
    const float R = q[0], G = q[1], B = q[2];
    ys[i] = 0.299f * clip01(R) + 0.587f * clip01(G) + 0.114f * clip01(B);
    if (r >= -HC && r < TH + HC && c >= -HC && c < TW + HC) {
      const int e = (r + HC) * CW + c + HC;
      cs[e] = make_float4(R, G, B, 0.0f);
      const float wg = wsum[g];
      const float* vg = v + 3 * g;
      const float* ug = u + 3 * g;
      aq[e] = make_float4(vg[0] / wg, vg[1] / wg, vg[2] / wg,
                          -(vg[0] * ug[0] + vg[1] * ug[1] + vg[2] * ug[2]) /
                              wg);
    }
  }
  __syncthreads();

  const Planes p{cs, aq, ys, sm + OFF_CS, sm + OFF_DB, sm + OFF_W};
  const float hh = fmaxf(h[n], 0.0f) + 1e-8f, inv_hh = 1.0f / hh;
  // the strength term counts the tile's cells inside the image
  const int h_rows = min(TH, H - y0), h_cols = min(TW, W - x0);
  Own own;
  float acc_c[3 * PER];  // the centre: dL/drgb_c += a_c
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = (ty + k * BY + HC) * CW + tx + HC;
    own.aq[k] = aq[e];
    own.rgb[k] = cs[e];
    acc_c[3 * k] = own.aq[k].x;
    acc_c[3 * k + 1] = own.aq[k].y;
    acc_c[3 * k + 2] = own.aq[k].z;
  }
  float acc_y[PER] = {};
  float acc_h = 0.0f;

#pragma unroll 1
  for (int dy = 0; dy <= SEARCH_R; ++dy) {
#pragma unroll 1
    for (int dx = dy == 0 ? 1 : -SEARCH_R; dx <= SEARCH_R; ++dx) {
      switch (dx < 0 ? -dx : dx) {
#define NLM_PAIR(A)                                                     \
  case A:                                                               \
    pair<A>(dy, dx, hh, inv_hh, p, own, tid, tx, ty, h_rows, h_cols, acc_c, \
            acc_y, acc_h);                                              \
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

  if (px < W) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int ry = ty + k * BY, py = y0 + ry;
      if (py >= H) break;
      const size_t pix = (size_t)n * plane + (size_t)py * W + px;
      const float4 c = own.rgb[k];
      drgb[3 * pix] = acc_c[3 * k] + 0.299f * clip_mask(c.x) * acc_y[k];
      drgb[3 * pix + 1] =
          acc_c[3 * k + 1] + 0.587f * clip_mask(c.y) * acc_y[k];
      drgb[3 * pix + 2] =
          acc_c[3 * k + 2] + 0.114f * clip_mask(c.z) * acc_y[k];
    }
  }
  // fixed-order tree sum of the block's strength terms (the column-sum
  // plane is free: every thread is past the last pair's barriers)
  __syncthreads();
  float* red = sm + OFF_CS;
  red[tid] = acc_h;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) dh_part[part] = red[0] / (hh * hh);
}

}  // namespace

// rgb, v, u [n, height, width, 3]; wsum [n, height, width]; h, gate [n];
// drgb [n, height, width, 3]; dh_part [n, nlm_gray_bwd_blocks(height,
// width)]: contiguous float32 on the current device.  Launches on `stream`;
// returns the first CUDA error of the set-up or the launch.
extern "C" int nlm_gray_bwd(const float* rgb, const float* h,
                            const float* gate, const float* v, const float* u,
                            const float* wsum, float* drgb, float* dh_part,
                            int n, int height, int width, void* stream) {
  if (n == 0 || height == 0 || width == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      nlm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(BX, BY);
  const dim3 grid((width + TW - 1) / TW, (height + TH - 1) / TH, n);
  nlm_bwd_kernel<<<grid, block, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(
      rgb, h, gate, v, u, wsum, drgb, dh_part, height, width);
  return static_cast<int>(cudaGetLastError());
}

// blocks per image of the dh_part table, for the wrapper's allocation
extern "C" int nlm_gray_bwd_blocks(int height, int width) {
  return ((width + TW - 1) / TW) * ((height + TH - 1) / TH);
}
