// Gated gray-guided non-local means, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel adaptiveisp_tpu/ops/pallas/nlm.py::_nlm_bwd_kernel
// (driven by _nlm_backward, pallas_call at nlm.py:489).  The forward
// (nlm_fwd.cu) computes, with S_d x(p) = x(p - d) circular,
//   y = lum(clip(rgb, 0, 1)),  b_d = box5x5((y - S_d y)^2),
//   s_d = sqrt(b_d) where b_d > 0 else 0,  w_d = exp(-s_d / hh),
//   W = sum_d w_d,  O_c = sum_d w_d S_d rgb_c,  U_c = O_c / W.
// Given v = dL/dU (after the output clip), this kernel returns dL/drgb and
// per-block partial sums of dL/dhh, through four adjoint paths
// (derivation at nlm.py:343-364):
//   a_c = v_c / W,  q = -(sum_c v_c U_c) / W
//   g_w = sum_c a_c S_d rgb_c + q                       (dL/dw_d)
//   direct:    dL/drgb_c  += S_-d(w_d a_c)
//   strength:  dL/dhh     += sum_p g_w w_d s_d / hh^2
//   luminance: db = -0.5 g_w w_d / (hh s_d) where b_d > 0 else 0 (a select,
//              never inf * 0),  z = 2 (y - S_d y) box5x5(db),
//              dL/dy += z - S_-d z,  dL/drgb_c += lum_c clipmask(rgb_c) dL/dy
// with clipmask = 1 inside (0, 1), 0.5 at an exact 0 or 1 (JAX's clip
// gradient), 0 outside.  An image whose gate is exactly 0 writes zeros: its
// forward W is 0 there, so 1/W is never formed.
//
// Design: gather, never scatter.  One thread per output pixel, a 32x16 block
// per output tile.  The block stages the luminance with a 14-pixel halo, rgb
// with a 12-pixel halo and (a_c, q) with a 7-pixel halo in shared memory,
// read straight from the NHWC tensors with modular indices (any H and W).
// Then, for each of the 121 offsets, it recomputes the chain on the halo
// regions the adjoint gathers from -- d2 on 9 pixels around the tile, the
// weight chain and db on 7, z on 5 -- one shared-memory plane per stage with
// a barrier between stages, and each thread accumulates its own pixel.
// dL/dhh leaves as one partial sum per block, reduced in a fixed tree and
// summed by the wrapper: no float atomics, results repeat bit for bit.
//
// What bounds it on this card: arithmetic.  Per gated-on pixel and offset it
// needs about 45 operations (sqrt, exp and two divisions among them) and
// moves 40 bytes in, 12 out per pixel over all offsets.  The halo
// recomputation (the chain runs on 46x30 cells for a 32x16 tile) and five
// barriers per offset put it well above that bound; a first kernel that is
// right comes first.  Built without --use_fast_math (IEEE expf, sqrtf and
// division), as the forward.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int SEARCH_R = 5;  // 11x11 search window
constexpr int PATCH_R = 2;   // 5x5 patch box sum
constexpr int TW = 32;       // output tile width  (= blockDim.x)
constexpr int TH = 16;       // output tile height (= blockDim.y)
constexpr int NT = TW * TH;

// halo widths, in pixels on every side of the tile
constexpr int HZ = SEARCH_R;        // z, read at r and r + d
constexpr int HB = HZ + PATCH_R;    // weight chain and db
constexpr int HD = HB + PATCH_R;    // squared luminance differences
constexpr int HY = HD + SEARCH_R;   // luminance
constexpr int HC = HB + SEARCH_R;   // rgb, read at chain cell - d

template <int H>
struct Reg {  // a region of the tile plus an H-pixel halo
  static constexpr int R = TH + 2 * H, C = TW + 2 * H, N = R * C;
};

// shared-memory planes, in floats
constexpr int OFF_Y = 0;
constexpr int OFF_C = OFF_Y + Reg<HY>::N;          // 3 planes
constexpr int OFF_AQ = OFF_C + 3 * Reg<HC>::N;     // a_0, a_1, a_2, q
constexpr int OFF_D2 = OFF_AQ + 4 * Reg<HB>::N;
constexpr int N_VS = Reg<HB>::R * Reg<HD>::C;      // rows of HB, cols of HD
constexpr int OFF_VS = OFF_D2 + Reg<HD>::N;
constexpr int OFF_W = OFF_VS + N_VS;
constexpr int OFF_DB = OFF_W + Reg<HB>::N;
constexpr int N_VDB = Reg<HZ>::R * Reg<HB>::C;     // rows of HZ, cols of HB
constexpr int OFF_VDB = OFF_DB + Reg<HB>::N;
constexpr int OFF_Z = OFF_VDB + N_VDB;
constexpr int OFF_HS = OFF_Z + Reg<HZ>::N;
constexpr int SMEM_FLOATS = OFF_HS + NT;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(Reg<HD>::N >= NT, "the d2 plane doubles as the reduction");

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

// element (r, c), tile coordinates, of a plane with an H-pixel halo
template <int H>
__device__ __forceinline__ int at(int r, int c) {
  return (r + H) * Reg<H>::C + (c + H);
}

__global__ void __launch_bounds__(NT, 2)
nlm_bwd_kernel(const float* __restrict__ rgb, const float* __restrict__ h,
               const float* __restrict__ gate, const float* __restrict__ v,
               const float* __restrict__ u, const float* __restrict__ wsum,
               float* __restrict__ drgb, float* __restrict__ dh_part, int H,
               int W) {
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;
  const int px = x0 + tx, py = y0 + ty;
  const bool inside = px < W && py < H;
  const size_t plane = (size_t)H * W;
  const size_t pix = (size_t)n * plane + (size_t)py * W + px;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t part = (size_t)n * gridDim.x * gridDim.y + blk;

  if (gate[n] == 0.0f) {  // uniform across the block: the whole block leaves
    if (inside) {
      drgb[3 * pix] = 0.0f;
      drgb[3 * pix + 1] = 0.0f;
      drgb[3 * pix + 2] = 0.0f;
    }
    if (tid == 0) dh_part[part] = 0.0f;
    return;
  }

  extern __shared__ float sm[];
  float* ys = sm + OFF_Y;
  float* cs = sm + OFF_C;
  float* aq = sm + OFF_AQ;
  float* d2 = sm + OFF_D2;
  float* vs = sm + OFF_VS;
  float* ws = sm + OFF_W;
  float* dbs = sm + OFF_DB;
  float* vdb = sm + OFF_VDB;
  float* zs = sm + OFF_Z;
  float* hs = sm + OFF_HS;

  const size_t img = (size_t)n * plane;
  for (int i = tid; i < Reg<HY>::N; i += NT) {
    const int r = i / Reg<HY>::C - HY, c = i % Reg<HY>::C - HY;
    const size_t g = img + (size_t)wrap(y0 + r, H) * W + wrap(x0 + c, W);
    const float* q = rgb + 3 * g;
    ys[i] = 0.299f * clip01(q[0]) + 0.587f * clip01(q[1]) +
            0.114f * clip01(q[2]);
  }
  for (int i = tid; i < Reg<HC>::N; i += NT) {
    const int r = i / Reg<HC>::C - HC, c = i % Reg<HC>::C - HC;
    const size_t g = img + (size_t)wrap(y0 + r, H) * W + wrap(x0 + c, W);
    for (int ch = 0; ch < 3; ++ch) cs[ch * Reg<HC>::N + i] = rgb[3 * g + ch];
  }
  for (int i = tid; i < Reg<HB>::N; i += NT) {
    const int r = i / Reg<HB>::C - HB, c = i % Reg<HB>::C - HB;
    const size_t g = img + (size_t)wrap(y0 + r, H) * W + wrap(x0 + c, W);
    const float wg = wsum[g];
    const float* vg = v + 3 * g;
    const float* ug = u + 3 * g;
    for (int ch = 0; ch < 3; ++ch) aq[ch * Reg<HB>::N + i] = vg[ch] / wg;
    aq[3 * Reg<HB>::N + i] =
        -(vg[0] * ug[0] + vg[1] * ug[1] + vg[2] * ug[2]) / wg;
  }
  __syncthreads();

  const float hh = fmaxf(h[n], 0.0f) + 1e-8f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_y = 0.0f,
        acc_h = 0.0f;

#pragma unroll 1
  for (int dy = -SEARCH_R; dy <= SEARCH_R; ++dy) {
#pragma unroll 1
    for (int dx = -SEARCH_R; dx <= SEARCH_R; ++dx) {
      // d2 = (y - S_d y)^2 on the tile + 9
      for (int i = tid; i < Reg<HD>::N; i += NT) {
        const int r = i / Reg<HD>::C - HD, c = i % Reg<HD>::C - HD;
        const float t = ys[at<HY>(r, c)] - ys[at<HY>(r - dy, c - dx)];
        d2[i] = t * t;
      }
      __syncthreads();
      // box sum, rows first (as the forward): rows of tile + 7
      for (int i = tid; i < N_VS; i += NT) {
        const int r = i / Reg<HD>::C - HB, c = i % Reg<HD>::C - HD;
        float s = 0.0f;
#pragma unroll
        for (int a = -PATCH_R; a <= PATCH_R; ++a) s += d2[at<HD>(r + a, c)];
        vs[i] = s;
      }
      __syncthreads();
      // then columns, and the weight chain on the tile + 7
      for (int i = tid; i < Reg<HB>::N; i += NT) {
        const int r = i / Reg<HB>::C - HB, c = i % Reg<HB>::C - HB;
        const int row = (r + HB) * Reg<HD>::C + (c + HD);
        float b = 0.0f;
#pragma unroll
        for (int a = -PATCH_R; a <= PATCH_R; ++a) b += vs[row + a];
        const bool pos = b > 0.0f;
        const float s = pos ? sqrtf(b) : 0.0f;
        const float w = expf(-s / hh);
        const int cd = at<HC>(r - dy, c - dx);
        float gw = aq[3 * Reg<HB>::N + i];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          gw += aq[ch * Reg<HB>::N + i] * cs[ch * Reg<HC>::N + cd];
        const float gww = gw * w;
        ws[i] = w;
        dbs[i] = pos ? -0.5f * gww / (hh * s) : 0.0f;
        if (r >= 0 && r < TH && c >= 0 && c < TW) hs[r * TW + c] = gww * s;
      }
      __syncthreads();
      // box sum of db (self-adjoint), rows first: rows of tile + 5
      for (int i = tid; i < N_VDB; i += NT) {
        const int r = i / Reg<HB>::C - HZ, c = i % Reg<HB>::C - HB;
        float s = 0.0f;
#pragma unroll
        for (int a = -PATCH_R; a <= PATCH_R; ++a) s += dbs[at<HB>(r + a, c)];
        vdb[i] = s;
      }
      __syncthreads();
      // then columns: z = 2 (y - S_d y) dd2 on the tile + 5
      for (int i = tid; i < Reg<HZ>::N; i += NT) {
        const int r = i / Reg<HZ>::C - HZ, c = i % Reg<HZ>::C - HZ;
        const int row = (r + HZ) * Reg<HB>::C + (c + HB);
        float dd2 = 0.0f;
#pragma unroll
        for (int a = -PATCH_R; a <= PATCH_R; ++a) dd2 += vdb[row + a];
        const float diff = ys[at<HY>(r, c)] - ys[at<HY>(r - dy, c - dx)];
        zs[i] = 2.0f * diff * dd2;
      }
      __syncthreads();
      // this thread's pixel r gathers z(r) - z(r + d), (w a_c)(r + d) and
      // its own strength term; the next writes of these planes are two
      // barriers away
      acc_y += zs[at<HZ>(ty, tx)];
      acc_y -= zs[at<HZ>(ty + dy, tx + dx)];
      const int e = at<HB>(ty + dy, tx + dx);
      const float w2 = ws[e];
      acc_r += w2 * aq[e];
      acc_g += w2 * aq[Reg<HB>::N + e];
      acc_b += w2 * aq[2 * Reg<HB>::N + e];
      acc_h += hs[tid];
    }
  }

  if (inside) {
    const int c0 = at<HC>(ty, tx);
    drgb[3 * pix] = acc_r + 0.299f * clip_mask(cs[c0]) * acc_y;
    drgb[3 * pix + 1] = acc_g + 0.587f * clip_mask(cs[Reg<HC>::N + c0]) * acc_y;
    drgb[3 * pix + 2] =
        acc_b + 0.114f * clip_mask(cs[2 * Reg<HC>::N + c0]) * acc_y;
  }
  // fixed-order tree sum of the block's strength terms (the d2 plane is
  // free: every thread is past the last offset's barriers)
  __syncthreads();
  float* red = d2;
  red[tid] = inside ? acc_h : 0.0f;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) dh_part[part] = red[0] / (hh * hh);
}

}  // namespace

// rgb, v, u [n, height, width, 3]; wsum [n, height, width]; h, gate [n];
// drgb [n, height, width, 3]; dh_part [n, ceil(height / 16) *
// ceil(width / 32)]: contiguous float32 on the current device.  Launches on
// `stream`; returns the first CUDA error of the set-up or the launch.
extern "C" int nlm_gray_bwd(const float* rgb, const float* h,
                            const float* gate, const float* v, const float* u,
                            const float* wsum, float* drgb, float* dh_part,
                            int n, int height, int width, void* stream) {
  if (n == 0 || height == 0 || width == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      nlm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TW, TH);
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
