// Fused scripted-render pass, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel adaptiveisp_tpu/ops/pallas/pipeline.py::
// _pipeline_kernel (driven by _run_fused, pallas_call at pipeline.py:223).
// Same function: one pass of a chain of up to MAX_STAGES stages over an
// NHWC float32 image, each stage one of
//   * 9 pointwise filters (exposure, gamma, improved_wb, ccm, tone, color,
//     contrast, wnb, saturation_plus), as the port's plain chain
//     (ops/filters.py) computes them; gamma as exp(g log(max(x, 0.001))),
//     as the TPU kernel does;
//   * up to MAX_SHARPEN 3x3 sharpen / sharpen_v2 stages: a centre-5 blur
//     (weights 1/13, 5/13) whose image-border pixels (rows 0 and H-1,
//     columns 0 and W-1) keep the stage input, then
//     clip(x f + blur (1 - f)) or clip(x + (x - blur) f).
// No clip between stages and none at the end (Filter.run semantics): only
// the stages' own clips apply.  Parameters are per image, [N, P] float32.
//
// The chain is not compiled into the kernel (the TPU kernel bakes the stage
// names in at trace time): a stage table (op code, parameter offset, count)
// travels by value as a kernel argument.  Every thread of a block reads the
// same table entry, so the per-stage switch never diverges.  The curve
// filters take their step count from the table (tone: count, color:
// count / 3), so any cfg.curve_steps works.
//
// Design: 32x32 output tiles, 32x8 threads, read straight from NHWC.
//   * No sharpen: each thread runs the whole chain on 4 pixels in registers.
//   * S sharpen stages: the block stages its tile with an S-pixel halo on
//     every side (clamped reads) in shared memory, running the stages before
//     the first sharpen on the way in.  Each sharpen reads one buffer and
//     writes the other behind one barrier, and the valid region shrinks by
//     one pixel per sharpen; pointwise stages between sharpens run in place
//     on the valid region (the same thread owns the same pixel in both
//     loops, so they need no barrier); the stages after the last sharpen run
//     on the way out.  Because the border rule is global, a pixel outside the
//     image (a clamped read) never reaches an output pixel.
//
// What bounds it on this card: memory.  Each pixel is read once and written
// once (24 bytes) against a few dozen operations per stage; the halo
// re-reads (at most (1 + 8/32)^2 = 1.56x the tile) mostly hit L2.  What is
// the same for every pixel of an image (the exposure gain, the normalised
// CCM, the curve scales, 1 - t) is computed once per block, as the plain
// chain computes it once per image, so the two round alike.
//
// Built without --use_fast_math (IEEE expf, logf, cosf and division) and
// with -fmad=false, so each multiply and add rounds as the plain chain's
// separate tensor operations do.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_STAGES = 16;
constexpr int MAX_SHARPEN = 4;
constexpr int MAX_PARAMS = 1024;  // floats of one image's parameter row
constexpr int N_DERIVED = 9;      // per-image values of one stage
constexpr int TW = 32, TH = 32;   // output tile
constexpr int BX = 32, BY = 8;    // block
constexpr int NT = BX * BY;
constexpr int RMAX = (TW + 2 * MAX_SHARPEN) * (TH + 2 * MAX_SHARPEN);

// op codes: the order of ops/cuda/pipeline.py OPS
enum Op {
  EXPOSURE = 0, GAMMA, IMPROVED_WB, CCM, TONE, COLOR, CONTRAST, WNB,
  SATURATION_PLUS, SHARPEN, SHARPEN_V2, N_OPS
};

struct Table {
  int n;
  int op[MAX_STAGES];
  int off[MAX_STAGES];
  int cnt[MAX_STAGES];
};

constexpr float LN2 = 0.6931471805599453f;
constexpr float PI = 3.141592653589793f;
constexpr float K_EDGE = 1.0f / 13.0f;
constexpr float K_MID = 5.0f / 13.0f;

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__host__ __device__ __forceinline__ bool is_sharpen(int op) {
  return op == SHARPEN || op == SHARPEN_V2;
}

// Floored remainder for m > 0, computed as torch.remainder and
// jnp.remainder compute it (the truncated fmodf, plus m where its sign is
// negative), so the hue selects agree with the plain chain bit for bit.
// fmodf alone truncates and is wrong for negative x.
__device__ __forceinline__ float floor_mod(float x, float m) {
  const float r = fmodf(x, m);
  return r < 0.0f ? r + m : r;
}

__device__ __forceinline__ float lum(float r, float g, float b) {
  return 0.27f * r + 0.67f * g + 0.06f * b;
}

__device__ __forceinline__ float curve(float x, const float* p, int stride,
                                       int steps, float scale) {
  const float width = 1.0f / (float)steps;
  float total = 0.0f;
  for (int i = 0; i < steps; ++i) {
    const float seg = fminf(fmaxf(x - (float)i / (float)steps, 0.0f), width);
    total = total + seg * p[i * stride];
  }
  return total * scale;
}

__device__ __forceinline__ float curve_scale(const float* p, int stride,
                                             int steps) {
  float sum = 0.0f;
  for (int i = 0; i < steps; ++i) sum = sum + p[i * stride];
  return (float)steps / (sum + 1e-30f);
}

// The values of one stage that are the same for every pixel of an image:
// p is its parameter slice, d its N_DERIVED slots.
__device__ void derive(int op, const float* p, int cnt, float* d) {
  switch (op) {
    case EXPOSURE:
      d[0] = expf(p[0] * LN2);
      break;
    case CCM:
      for (int k = 0; k < 3; ++k) {
        const float s = p[3 * k] + p[3 * k + 1] + p[3 * k + 2];
        for (int c = 0; c < 3; ++c) d[3 * k + c] = p[3 * k + c] / s;
      }
      break;
    case TONE:
      d[0] = curve_scale(p, 1, cnt);
      break;
    case COLOR:
      for (int c = 0; c < 3; ++c) d[c] = curve_scale(p + c, 3, cnt / 3);
      break;
    case CONTRAST:
    case WNB:
    case SATURATION_PLUS:
    case SHARPEN:
    case SHARPEN_V2:
      d[0] = 1.0f - p[0];
      break;
    default:
      break;
  }
}

// One pointwise stage on a pixel; p is the stage's parameter slice, d its
// derived values.
__device__ __forceinline__ void pointwise(int op, const float* p,
                                          const float* d, int cnt, float& r,
                                          float& g, float& b) {
  switch (op) {
    case EXPOSURE:
      r = r * d[0]; g = g * d[0]; b = b * d[0];
      break;
    case GAMMA: {
      const float gm = p[0];
      r = expf(gm * logf(fmaxf(r, 0.001f)));
      g = expf(gm * logf(fmaxf(g, 0.001f)));
      b = expf(gm * logf(fmaxf(b, 0.001f)));
      break;
    }
    case IMPROVED_WB:
      r = r * p[0]; g = g * p[1]; b = b * p[2];
      break;
    case CCM: {
      const float R = r, G = g, B = b;
      r = R * d[0] + G * d[1] + B * d[2];
      g = R * d[3] + G * d[4] + B * d[5];
      b = R * d[6] + G * d[7] + B * d[8];
      break;
    }
    case TONE:
      r = curve(r, p, 1, cnt, d[0]);
      g = curve(g, p, 1, cnt, d[0]);
      b = curve(b, p, 1, cnt, d[0]);
      break;
    case COLOR: {  // p[i * 3 + c]: [steps, 3] flattened
      const int steps = cnt / 3;
      r = curve(r, p, 3, steps, d[0]);
      g = curve(g, p + 1, 3, steps, d[1]);
      b = curve(b, p + 2, 3, steps, d[2]);
      break;
    }
    case CONTRAST: {
      const float l = clip01(lum(r, g, b));
      const float cl = -cosf(PI * l) * 0.5f + 0.5f;
      const float den = l + 1e-6f;
      const float t = p[0], u = d[0];
      r = u * r + t * (r / den * cl);
      g = u * g + t * (g / den * cl);
      b = u * b + t * (b / den * cl);
      break;
    }
    case WNB: {
      const float l = lum(r, g, b);
      const float t = p[0], u = d[0];
      r = u * r + t * l;
      g = u * g + t * l;
      b = u * b + t * l;
      break;
    }
    case SATURATION_PLUS: {
      const float eps = 1e-8f;
      const float rc = clip01(r), gc = clip01(g), bc = clip01(b);
      const float maxc = fmaxf(rc, fmaxf(gc, bc));
      const float minc = fminf(rc, fminf(gc, bc));
      const float rng = maxc - minc + eps;
      // the where chain of rgb2hsv, in its order: the last select wins
      float hue = 0.0f;
      if (bc == maxc) hue = 4.0f + (rc - gc) / rng;
      if (gc == maxc) hue = 2.0f + (bc - rc) / rng;
      if (rc == maxc) hue = floor_mod((gc - bc) / rng, 6.0f);
      if (minc == maxc) hue = 0.0f;
      const float h = floor_mod(hue / 6.0f, 1.0f);
      const float sat = maxc == 0.0f ? 0.0f : (maxc - minc) / (maxc + eps);
      const float v = maxc;
      const float s2 = clip01(sat + (1.0f - sat) * (0.5f - fabsf(0.5f - v))
                              * 0.8f);
      const float vv = clip01(v);
      const float h6 = h * 6.0f;
      const float hi = floorf(h6);
      const float f = h6 - hi;
      const float pp = vv * (1.0f - s2);
      const float qq = vv * (1.0f - f * s2);
      const float tt = vv * (1.0f - (1.0f - f) * s2);
      float fr = 0.0f, fg = 0.0f, fb = 0.0f;
      if (hi == 0.0f) { fr = vv; fg = tt; fb = pp; }
      else if (hi == 1.0f) { fr = qq; fg = vv; fb = pp; }
      else if (hi == 2.0f) { fr = pp; fg = vv; fb = tt; }
      else if (hi == 3.0f) { fr = pp; fg = qq; fb = vv; }
      else if (hi == 4.0f) { fr = tt; fg = pp; fb = vv; }
      else if (hi == 5.0f) { fr = vv; fg = pp; fb = qq; }
      const float t = p[0], u = d[0];
      r = rc * u + fr * t;
      g = gc * u + fg * t;
      b = bc * u + fb * t;
      break;
    }
    default:
      break;
  }
}

__device__ __forceinline__ void run_stages(const Table& t, int from, int to,
                                           const float* ps, const float* ds,
                                           float& r, float& g, float& b) {
  for (int s = from; s < to; ++s)
    pointwise(t.op[s], ps + t.off[s], ds + s * N_DERIVED, t.cnt[s], r, g, b);
}

// The block's image's parameter row into ps, each stage's derived values
// into ds.
__device__ __forceinline__ void load_params(const float* __restrict__ params,
                                            int n_params, const Table& t,
                                            float* ps, float* ds) {
  const int tid = threadIdx.y * BX + threadIdx.x;
  const float* row = params + (size_t)blockIdx.z * n_params;
  for (int i = tid; i < n_params; i += NT) ps[i] = row[i];
  __syncthreads();
  if (tid < t.n)
    derive(t.op[tid], ps + t.off[tid], t.cnt[tid], ds + tid * N_DERIVED);
  __syncthreads();
}

// The chain without sharpen: every pixel in registers.
__global__ void __launch_bounds__(NT)
pointwise_kernel(const float* __restrict__ img, float* __restrict__ out,
                 const float* __restrict__ params, int n_params,
                 const __grid_constant__ Table t, int H, int W) {
  __shared__ float ps[MAX_PARAMS];
  __shared__ float ds[MAX_STAGES * N_DERIVED];
  load_params(params, n_params, t, ps, ds);
  const int px = blockIdx.x * TW + threadIdx.x;
  if (px >= W) return;
  const size_t plane = (size_t)blockIdx.z * H * W;
  for (int yy = threadIdx.y; yy < TH; yy += BY) {
    const int py = blockIdx.y * TH + yy;
    if (py >= H) break;
    const size_t q = 3 * (plane + (size_t)py * W + px);
    float r = img[q], g = img[q + 1], b = img[q + 2];
    run_stages(t, 0, t.n, ps, ds, r, g, b);
    out[q] = r;
    out[q + 1] = g;
    out[q + 2] = b;
  }
}

// The chain with S >= 1 sharpen stages, first and last their indices.
__global__ void __launch_bounds__(NT)
tiled_kernel(const float* __restrict__ img, float* __restrict__ out,
             const float* __restrict__ params, int n_params,
             const __grid_constant__ Table t, int S, int first, int last,
             int H, int W) {
  __shared__ float ps[MAX_PARAMS];
  __shared__ float ds[MAX_STAGES * N_DERIVED];
  __shared__ float buf[2][3][RMAX];
  load_params(params, n_params, t, ps, ds);
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int rw = TW + 2 * S, rh = TH + 2 * S;
  const float* src = img + (size_t)blockIdx.z * H * W * 3;

  // the tile and its S-pixel halo, with the stages before the first sharpen
  for (int i = tid; i < rw * rh; i += NT) {
    const int gy = min(max(y0 - S + i / rw, 0), H - 1);
    const int gx = min(max(x0 - S + i % rw, 0), W - 1);
    const float* q = src + ((size_t)gy * W + gx) * 3;
    float r = q[0], g = q[1], b = q[2];
    run_stages(t, 0, first, ps, ds, r, g, b);
    buf[0][0][i] = r;
    buf[0][1][i] = g;
    buf[0][2][i] = b;
  }

  int cur = 0, m = 0;  // m: margin of the region still valid
  for (int s = first; s <= last;) {
    if (is_sharpen(t.op[s])) {
      __syncthreads();
      ++m;
      const float f = ps[t.off[s]], u = ds[s * N_DERIVED];
      const bool v2 = t.op[s] == SHARPEN_V2;
      const int vw = rw - 2 * m, n_valid = vw * (rh - 2 * m);
      for (int i = tid; i < n_valid; i += NT) {
        const int r = m + i / vw, c = m + i % vw;
        const int gy = y0 - S + r, gx = x0 - S + c;
        const bool border = gy <= 0 || gy >= H - 1 || gx <= 0 || gx >= W - 1;
        const int k = r * rw + c;
        for (int ch = 0; ch < 3; ++ch) {
          const float* x = buf[cur][ch];
          const float mid = x[k];
          float blur = mid;
          if (!border) {  // kernel rows in order, as the plain 3x3 conv
            blur = K_EDGE * x[k - rw - 1];
            blur = blur + K_EDGE * x[k - rw];
            blur = blur + K_EDGE * x[k - rw + 1];
            blur = blur + K_EDGE * x[k - 1];
            blur = blur + K_MID * mid;
            blur = blur + K_EDGE * x[k + 1];
            blur = blur + K_EDGE * x[k + rw - 1];
            blur = blur + K_EDGE * x[k + rw];
            blur = blur + K_EDGE * x[k + rw + 1];
          }
          buf[cur ^ 1][ch][k] =
              clip01(v2 ? mid + (mid - blur) * f : mid * f + blur * u);
        }
      }
      cur ^= 1;
      ++s;
    } else {  // pointwise stages between two sharpens, in place
      int e = s;
      while (!is_sharpen(t.op[e])) ++e;
      const int vw = rw - 2 * m, n_valid = vw * (rh - 2 * m);
      for (int i = tid; i < n_valid; i += NT) {
        const int k = (m + i / vw) * rw + m + i % vw;
        float r = buf[cur][0][k], g = buf[cur][1][k], b = buf[cur][2][k];
        run_stages(t, s, e, ps, ds, r, g, b);
        buf[cur][0][k] = r;
        buf[cur][1][k] = g;
        buf[cur][2][k] = b;
      }
      s = e;
    }
  }
  __syncthreads();

  // the tile, with the stages after the last sharpen
  const int px = x0 + threadIdx.x;
  if (px >= W) return;
  float* dst = out + (size_t)blockIdx.z * H * W * 3;
  for (int yy = threadIdx.y; yy < TH; yy += BY) {
    const int py = y0 + yy;
    if (py >= H) break;
    const int k = (yy + S) * rw + threadIdx.x + S;
    float r = buf[cur][0][k], g = buf[cur][1][k], b = buf[cur][2][k];
    run_stages(t, last + 1, t.n, ps, ds, r, g, b);
    float* q = dst + ((size_t)py * W + px) * 3;
    q[0] = r;
    q[1] = g;
    q[2] = b;
  }
}

}  // namespace

// img, out [n, height, width, 3], params [n, n_params]: contiguous float32
// on the current device.  ops, offs, cnts: the stage table, n_stages host
// ints.  Launches on `stream`; returns -1 for a table the kernel does not
// take, else cudaGetLastError() of the launch.
extern "C" int pipeline_fwd(const float* img, float* out, const float* params,
                            int n_params, const int* ops, const int* offs,
                            const int* cnts, int n_stages, int n, int height,
                            int width, void* stream) {
  if (n_stages < 0 || n_stages > MAX_STAGES || n_params < 0 ||
      n_params > MAX_PARAMS)
    return -1;
  Table t;
  t.n = n_stages;
  int n_sharpen = 0, first = -1, last = -1;
  for (int s = 0; s < n_stages; ++s) {
    if (ops[s] < 0 || ops[s] >= N_OPS || offs[s] < 0 || cnts[s] < 1 ||
        offs[s] + cnts[s] > n_params)
      return -1;
    if ((ops[s] == COLOR && cnts[s] % 3 != 0) ||
        (ops[s] == CCM && cnts[s] != 9) ||
        (ops[s] == IMPROVED_WB && cnts[s] != 3))
      return -1;
    t.op[s] = ops[s];
    t.off[s] = offs[s];
    t.cnt[s] = cnts[s];
    if (is_sharpen(ops[s])) {
      ++n_sharpen;
      if (first < 0) first = s;
      last = s;
    }
  }
  if (n_sharpen > MAX_SHARPEN) return -1;
  if (n == 0 || height == 0 || width == 0) return 0;
  const dim3 block(BX, BY);
  const dim3 grid((width + TW - 1) / TW, (height + TH - 1) / TH, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_sharpen == 0)
    pointwise_kernel<<<grid, block, 0, st>>>(img, out, params, n_params, t,
                                             height, width);
  else
    tiled_kernel<<<grid, block, 0, st>>>(img, out, params, n_params, t,
                                         n_sharpen, first, last, height,
                                         width);
  return static_cast<int>(cudaGetLastError());
}
