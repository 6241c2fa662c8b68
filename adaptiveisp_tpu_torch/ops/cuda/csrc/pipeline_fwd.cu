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
// the stages' own clips apply.
//
// The chain is not compiled into the kernel (the TPU kernel bakes the stage
// names in at trace time): a stage table travels by value as a
// __grid_constant__ argument.  Per stage it holds the op code, the offset
// and count of the stage's parameters in one image's row, and the stage's
// own parameter tensor: its device pointer and the floats between two
// images' rows (0 for one row that serves every image).  A block gathers
// its image's row into shared memory itself, so the caller packs nothing.
// Every thread of a block reads the same table entry, so the per-stage
// switch never diverges.  The curve filters take their step count from the
// table (tone: count, color: count / 3), so any cfg.curve_steps works.
//
// What bounds it on this card.
//   * Pointwise-only chains: bytes, for chains of a few dozen instructions
//     a pixel such as the bench's: each pixel is read once and written
//     once (24 bytes), and the data path alone moves a 3840x2160 frame in
//     0.080 ms on an H100 (2.5 TB/s).  The longest stack (both curves,
//     saturation_plus, contrast, gamma: about 700 instructions a pixel of
//     IEEE log, exp, cos and division) is bound by issue instead.
//   * Chains with sharpens: the separate multiplies and adds, on the halo.
//     A sharpen costs 22 FP32 instructions a channel and cell (9 multiplies
//     and 8 adds of the blur, 3 of the mix, 2 of the clip; -fmad=false
//     keeps every one).  With four sharpens a 64x32 tile computes
//     70x38 + 68x36 + 66x34 + 64x32 = 9,400 cells of sharpen for its 2,048
//     pixels, so one 3840x2160 frame takes 8.29 M x 4.59 x 3 x 22 = 2.51 G
//     of them: 0.075 ms at one FP32 instruction per lane and clock
//     (132 SMs x 128 lanes x 1.98 GHz), above the frame's 0.059 ms of
//     bytes, and the pointwise stages between the sharpens (gamma's log and
//     exp, contrast's cos and divides) add as much again.
//
// Design.
//   1. 16-byte accesses.  The pointwise kernel moves 128 pixels a warp as
//      three float4 loads and three float4 stores a lane, each lane then
//      working on four pixels.  The tiled kernel stages each halo'd tile
//      row as the 16-byte chunks of NHWC that cover it (cp.async), and
//      writes each output row as float4 chunks, a warp a row; only the
//      partial chunk at either end of a row is written by scalar stores.
//      A row need not start 16-byte aligned: its shift within its first
//      chunk (0-3 floats) is kept, so any N, H and W work.
//   2. Long-lived blocks.  Pointwise chains: blocks of one image (its
//      parameters loaded once) walk that image's pixels in a grid-stride
//      loop, 128 at a time through a per-warp buffer, so that every load
//      and store of a warp is 512 contiguous bytes.
//      Chains with sharpens: as many blocks as fit on the card, each
//      walking a contiguous run of 64x32 tiles with three buffers in turn:
//      at the start of a tile the next tile's rows are sent for (cp.async)
//      into the buffer this tile does not use, so they arrive while all of
//      this tile's stages run (512 threads, 88-110 KB of shared memory, 2
//      blocks a SM).  Parameters are gathered again only where a run
//      crosses into the next image.
//   3. No runtime division per pixel.  The tile's widths (one
//      instantiation per halo S = 1..4) and each pass's margin are
//      template parameters, so every index division is by a constant; a
//      sharpen or a pointwise stage between sharpens gives each thread one
//      column and a run of rows of the valid region, and the blur walks
//      down that column with its 3x3 window in registers (three
//      shared-memory reads a cell and channel, not nine).
//   4. The halo.  A 64x32 tile with an S-pixel halo is (64 + 2S)(32 + 2S):
//      1.10x the tile for one sharpen, 1.41x for four (the 32x32 tiles of
//      the first design: 1.13x and 1.56x).  Cells outside the image are
//      never loaded or used: the border rule is global, so no output pixel
//      reads them.
// Per-image constants (the exposure gain, the normalised CCM, the curve
// scales, 1 - t) are computed once per image in a block, as the plain
// chain computes them once per image, so the two round alike.  Built
// without --use_fast_math (IEEE expf, logf, cosf and division) and with
// -fmad=false, so each multiply and add rounds as the plain chain's
// separate tensor operations do; the blur adds its nine terms in the plain
// 3x3 conv's order.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_STAGES = 16;
constexpr int MAX_SHARPEN = 4;
constexpr int MAX_PARAMS = 1024;  // floats of one image's parameter row
constexpr int N_DERIVED = 9;      // per-image values of one stage
constexpr int MAX_DEVICES = 64;   // launch-shape caches, by device ordinal

constexpr int PW_NT = 256;        // pointwise kernel: threads of a block

constexpr int TW = 64, TH = 32;   // tiled kernel: output tile
constexpr int NT = 512;           // threads of a block
constexpr int MIN_BLOCKS = 2;     // blocks a SM the shared memory allows

// op codes: the order of ops/cuda/pipeline.py OPS
enum Op {
  EXPOSURE = 0, GAMMA, IMPROVED_WB, CCM, TONE, COLOR, CONTRAST, WNB,
  SATURATION_PLUS, SHARPEN, SHARPEN_V2, N_OPS
};

struct Table {
  int n;
  int op[MAX_STAGES];
  int off[MAX_STAGES];     // the stage's first float in the image's row
  int cnt[MAX_STAGES];     // and its count
  int stride[MAX_STAGES];  // floats between two images' rows of src
  const float* src[MAX_STAGES];
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
      d[0] = d[1] = d[2] = curve_scale(p, 1, cnt);
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

// The curve filters on K pixels: channel c of a pixel becomes
// d[c] * sum_i clip(x - i / steps, 0, 1 / steps) p[i * ps + c * pc]
// (tone: ps 1, pc 0; color: ps 3, pc 1).  The step's threshold is formed
// once for the K pixels.
template <int K>
__device__ __forceinline__ void curves(const float* p, int ps, int pc,
                                      int steps, const float* d, float* r,
                                      float* g, float* b) {
  const float width = 1.0f / (float)steps;
  float tr[K], tg[K], tb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) tr[k] = tg[k] = tb[k] = 0.0f;
  for (int i = 0; i < steps; ++i) {
    const float lo = (float)i / (float)steps;
    const float wr = p[i * ps], wg = p[i * ps + pc], wb = p[i * ps + 2 * pc];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tr[k] = tr[k] + fminf(fmaxf(r[k] - lo, 0.0f), width) * wr;
      tg[k] = tg[k] + fminf(fmaxf(g[k] - lo, 0.0f), width) * wg;
      tb[k] = tb[k] + fminf(fmaxf(b[k] - lo, 0.0f), width) * wb;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    r[k] = tr[k] * d[0];
    g[k] = tg[k] * d[1];
    b[k] = tb[k] * d[2];
  }
}

__device__ __forceinline__ void saturation_plus(float t, float u, float& r,
                                                float& g, float& b) {
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
  r = rc * u + fr * t;
  g = gc * u + fg * t;
  b = bc * u + fb * t;
}

// One pointwise stage on K pixels; p is the stage's parameter slice, d its
// derived values.
template <int K>
__device__ __forceinline__ void stage(int op, const float* p, const float* d,
                                      int cnt, float* r, float* g, float* b) {
  switch (op) {
    case EXPOSURE:
#pragma unroll
      for (int k = 0; k < K; ++k) {
        r[k] = r[k] * d[0]; g[k] = g[k] * d[0]; b[k] = b[k] * d[0];
      }
      break;
    case GAMMA: {
      const float gm = p[0];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        r[k] = expf(gm * logf(fmaxf(r[k], 0.001f)));
        g[k] = expf(gm * logf(fmaxf(g[k], 0.001f)));
        b[k] = expf(gm * logf(fmaxf(b[k], 0.001f)));
      }
      break;
    }
    case IMPROVED_WB:
#pragma unroll
      for (int k = 0; k < K; ++k) {
        r[k] = r[k] * p[0]; g[k] = g[k] * p[1]; b[k] = b[k] * p[2];
      }
      break;
    case CCM:
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float R = r[k], G = g[k], B = b[k];
        r[k] = R * d[0] + G * d[1] + B * d[2];
        g[k] = R * d[3] + G * d[4] + B * d[5];
        b[k] = R * d[6] + G * d[7] + B * d[8];
      }
      break;
    case TONE:
      curves<K>(p, 1, 0, cnt, d, r, g, b);
      break;
    case COLOR:  // p[i * 3 + c]: [steps, 3] flattened
      curves<K>(p, 3, 1, cnt / 3, d, r, g, b);
      break;
    case CONTRAST: {
      const float t = p[0], u = d[0];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float l = clip01(lum(r[k], g[k], b[k]));
        const float cl = -cosf(PI * l) * 0.5f + 0.5f;
        const float den = l + 1e-6f;
        r[k] = u * r[k] + t * (r[k] / den * cl);
        g[k] = u * g[k] + t * (g[k] / den * cl);
        b[k] = u * b[k] + t * (b[k] / den * cl);
      }
      break;
    }
    case WNB: {
      const float t = p[0], u = d[0];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float l = lum(r[k], g[k], b[k]);
        r[k] = u * r[k] + t * l;
        g[k] = u * g[k] + t * l;
        b[k] = u * b[k] + t * l;
      }
      break;
    }
    case SATURATION_PLUS:
#pragma unroll
      for (int k = 0; k < K; ++k) saturation_plus(p[0], d[0], r[k], g[k], b[k]);
      break;
    default:
      break;
  }
}

template <int K>
__device__ __forceinline__ void run_stages(const Table& t, int from, int to,
                                           const float* ps, const float* ds,
                                           float* r, float* g, float* b) {
  for (int s = from; s < to; ++s)
    stage<K>(t.op[s], ps + t.off[s], ds + s * N_DERIVED, t.cnt[s], r, g, b);
}

// Image n's parameter row, gathered from each stage's tensor, into ps; each
// stage's derived values into ds.
template <int NTH>
__device__ __forceinline__ void load_params(const Table& t, int n, float* ps,
                                            float* ds, int tid) {
  for (int s = 0; s < t.n; ++s) {
    const float* row = t.src[s] + (size_t)n * t.stride[s];
    for (int i = tid; i < t.cnt[s]; i += NTH) ps[t.off[s] + i] = row[i];
  }
  __syncthreads();
  if (tid < t.n)
    derive(t.op[tid], ps + t.off[tid], t.cnt[tid], ds + tid * N_DERIVED);
  __syncthreads();
}

// ---------------------------------------------------------------- pointwise

// The chain without sharpen.  Block (x, n) works on image n.  From the
// image's first 16-byte aligned pixel on, its pixels go 128 at a time, one
// warp's run: three coalesced float4 loads and stores a lane through a
// per-warp buffer, each lane's four pixels read back from it (lanes 48
// bytes apart: conflict-free 16-byte reads).  The 0-3 pixels before that
// and the fewer than 128 after the last whole run go one at a time, as do
// all of them where img and out differ in their alignment.
__global__ void __launch_bounds__(PW_NT)
pointwise_kernel(const float* __restrict__ img, float* __restrict__ out,
                 const __grid_constant__ Table t, long long hw) {
  __shared__ float ps[MAX_PARAMS];
  __shared__ float ds[MAX_STAGES * N_DERIVED];
  __shared__ float4 runs[PW_NT / 32][96];
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = blockIdx.y;
  load_params<PW_NT>(t, n, ps, ds, tid);
  const float* src = img + 3 * hw * n;
  float* dst = out + 3 * hw * n;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  // pixel p lies at a + 12 p: 16-byte aligned from p = (a mod 16) / 4 on
  long long head = ((a ^ reinterpret_cast<uintptr_t>(dst)) & 15) == 0
                       ? (long long)((a >> 2) & 3) : hw;
  if (head > hw) head = hw;
  const long long n_runs = (hw - head) / 128;
  const long long body_end = head + 128 * n_runs;
  const long long step = (long long)gridDim.x * PW_NT;

  for (long long i = (long long)blockIdx.x * PW_NT + tid;
       i < head + (hw - body_end); i += step) {
    const long long p = 3 * (i < head ? i : body_end + (i - head));
    float r[1] = {src[p]}, g[1] = {src[p + 1]}, b[1] = {src[p + 2]};
    run_stages<1>(t, 0, t.n, ps, ds, r, g, b);
    dst[p] = r[0];
    dst[p + 1] = g[0];
    dst[p + 2] = b[0];
  }
  const float4* s4 = reinterpret_cast<const float4*>(src + 3 * head);
  float4* d4 = reinterpret_cast<float4*>(dst + 3 * head);
  float4* sb = runs[tid >> 5];
  for (long long w = (long long)blockIdx.x * (PW_NT / 32) + (tid >> 5);
       w < n_runs; w += (long long)gridDim.x * (PW_NT / 32)) {
#pragma unroll
    for (int j = 0; j < 3; ++j) sb[lane + 32 * j] = s4[96 * w + lane + 32 * j];
    __syncwarp();
    const float4 u = sb[3 * lane], v = sb[3 * lane + 1], x = sb[3 * lane + 2];
    float r[4] = {u.x, u.w, v.z, x.y};
    float g[4] = {u.y, v.x, v.w, x.z};
    float b[4] = {u.z, v.y, x.x, x.w};
    run_stages<4>(t, 0, t.n, ps, ds, r, g, b);
    sb[3 * lane] = make_float4(r[0], g[0], b[0], r[1]);
    sb[3 * lane + 1] = make_float4(g[1], b[1], r[2], g[2]);
    sb[3 * lane + 2] = make_float4(b[2], r[3], g[3], b[3]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 3; ++j) d4[96 * w + lane + 32 * j] = sb[lane + 32 * j];
    __syncwarp();
  }
}

// ------------------------------------------------------------------- tiled

// Shared-memory layout of the tiled kernel for an S-pixel halo, in floats:
// the parameter row and derived values, then three buffers of UB floats.
// A buffer holds a tile's staging rows (each row's 16-byte chunks of NHWC,
// its first float `shift` floats in), or three planes (r, g, b) of the
// RH x RW region, or the output rows (NHWC chunks, as the staging rows).
// The three take turns: while one tile's region goes through two of them,
// the next tile's rows arrive in the third.
template <int S>
struct Tile {
  static constexpr int RW = TW + 2 * S, RH = TH + 2 * S;
  static constexpr int PLANE = RH * RW;
  static constexpr int PX = 4 * ((3 + 3 * RW + 3) / 4);  // staging pitch
  static constexpr int KX = PX / 4;                       // its chunks
  static constexpr int PO = 4 * ((3 + 3 * TW + 3) / 4);  // output pitch
  static constexpr int UB = RH * PX > 3 * PLANE ? RH * PX : 3 * PLANE;
  static constexpr int OFF_DS = MAX_PARAMS;
  static constexpr int OFF_U = OFF_DS + MAX_STAGES * N_DERIVED;
  static constexpr int FLOATS = OFF_U + 3 * UB;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(OFF_U % 4 == 0 && UB % 4 == 0,
                "16-byte aligned staging and output rows");
  static_assert(TH * PO <= UB, "the output rows fit one buffer");
  static_assert(RW <= NT, "a column of the region per thread");
  static_assert((TH * TW) % (2 * NT) == 0, "whole pairs of output cells");
};

// 16-byte copy from device memory into shared memory, not waited for.
__device__ __forceinline__ void cp_async16(float* smem, uintptr_t gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Floats by which the NHWC row of (image row `row` = n H + y, column x)
// lies past a 16-byte boundary of buffer p.  Only the value mod 4 matters,
// so it is computed mod 2^32.
__device__ __forceinline__ int shift_of(const float* p, long long row,
                                        int x, int W) {
  const unsigned q = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) >> 2);
  return static_cast<int>((q + 3u * (static_cast<unsigned>(row) *
                                     static_cast<unsigned>(W) +
                                     static_cast<unsigned>(x))) & 3u);
}

// The chunks of tile (n, y0, x0)'s region rows that hold in-image pixels,
// copied into the staging rows, a warp a row: a row's shift, range and
// address are worked out once, each lane then takes every 32nd chunk.
template <int S>
__device__ __forceinline__ void stage_rows(const float* img, float* xs, int n,
                                           int y0, int x0, int H, int W,
                                           int tid) {
  using T = Tile<S>;
  const int c_lo = max(0, S - x0), c_hi = min(T::RW, W - x0 + S);
  for (int r = tid >> 5; r < T::RH; r += NT / 32) {
    const int gy = y0 - S + r;
    if (gy < 0 || gy >= H) continue;
    const long long row = (long long)n * H + gy;
    const int m = shift_of(img, row, x0 - S, W);
    const int v_lo = m + 3 * c_lo, v_hi = m + 3 * c_hi;  // in-image floats
    // the 16-byte chunk holding the region row's column 0 (possibly left
    // of the image)
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(img) +
                         static_cast<uintptr_t>(4 * (3 * (row * W + x0 - S) - m));
    for (int lo = 4 * (tid & 31); lo < 4 * T::KX; lo += 128)
      if (lo + 4 > v_lo && lo < v_hi) cp_async16(xs + r * T::PX + lo, a0 + 4 * lo);
  }
}

// Each thread's share of the valid region at margin M: one column c and the
// rows [r0, r1), the same cells for a sharpen and the pointwise stages
// after it, so the two need no barrier between them.  All widths are
// compile-time, so the thread's column and rows come from divisions by
// constants.
template <int S, int M>
struct Share {
  static constexpr int NC = Tile<S>::RW - 2 * M, NR = Tile<S>::RH - 2 * M;
  static constexpr int SEGS = NT / NC, LEN = (NR + SEGS - 1) / SEGS;
  int c, r0, r1;
  __device__ __forceinline__ explicit Share(int tid) {
    const int seg = tid / NC;
    c = M + tid - seg * NC;
    r0 = M + seg * LEN;
    r1 = seg < SEGS ? min(r0 + LEN, M + NR) : r0;
  }
};

// Sharpen at margin M from buffer x to buffer o: the blur walks down the
// thread's column with its 3x3 window in registers.
template <int S, int M>
__device__ __forceinline__ void sharpen_pass(const float* __restrict__ x,
                                             float* __restrict__ o, float f,
                                             float u, bool v2, int gy0,
                                             int gx0, int H, int W, int tid) {
  using T = Tile<S>;
  constexpr int RW = T::RW;
  const Share<S, M> sh(tid);
  if (sh.r0 >= sh.r1) return;
  const bool col_border = gx0 + sh.c <= 0 || gx0 + sh.c >= W - 1;
#pragma unroll 1
  for (int ch = 0; ch < 3; ++ch) {
    const float* q = x + ch * T::PLANE + sh.c;
    float* w = o + ch * T::PLANE + sh.c;
    float a0 = q[(sh.r0 - 1) * RW - 1], a1 = q[(sh.r0 - 1) * RW],
          a2 = q[(sh.r0 - 1) * RW + 1];
    float b0 = q[sh.r0 * RW - 1], b1 = q[sh.r0 * RW], b2 = q[sh.r0 * RW + 1];
#pragma unroll 3
    for (int r = sh.r0; r < sh.r1; ++r) {
      const float c0 = q[(r + 1) * RW - 1], c1 = q[(r + 1) * RW],
                  c2 = q[(r + 1) * RW + 1];
      const int gy = gy0 + r;
      const float mid = b1;
      float blur = mid;
      if (!(col_border || gy <= 0 || gy >= H - 1)) {
        // kernel rows in order, as the plain 3x3 conv
        blur = K_EDGE * a0;
        blur = blur + K_EDGE * a1;
        blur = blur + K_EDGE * a2;
        blur = blur + K_EDGE * b0;
        blur = blur + K_MID * mid;
        blur = blur + K_EDGE * b2;
        blur = blur + K_EDGE * c0;
        blur = blur + K_EDGE * c1;
        blur = blur + K_EDGE * c2;
      }
      w[r * RW] = clip01(v2 ? mid + (mid - blur) * f : mid * f + blur * u);
      a0 = b0; a1 = b1; a2 = b2;
      b0 = c0; b1 = c1; b2 = c2;
    }
  }
}

// Pointwise stages [from, to) in place on the valid region at margin M.
template <int S, int M>
__device__ __forceinline__ void pointwise_pass(float* x, const Table& t,
                                               int from, int to,
                                               const float* ps,
                                               const float* ds, int tid) {
  using T = Tile<S>;
  const Share<S, M> sh(tid);
  for (int r = sh.r0; r < sh.r1; r += 2) {  // two rows at a time
    const int k0 = r * T::RW + sh.c;
    const int k1 = r + 1 < sh.r1 ? k0 + T::RW : k0;
    float R[2] = {x[k0], x[k1]}, G[2] = {x[T::PLANE + k0], x[T::PLANE + k1]},
          B[2] = {x[2 * T::PLANE + k0], x[2 * T::PLANE + k1]};
    run_stages<2>(t, from, to, ps, ds, R, G, B);
    x[k0] = R[0];
    x[T::PLANE + k0] = G[0];
    x[2 * T::PLANE + k0] = B[0];
    x[k1] = R[1];
    x[T::PLANE + k1] = G[1];
    x[2 * T::PLANE + k1] = B[1];
  }
}

// The passes at margin m = 1..S, each instantiated for its margin.
template <int S, int M = 1>
__device__ __forceinline__ void sharpen_at(int m, const float* x, float* o,
                                           float f, float u, bool v2,
                                           int gy0, int gx0, int H, int W,
                                           int tid) {
  if (m == M) {
    sharpen_pass<S, M>(x, o, f, u, v2, gy0, gx0, H, W, tid);
  } else if constexpr (M < S) {
    sharpen_at<S, M + 1>(m, x, o, f, u, v2, gy0, gx0, H, W, tid);
  }
}

template <int S, int M = 1>
__device__ __forceinline__ void pointwise_at(int m, float* x, const Table& t,
                                             int from, int to,
                                             const float* ps,
                                             const float* ds, int tid) {
  if (m == M) {
    pointwise_pass<S, M>(x, t, from, to, ps, ds, tid);
  } else if constexpr (M < S) {
    pointwise_at<S, M + 1>(m, x, t, from, to, ps, ds, tid);
  }
}

// The chain with S sharpen stages (first and last their indices).  Each
// block walks the tiles [t0, t1) of the flattened (image, tile row, tile
// column) order: while a tile's stages run, from its first to its last,
// the next tile's rows are in flight into the third buffer.
template <int S>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
tiled_kernel(const float* __restrict__ img, float* __restrict__ out,
             const __grid_constant__ Table t, int first, int last, int H,
             int W, int tiles_x, int tiles_per_img, long long n_tiles) {
  using T = Tile<S>;
  constexpr int RW = T::RW, PLANE = T::PLANE;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* ps = sm;
  float* ds = sm + T::OFF_DS;
  float* u = sm + T::OFF_U;
  const int tid = threadIdx.x;
  const long long t0 = n_tiles * blockIdx.x / gridDim.x;
  const long long t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
  if (t0 >= t1) return;

  auto coords = [&](long long tile, int& n, int& y0, int& x0) {
    n = static_cast<int>(tile / tiles_per_img);
    const int rem = static_cast<int>(tile - (long long)n * tiles_per_img);
    const int ty = rem / tiles_x;
    y0 = ty * TH;
    x0 = (rem - ty * tiles_x) * TW;
  };
  int n, y0, x0;
  coords(t0, n, y0, x0);
  stage_rows<S>(img, u, n, y0, x0, H, W, tid);
  cp_async_commit();
  int params_of = -1;

  int b = 0;
  for (long long tile = t0; tile < t1; ++tile, b = b == 2 ? 0 : b + 1) {
    coords(tile, n, y0, x0);
    cp_async_wait_all();
    __syncthreads();
    // buffer b holds this tile's rows; b + 1 (the last tile's second
    // buffer) takes the next tile's; b + 2 (the last tile's staging) and
    // then b itself take this tile's region
    const float* xs = u + b * T::UB;
    float* const work = u + (b + 2) % 3 * T::UB;
    float* const other = u + b * T::UB;
    if (tile + 1 < t1) {
      int n1, y1, x1;
      coords(tile + 1, n1, y1, x1);
      stage_rows<S>(img, u + (b + 1) % 3 * T::UB, n1, y1, x1, H, W, tid);
    }
    cp_async_commit();
    if (n != params_of) {
      load_params<NT>(t, n, ps, ds, tid);
      params_of = n;
    }

    // row r's shift is (shift of row 0 + 3 W r) mod 4, in the staging rows
    // and in the output rows alike
    const int w3 = (3 * W) & 3;
    const int in0 = shift_of(img, (long long)n * H + y0 - S, x0 - S, W);
    const int out0 = shift_of(out, (long long)n * H + y0, x0, W);

    // the region, with the stages before the first sharpen, into work,
    // two cells a thread at a time (cells outside the image run on zeros
    // and are not stored)
    for (int i0 = tid; i0 < PLANE; i0 += 2 * NT) {
      float R[2], G[2], B[2];
      bool in[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = i0 + k * NT;
        const int r = i / RW, c = i - r * RW;
        const int gy = y0 - S + r, gx = x0 - S + c;
        in[k] = i < PLANE && gy >= 0 && gy < H && gx >= 0 && gx < W;
        R[k] = G[k] = B[k] = 0.0f;
        if (in[k]) {
          const float* q = xs + r * T::PX + 3 * c + ((in0 + r * w3) & 3);
          R[k] = q[0];
          G[k] = q[1];
          B[k] = q[2];
        }
      }
      run_stages<2>(t, 0, first, ps, ds, R, G, B);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!in[k]) continue;
        const int i = i0 + k * NT;
        work[i] = R[k];
        work[PLANE + i] = G[k];
        work[2 * PLANE + i] = B[k];
      }
    }
    __syncthreads();

    float* cur = work;   // the region's current buffer, and the other one
    float* nxt = other;
    int m = 0;           // margin of the region still valid
    for (int s = first; s <= last;) {
      if (is_sharpen(t.op[s])) {
        if (m > 0) __syncthreads();
        ++m;
        sharpen_at<S>(m, cur, nxt, ps[t.off[s]], ds[s * N_DERIVED],
                      t.op[s] == SHARPEN_V2, y0 - S, x0 - S, H, W, tid);
        float* const was = cur;
        cur = nxt;
        nxt = was;
        ++s;
      } else {  // pointwise stages between two sharpens
        int e = s;
        while (!is_sharpen(t.op[e])) ++e;
        pointwise_at<S>(m, cur, t, s, e, ps, ds, tid);
        s = e;
      }
    }
    __syncthreads();

    // the tile, with the stages after the last sharpen, into output rows
    const float* fin = cur;
    float* os = nxt;
    const int rows = min(TH, H - y0), cols = min(TW, W - x0);
    for (int i0 = tid; i0 < TH * TW; i0 += 2 * NT) {  // two cells at a time
      float R[2], G[2], B[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = i0 + k * NT;
        const int j = ((i / TW) + S) * RW + (i % TW) + S;
        R[k] = fin[j];
        G[k] = fin[PLANE + j];
        B[k] = fin[2 * PLANE + j];
      }
      run_stages<2>(t, last + 1, t.n, ps, ds, R, G, B);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = i0 + k * NT;
        const int r = i / TW, c = i % TW;
        if (r >= rows || c >= cols) continue;
        float* q = os + r * T::PO + 3 * c + ((out0 + r * w3) & 3);
        q[0] = R[k];
        q[1] = G[k];
        q[2] = B[k];
      }
    }
    __syncthreads();

    // the output rows to device memory, a warp a row: whole 16-byte chunks
    // as float4, the partial chunk at either end of a row float by float
    for (int r = tid >> 5; r < rows; r += NT / 32) {
      const int m0 = (out0 + r * w3) & 3, end = m0 + 3 * cols;
      const float* q = os + r * T::PO;
      // the 16-byte chunk holding the row's first output float
      float* g = out + 3 * (((long long)n * H + y0 + r) * W + x0) - m0;
      for (int lo = 4 * (tid & 31); lo < end; lo += 128) {
        if (lo >= m0 && lo + 4 <= end) {
          *reinterpret_cast<float4*>(g + lo) =
              *reinterpret_cast<const float4*>(q + lo);
        } else {
          for (int j = max(lo, m0); j < min(lo + 4, end); ++j) g[j] = q[j];
        }
      }
    }
  }
}

// Blocks of `kernel` that fit on the current device at once: SMs x
// resident blocks a SM, found once per device.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem, int* cache,
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) cache[dev] = *blocks;
  return cudaSuccess;
}

template <int S>
int launch_tiled(const float* img, float* out, const Table& t, int first,
                 int last, int n, int height, int width, cudaStream_t st) {
  static int cache[MAX_DEVICES];
  int blocks = 0;
  cudaError_t err = resident_blocks(tiled_kernel<S>, NT, Tile<S>::BYTES,
                                    cache, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (width + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((height + TH - 1) / TH);
  const long long n_tiles = (long long)n * tiles_per_img;
  const int grid = (int)(n_tiles < blocks ? n_tiles : blocks);
  tiled_kernel<S><<<grid, NT, Tile<S>::BYTES, st>>>(
      img, out, t, first, last, height, width, tiles_x, tiles_per_img,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img, out [n, height, width, 3]: contiguous float32 on the current device.
// The stage table, n_stages entries of host arrays: ops (op codes), offs
// and cnts (each stage's place in one image's parameter row, at most
// MAX_PARAMS floats), srcs (each stage's parameter tensor: float32 on the
// device, its row for image i at srcs[s] + i * strides[s], cnts[s] floats
// with unit stride).  Launches on `stream`; returns -1 for a table or shape
// the kernel does not take, else the first CUDA error of the set-up or the
// launch.
extern "C" int pipeline_fwd(const float* img, float* out, const int* ops,
                            const int* offs, const int* cnts,
                            const void* const* srcs, const int* strides,
                            int n_stages, int n, int height, int width,
                            void* stream) {
  if (n_stages < 0 || n_stages > MAX_STAGES || n < 0 || height < 0 ||
      width < 0 || n > 65535)
    return -1;
  Table t;
  t.n = n_stages;
  int n_sharpen = 0, first = -1, last = -1;
  for (int s = 0; s < n_stages; ++s) {
    if (ops[s] < 0 || ops[s] >= N_OPS || offs[s] < 0 || cnts[s] < 1 ||
        offs[s] + cnts[s] > MAX_PARAMS || srcs[s] == nullptr ||
        strides[s] < 0)
      return -1;
    if ((ops[s] == COLOR && cnts[s] % 3 != 0) ||
        (ops[s] == CCM && cnts[s] != 9) ||
        (ops[s] == IMPROVED_WB && cnts[s] != 3))
      return -1;
    t.op[s] = ops[s];
    t.off[s] = offs[s];
    t.cnt[s] = cnts[s];
    t.stride[s] = strides[s];
    t.src[s] = static_cast<const float*>(srcs[s]);
    if (is_sharpen(ops[s])) {
      ++n_sharpen;
      if (first < 0) first = s;
      last = s;
    }
  }
  if (n_sharpen > MAX_SHARPEN) return -1;
  if (n == 0 || height == 0 || width == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_sharpen) {
    case 1: return launch_tiled<1>(img, out, t, first, last, n, height, width, st);
    case 2: return launch_tiled<2>(img, out, t, first, last, n, height, width, st);
    case 3: return launch_tiled<3>(img, out, t, first, last, n, height, width, st);
    case 4: return launch_tiled<4>(img, out, t, first, last, n, height, width, st);
    default: break;
  }
  static int cache[MAX_DEVICES];
  int blocks = 0;
  cudaError_t err = resident_blocks(pointwise_kernel, PW_NT, 0, cache, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long hw = (long long)height * width;
  const long long per_img = hw / (128 * (PW_NT / 32)) + 1;  // blocks of work
  long long bx = (blocks + n - 1) / n;
  if (bx > per_img) bx = per_img;
  if (bx < 1) bx = 1;
  pointwise_kernel<<<dim3((unsigned)bx, n), PW_NT, 0, st>>>(img, out, t, hw);
  return static_cast<int>(cudaGetLastError());
}
