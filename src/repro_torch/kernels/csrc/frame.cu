// Fused SORT frame for many streams in one launch (Hopper, sm_90a).
//
// Replaces src/repro/kernels/frame.py::fused_frame (the Pallas TPU kernel,
// body _frame_kernel).  One launch runs one SORT frame for every stream:
// constant-velocity predict, association (either greedy inside the kernel
// or a gather by a precomputed, already gated trk_to_det from the Hungarian
// stage), the masked Kalman update with the blockwise SPD 4x4 inverse, and
// the restore of inactive lanes.
//
// Layout (streams on the minor axis): x [7,T,S], p [49,T,S], det [D,4,S],
// det_mask [D,S], alive [T,S], active [1,S] (all float32 0/1 for masks),
// trk_to_det [T,S] int32.  Out: x, p, trk_to_det [T,S] int32,
// matched_det [D,S] int32 0/1.
//
// What bounds it: bytes.  The arithmetic is ~1k float operations per
// tracker (contractions 4 and 7 wide), far below what the card does per
// byte, while every tracker's 56-float state must be read and written.
// At S=2048, T=D=16 one launch moves about 8.3 MB in and 7.6 MB out,
// 15.9 MB in all: about 4.7 us at the H100 SXM's 3.35 TB/s.  The design
// answers the bound with one pass: each (t, s) thread reads its state once,
// keeps the predicted state in registers through association and update,
// and writes it once; neighbouring threads take neighbouring streams, so
// every load and store is coalesced; only the per-stream det rows and the
// greedy IoU tile go through shared memory.
//
// Arithmetic repeats the operation order of the plain PyTorch version
// (src/repro_torch/kernels/ref.py) term by term, sums starting from 0 and
// off-diagonal noise adding 0.  Built with --fmad=false and IEEE division
// and square root, so it agrees with that version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxT = 32;      // tracker slots per stream (wrapper checks)
constexpr int kMaxD = 32;      // detections per stream (wrapper checks)
constexpr int kStreams = 8;    // streams per block: 8 floats = one 32 B sector
constexpr float kEps = 1e-9f;

__device__ __forceinline__ constexpr float q_diag(int i) {
  return i < 4 ? 1.0f : (i < 6 ? 0.01f : 1e-4f);
}
__device__ __forceinline__ constexpr float r_diag(int i) {
  return i < 2 ? 1.0f : 10.0f;
}

struct Inv2 { float a, b, c, d; };

__device__ __forceinline__ Inv2 inv2(float m00, float m01, float m10, float m11) {
  const float det = m00 * m11 - m01 * m10;
  const float inv = 1.0f / det;
  return {m11 * inv, -m01 * inv, -m10 * inv, m00 * inv};
}

// Blockwise inverse of an SPD 4x4 (Schur complement of the top-left 2x2),
// in ref._inv4's order.
__device__ __forceinline__ void inv4(const float s[4][4], float o[4][4]) {
  const Inv2 ai = inv2(s[0][0], s[0][1], s[1][0], s[1][1]);
  const float b00 = s[0][2], b01 = s[0][3], b10 = s[1][2], b11 = s[1][3];
  const float c00 = s[2][0], c01 = s[2][1], c10 = s[3][0], c11 = s[3][1];
  const float d00 = s[2][2], d01 = s[2][3], d10 = s[3][2], d11 = s[3][3];
  const float ai00 = ai.a, ai01 = ai.b, ai10 = ai.c, ai11 = ai.d;
  const float ca00 = c00 * ai00 + c01 * ai10;
  const float ca01 = c00 * ai01 + c01 * ai11;
  const float ca10 = c10 * ai00 + c11 * ai10;
  const float ca11 = c10 * ai01 + c11 * ai11;
  const float ab00 = ai00 * b00 + ai01 * b10;
  const float ab01 = ai00 * b01 + ai01 * b11;
  const float ab10 = ai10 * b00 + ai11 * b10;
  const float ab11 = ai10 * b01 + ai11 * b11;
  const float s00 = d00 - (ca00 * b00 + ca01 * b10);
  const float s01 = d01 - (ca00 * b01 + ca01 * b11);
  const float s10 = d10 - (ca10 * b00 + ca11 * b10);
  const float s11 = d11 - (ca10 * b01 + ca11 * b11);
  const Inv2 si = inv2(s00, s01, s10, s11);
  const float si00 = si.a, si01 = si.b, si10 = si.c, si11 = si.d;
  const float absi00 = ab00 * si00 + ab01 * si10;
  const float absi01 = ab00 * si01 + ab01 * si11;
  const float absi10 = ab10 * si00 + ab11 * si10;
  const float absi11 = ab10 * si01 + ab11 * si11;
  o[0][0] = ai00 + absi00 * ca00 + absi01 * ca10;
  o[0][1] = ai01 + absi00 * ca01 + absi01 * ca11;
  o[1][0] = ai10 + absi10 * ca00 + absi11 * ca10;
  o[1][1] = ai11 + absi10 * ca01 + absi11 * ca11;
  o[0][2] = -absi00; o[0][3] = -absi01;
  o[1][2] = -absi10; o[1][3] = -absi11;
  o[2][0] = -(si00 * ca00 + si01 * ca10);
  o[2][1] = -(si00 * ca01 + si01 * ca11);
  o[3][0] = -(si10 * ca00 + si11 * ca10);
  o[3][1] = -(si10 * ca01 + si11 * ca11);
  o[2][2] = si00; o[2][3] = si01;
  o[3][2] = si10; o[3][3] = si11;
}

// Grid: one block per kStreams consecutive streams; block (kStreams, T):
// threadIdx.x is the stream within the block, threadIdx.y the tracker slot.
template <bool kHasActive, bool kHasAssoc>
__global__ void __launch_bounds__(kStreams * kMaxT)
fused_frame_kernel(const float* __restrict__ x, const float* __restrict__ p,
                   const float* __restrict__ det,
                   const float* __restrict__ det_mask,
                   const float* __restrict__ alive,
                   const float* __restrict__ active,
                   const int* __restrict__ t2d_in,
                   float* __restrict__ x_out, float* __restrict__ p_out,
                   int* __restrict__ t2d_out, int* __restrict__ md_out,
                   int T, int D, int S, float iou_threshold) {
  __shared__ float det_sh[kMaxD][4][kStreams];
  __shared__ int t2d_sh[kMaxT][kStreams];
  // greedy only: the stream's [D*T] score tile, flat d*T + t
  __shared__ float score_sh[kHasAssoc ? 1 : kMaxD * kMaxT][kStreams];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int s = blockIdx.x * kStreams + tx;
  const bool in_s = s < S;
  const long TS = static_cast<long>(T) * S;
  const long ts = static_cast<long>(ty) * S + s;
  const bool act = in_s && (!kHasActive || active[s] > 0.0f);

  for (int k = ty; k < 4 * D; k += T)
    det_sh[k >> 2][k & 3][tx] = in_s ? det[static_cast<long>(k) * S + s] : 0.0f;

  // ---- predict (F P F^T + Q, area velocity clamped), in registers ----
  float xp[7], pp[49];
  if (act) {
    float xv[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) xv[r] = x[r * TS + ts];
#pragma unroll
    for (int r = 0; r < 49; ++r) pp[r] = p[r * TS + ts];
    const float ds = (xv[2] + xv[6] <= 0.0f) ? 0.0f : xv[6];
    xp[0] = xv[0] + xv[4]; xp[1] = xv[1] + xv[5]; xp[2] = xv[2] + ds;
    xp[3] = xv[3]; xp[4] = xv[4]; xp[5] = xv[5]; xp[6] = ds;
    // in place, row-major ascending: every entry read below is still the
    // pre-predict value when it is read
#pragma unroll
    for (int i = 0; i < 7; ++i) {
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        float v = pp[i * 7 + j];
        if (i < 3) v = v + pp[(i + 4) * 7 + j];
        if (j < 3) v = v + pp[i * 7 + j + 4];
        if (i < 3 && j < 3) v = v + pp[(i + 4) * 7 + j + 4];
        pp[i * 7 + j] = v + (i == j ? q_diag(i) : 0.0f);
      }
    }
  }

  // ---- association ----
  if constexpr (kHasAssoc) {
    if (ty < T) t2d_sh[ty][tx] = in_s ? t2d_in[ts] : -1;
    __syncthreads();
  } else {
    __syncthreads();                       // det_sh complete
    // this slot's column of the IoU score tile
    float bx1 = 0.0f, by1 = 0.0f, bx2 = 0.0f, by2 = 0.0f;
    const bool trk_ok = act && alive[ts] > 0.0f;
    if (trk_ok) {
      const float sa = fmaxf(xp[2], 0.0f);
      const float ra = fmaxf(xp[3], kEps);
      const float w = sqrtf(sa * ra);
      const float h = sa / fmaxf(w, kEps);
      const float hw = w / 2.0f, hh = h / 2.0f;
      bx1 = xp[0] - hw; by1 = xp[1] - hh; bx2 = xp[0] + hw; by2 = xp[1] + hh;
    }
    for (int d = 0; d < D; ++d) {
      float sc = -1.0f;
      if (trk_ok && det_mask[static_cast<long>(d) * S + s] > 0.0f) {
        const float ax1 = det_sh[d][0][tx], ay1 = det_sh[d][1][tx];
        const float ax2 = det_sh[d][2][tx], ay2 = det_sh[d][3][tx];
        const float iw = fmaxf(fminf(ax2, bx2) - fmaxf(ax1, bx1), 0.0f);
        const float ih = fmaxf(fminf(ay2, by2) - fmaxf(ay1, by1), 0.0f);
        const float inter = iw * ih;
        const float ua = fmaxf(ax2 - ax1, 0.0f) * fmaxf(ay2 - ay1, 0.0f);
        const float ub = fmaxf(bx2 - bx1, 0.0f) * fmaxf(by2 - by1, 0.0f);
        const float iou = inter / fmaxf(ua + ub - inter, 1e-9f);
        if (iou >= iou_threshold) sc = iou;
      }
      score_sh[d * T + ty][tx] = sc;
    }
    t2d_sh[ty][tx] = -1;
    __syncthreads();
    // min(D, T) rounds of best-first matching over the flat d*T + t index,
    // first index on ties; one thread per stream
    if (ty == 0 && in_s) {
      const int rounds = D < T ? D : T;
      const int n = D * T;
      for (int r = 0; r < rounds; ++r) {
        float best = score_sh[0][tx];
        int idx = 0;
        for (int k = 1; k < n; ++k) {
          const float v = score_sh[k][tx];
          if (v > best) { best = v; idx = k; }
        }
        if (!(best > 0.0f)) break;   // nothing left: later rounds match nothing
        const int di = idx / T, ti = idx % T;
        t2d_sh[ti][tx] = di;
        for (int k = 0; k < T; ++k) score_sh[di * T + k][tx] = -1.0f;
        for (int k = 0; k < D; ++k) score_sh[k * T + ti][tx] = -1.0f;
      }
    }
    __syncthreads();
  }

  const int t2d = t2d_sh[ty][tx];
  if (in_s) t2d_out[ts] = t2d;
  for (int d = ty; d < D; d += T) {
    int m = 0;
    for (int k = 0; k < T; ++k) m |= (t2d_sh[k][tx] == d);
    if (in_s) md_out[static_cast<long>(d) * S + s] = m;
  }
  if (!in_s) return;
  if (!act) {                               // inactive lane: exact no-op
#pragma unroll
    for (int r = 0; r < 7; ++r) x_out[r * TS + ts] = x[r * TS + ts];
#pragma unroll
    for (int r = 0; r < 49; ++r) p_out[r * TS + ts] = p[r * TS + ts];
    return;
  }

  // ---- masked update with the gathered observation ----
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (t2d >= 0 && t2d < D) {
    const float x1 = det_sh[t2d][0][tx], y1 = det_sh[t2d][1][tx];
    const float x2 = det_sh[t2d][2][tx], y2 = det_sh[t2d][3][tx];
    const float w = x2 - x1, h = y2 - y1;
    z[0] = x1 + w / 2.0f;
    z[1] = y1 + h / 2.0f;
    z[2] = w * h;
    z[3] = w / fmaxf(h, kEps);
  }
  const float m = t2d >= 0 ? 1.0f : 0.0f;
  const float mc = 1.0f - m;
  float y[4], sm[4][4], si[4][4], k[7][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = z[i] - xp[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sm[i][j] = pp[i * 7 + j] + (i == j ? r_diag(i) : 0.0f);
  inv4(sm, si);
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc = acc + pp[i * 7 + kk] * si[kk][j];
      k[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = acc + k[i][j] * y[j];
    const float xn = xp[i] + acc;
    x_out[i * TS + ts] = m * xn + mc * xp[i];
  }
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc = acc + k[i][kk] * pp[kk * 7 + j];
      const float pn = pp[i * 7 + j] - acc;
      p_out[(i * 7 + j) * TS + ts] = m * pn + mc * pp[i * 7 + j];
    }
}

template <bool kHasActive, bool kHasAssoc>
void launch(const float* x, const float* p, const float* det,
            const float* det_mask, const float* alive, const float* active,
            const int* t2d_in, float* x_out, float* p_out, int* t2d_out,
            int* md_out, int T, int D, int S, float iou_threshold,
            cudaStream_t stream) {
  const dim3 block(kStreams, T);
  const dim3 grid((S + kStreams - 1) / kStreams);
  fused_frame_kernel<kHasActive, kHasAssoc><<<grid, block, 0, stream>>>(
      x, p, det, det_mask, alive, active, t2d_in, x_out, p_out, t2d_out,
      md_out, T, D, S, iou_threshold);
}

}  // namespace

// Plain C entry point for ctypes.  `active` and `t2d_in` may be null (no
// ragged mask / greedy association inside the kernel).  Returns the CUDA
// error of the launch (0 = cudaSuccess); does not synchronise.
extern "C" int fused_frame_launch(const float* x, const float* p,
                                  const float* det, const float* det_mask,
                                  const float* alive, const float* active,
                                  const int* t2d_in, float* x_out,
                                  float* p_out, int* t2d_out, int* md_out,
                                  int T, int D, int S, float iou_threshold,
                                  void* stream) {
  if (T < 1 || T > kMaxT || D < 0 || D > kMaxD || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_active = active != nullptr;
  if (t2d_in != nullptr) {
    if (has_active)
      launch<true, true>(x, p, det, det_mask, alive, active, t2d_in, x_out,
                         p_out, t2d_out, md_out, T, D, S, iou_threshold, st);
    else
      launch<false, true>(x, p, det, det_mask, alive, active, t2d_in, x_out,
                          p_out, t2d_out, md_out, T, D, S, iou_threshold, st);
  } else {
    if (has_active)
      launch<true, false>(x, p, det, det_mask, alive, active, t2d_in, x_out,
                          p_out, t2d_out, md_out, T, D, S, iou_threshold, st);
    else
      launch<false, false>(x, p, det, det_mask, alive, active, t2d_in, x_out,
                           p_out, t2d_out, md_out, T, D, S, iou_threshold,
                           st);
  }
  return static_cast<int>(cudaGetLastError());
}
