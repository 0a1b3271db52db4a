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
// The per-tracker arithmetic lives in sort_device.cuh (shared with
// chunk.cu) and repeats the operation order of the plain PyTorch version
// (src/repro_torch/kernels/ref.py) term by term.  Built with --fmad=false
// and IEEE division and square root, so it agrees with that version bit
// for bit.

#include <cuda_runtime.h>

#include "sort_device.cuh"

namespace {

using namespace sortdev;

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
#pragma unroll
    for (int r = 0; r < 7; ++r) xp[r] = x[r * TS + ts];
#pragma unroll
    for (int r = 0; r < 49; ++r) pp[r] = p[r * TS + ts];
    predict(xp, pp);
  }

  // ---- association ----
  if constexpr (kHasAssoc) {
    if (ty < T) t2d_sh[ty][tx] = in_s ? t2d_in[ts] : -1;
    __syncthreads();
  } else {
    __syncthreads();                       // det_sh complete
    // this slot's column of the IoU score tile
    const bool trk_ok = act && alive[ts] > 0.0f;
    const Box b = trk_ok ? z_to_xyxy(xp) : Box{0.0f, 0.0f, 0.0f, 0.0f};
    for (int d = 0; d < D; ++d) {
      float sc = -1.0f;
      if (trk_ok && det_mask[static_cast<long>(d) * S + s] > 0.0f) {
        const float v = iou(det_sh[d][0][tx], det_sh[d][1][tx],
                            det_sh[d][2][tx], det_sh[d][3][tx], b);
        if (v >= iou_threshold) sc = v;
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
  if (t2d >= 0 && t2d < D)
    xyxy_to_z(det_sh[t2d][0][tx], det_sh[t2d][1][tx], det_sh[t2d][2][tx],
              det_sh[t2d][3][tx], z);
  masked_update(xp, pp, z, t2d >= 0 ? 1.0f : 0.0f);
#pragma unroll
  for (int r = 0; r < 7; ++r) x_out[r * TS + ts] = xp[r];
#pragma unroll
  for (int r = 0; r < 49; ++r) p_out[r * TS + ts] = pp[r];
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
