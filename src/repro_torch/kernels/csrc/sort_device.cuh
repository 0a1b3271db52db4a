// Device functions of one SORT tracker, shared by frame.cu and chunk.cu.
//
// One thread owns one tracker: its mean x[7] and row-major covariance p[49]
// stay in registers.  Every function repeats the operation order of the
// plain PyTorch version (src/repro_torch/kernels/ref.py) term by term, sums
// starting from 0 and off-diagonal noise adding 0, so a kernel built with
// --fmad=false and IEEE division and square root agrees with it bit for
// bit.

#pragma once

#include <cuda_runtime.h>

namespace sortdev {

constexpr int kMaxT = 32;      // tracker slots per stream (wrappers check)
constexpr int kMaxD = 32;      // detections per stream (wrappers check)
constexpr int kStreams = 8;    // streams per block: 8 floats = one 32 B sector
constexpr float kEps = 1e-9f;

__device__ __forceinline__ constexpr float q_diag(int i) {
  return i < 4 ? 1.0f : (i < 6 ? 0.01f : 1e-4f);
}
__device__ __forceinline__ constexpr float r_diag(int i) {
  return i < 2 ? 1.0f : 10.0f;
}
// the initial covariance of a newborn or re-initialised tracker
__device__ __forceinline__ constexpr float p0(int r) {
  return (r % 8 != 0) ? 0.0f : (r < 32 ? 10.0f : 1e4f);
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

// Constant-velocity predict (F P F^T + Q, area velocity clamped), in place.
__device__ __forceinline__ void predict(float x[7], float p[49]) {
  const float ds = (x[2] + x[6] <= 0.0f) ? 0.0f : x[6];
  x[0] = x[0] + x[4];
  x[1] = x[1] + x[5];
  x[2] = x[2] + ds;
  x[6] = ds;
  // row-major ascending: every entry read below is still the pre-predict
  // value when it is read
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      float v = p[i * 7 + j];
      if (i < 3) v = v + p[(i + 4) * 7 + j];
      if (j < 3) v = v + p[i * 7 + j + 4];
      if (i < 3 && j < 3) v = v + p[(i + 4) * 7 + j + 4];
      p[i * 7 + j] = v + (i == j ? q_diag(i) : 0.0f);
    }
  }
}

struct Box { float x1, y1, x2, y2; };

// ref.z_to_xyxy_lane: the box of a state's first four entries.
__device__ __forceinline__ Box z_to_xyxy(const float x[7]) {
  const float sa = fmaxf(x[2], 0.0f);
  const float ra = fmaxf(x[3], kEps);
  const float w = sqrtf(sa * ra);
  const float h = sa / fmaxf(w, kEps);
  const float hw = w / 2.0f, hh = h / 2.0f;
  return {x[0] - hw, x[1] - hh, x[0] + hw, x[1] + hh};
}

// ref.xyxy_to_z_lane: a detection box as an observation [u, v, s, r].
__device__ __forceinline__ void xyxy_to_z(float x1, float y1, float x2,
                                          float y2, float z[4]) {
  const float w = x2 - x1, h = y2 - y1;
  z[0] = x1 + w / 2.0f;
  z[1] = y1 + h / 2.0f;
  z[2] = w * h;
  z[3] = w / fmaxf(h, kEps);
}

// ref.iou_lane for one (detection, tracker) pair.
__device__ __forceinline__ float iou(float ax1, float ay1, float ax2,
                                     float ay2, const Box& b) {
  const float iw = fmaxf(fminf(ax2, b.x2) - fmaxf(ax1, b.x1), 0.0f);
  const float ih = fmaxf(fminf(ay2, b.y2) - fmaxf(ay1, b.y1), 0.0f);
  const float inter = iw * ih;
  const float ua = fmaxf(ax2 - ax1, 0.0f) * fmaxf(ay2 - ay1, 0.0f);
  const float ub = fmaxf(b.x2 - b.x1, 0.0f) * fmaxf(b.y2 - b.y1, 0.0f);
  return inter / fmaxf(ua + ub - inter, 1e-9f);
}

// ref.update_lane, in place: the Kalman update with observation z, blended
// with the prior by the 0/1 mask m (computed for every slot, as the plain
// version does, so a NaN or a signed zero comes out the same).
__device__ __forceinline__ void masked_update(float x[7], float p[49],
                                              const float z[4], float m) {
  const float mc = 1.0f - m;
  float y[4], sm[4][4], si[4][4], k[7][4], top[4][7];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = z[i] - x[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sm[i][j] = p[i * 7 + j] + (i == j ? r_diag(i) : 0.0f);
  inv4(sm, si);
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc = acc + p[i * 7 + kk] * si[kk][j];
      k[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = acc + k[i][j] * y[j];
    const float xn = x[i] + acc;
    x[i] = m * xn + mc * x[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) top[i][j] = p[i * 7 + j];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc = acc + k[i][kk] * top[kk][j];
      const float pn = p[i * 7 + j] - acc;
      p[i * 7 + j] = m * pn + mc * p[i * 7 + j];
    }
}

}  // namespace sortdev
