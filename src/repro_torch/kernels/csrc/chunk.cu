// Chunk-resident SORT for many streams: one launch per F-frame serving
// chunk (Hopper, sm_90a).
//
// Replaces src/repro/kernels/chunk.py::fused_chunk (the Pallas TPU kernel,
// body _chunk_kernel).  One launch runs F whole serving steps for every
// stream, in the order of the plain version (ref.step_chunk_lane):
// masked lane re-init, constant-velocity predict, association, masked
// Kalman update, tick, births by rank matching, inactive-lane freeze,
// emit.  The association is one of
//   - greedy: min(D, T) best-first rounds over the stream's IoU tile;
//   - hungarian: the Jonker-Volgenant solve of the stream's padded
//     max(D, T)-square assignment, in the operation order of
//     core/hungarian.py::solve (first-index argmin, the same duals and
//     augmentation), then the IoU gate -- inside the launch, where the TPU
//     kernel took a precomputed assignment from a pre-pass;
//   - gather: by a precomputed, gated trk_to_det [F, T, S] (the TPU
//     kernel's own interface).
//
// Layout (streams on the minor axis).  State: x [7,T,S], p [49,T,S] f32;
// alive, age, hits, hit_streak, time_since_update, uid, cls [T,S] i32;
// next_uid, frame_count [1,S] i32.  Per frame: det [F,D,4,S], det_mask
// [F,D,S], active [F,1,S] f32; reset [F,1,S] i32; trk_to_det [F,T,S] i32.
// Out: the state, boxes [F,T,4,S] f32, uid, emit, trk_to_det, cls [F,T,S]
// and matched_det [F,D,S] i32.
//
// What bounds it: bytes.  The state (63 words a slot, 2 a stream) is read
// once and written once per launch; each frame reads 4D+D+2 words and
// writes 8T+D words per stream.  At S=2048, T=D=16, F=32 that is 75.8 MB,
// about 22.6 us at 3.35 TB/s.  The design: thread (s, t) keeps tracker t
// of stream s -- its mean, covariance and lifecycle -- in registers for all
// F frames; neighbouring threads take neighbouring streams, so every
// global load and store is coalesced; a stream's detections, masks and
// assignment go through shared memory.  The serial per-stream work (greedy
// rounds and the JV solve) runs on one thread per stream over a
// shared-memory tile sized by the launch: the simple form, not yet the
// fast one.
//
// Arithmetic shares sort_device.cuh with frame.cu.  Built with
// --fmad=false and IEEE division and square root, so it agrees with the
// plain version bit for bit, ties included.

#include <cuda_runtime.h>

#include "sort_device.cuh"

// The launch's arguments, passed by pointer through the C entry point (so
// at namespace scope: the entry point must keep external linkage).
// Mirrored by kernels/chunk.py::_Args.
struct ChunkArgs {
  const float* in_x;
  const float* in_p;
  const int* in_alive;
  const int* in_age;
  const int* in_hits;
  const int* in_hit_streak;
  const int* in_tsu;
  const int* in_uid;
  const int* in_cls;
  const int* in_next_uid;
  const int* in_frame_count;
  const float* det;
  const float* det_mask;
  const float* active;
  const int* reset;
  const int* t2d_in;
  float* out_x;
  float* out_p;
  int* out_alive;
  int* out_age;
  int* out_hits;
  int* out_hit_streak;
  int* out_tsu;
  int* out_uid;
  int* out_cls;
  int* out_next_uid;
  int* out_frame_count;
  float* boxes;
  int* uid;
  int* emit;
  int* t2d;
  int* matched;
  int* cls;
  int F, T, D, S, assoc, max_age, min_hits;
  float iou_threshold;
};

namespace {

using namespace sortdev;

enum Assoc { kGreedy = 0, kHungarian = 1, kGather = 2 };

constexpr float kInf = 1.0e18f;     // core/hungarian.py::_INF

// The Hungarian association of stream tx (one thread): cost -iou over the
// valid (detection, live tracker) pairs, padded to n x n with
// auto_pad_value, solved by JV, gated and inverted into t2d_sh.  Column j
// of the tile already holds -iou of every detection against tracker j.
__device__ void hungarian_stream(float* c, float* u, float* v, float* spc,
                                 int* path, int* col4row, int* row4col,
                                 const float (*dm_sh)[kStreams],
                                 const int (*alive_sh)[kStreams],
                                 int (*t2d_sh)[kStreams], int n, int T,
                                 int D, int tx, float iou_threshold) {
#define C(i, j) c[((i) * n + (j)) * kStreams + tx]
#define AT(a, k) a[(k) * kStreams + tx]
  auto valid = [&](int i, int j) {
    return i < D && j < T && dm_sh[i][tx] > 0.0f && alive_sh[j][tx] != 0;
  };
  // auto_pad_value: cmax + n * (cmax - cmin) + 1 over the valid entries
  float big = -kInf, small = kInf;
  bool any = false;
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < T; ++j)
      if (valid(i, j)) {
        any = true;
        big = fmaxf(big, C(i, j));
        small = fminf(small, C(i, j));
      }
  if (!any) return;                     // nothing can pass the gate
  const float cmax = fmaxf(big, 0.0f);
  const float cmin = fminf(small, 0.0f);
  const float pad = cmax + static_cast<float>(n) * (cmax - cmin) + 1.0f;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      if (!valid(i, j)) C(i, j) = pad;

  for (int k = 0; k < n; ++k) {
    AT(u, k) = 0.0f;
    AT(v, k) = 0.0f;
    AT(col4row, k) = -1;
    AT(row4col, k) = -1;
  }
  for (int cur_row = 0; cur_row < n; ++cur_row) {
    // Dijkstra over columns for an augmenting path from cur_row
    for (int k = 0; k < n; ++k) {
      AT(spc, k) = kInf;
      AT(path, k) = -1;
    }
    unsigned sr = 0u, sc = 0u;
    int i = cur_row, sink = -1;
    float min_val = 0.0f;
    for (int it = 0; it <= cur_row && sink < 0; ++it) {
      sr |= 1u << i;
      const float ui = AT(u, i);
      for (int j = 0; j < n; ++j) {
        if ((sc >> j) & 1u) continue;
        const float red = ((min_val + C(i, j)) - ui) - AT(v, j);
        if (red < AT(spc, j)) {
          AT(spc, j) = red;
          AT(path, j) = i;
        }
      }
      int jmin = 0;
      float best = (sc & 1u) ? kInf : AT(spc, 0);
      for (int j = 1; j < n; ++j) {
        const float m = ((sc >> j) & 1u) ? kInf : AT(spc, j);
        if (m < best) { best = m; jmin = j; }     // first index on ties
      }
      min_val = AT(spc, jmin);
      sc |= 1u << jmin;
      const int owner = AT(row4col, jmin);
      if (owner < 0) sink = jmin; else i = owner;
    }
    // dual updates (scipy's rectangular_lsap order)
    AT(u, cur_row) = AT(u, cur_row) + min_val;
    for (int k = 0; k < n; ++k) {
      if (k == cur_row || !((sr >> k) & 1u)) continue;
      const int col = AT(col4row, k);
      const float prev = AT(spc, col < 0 ? 0 : (col > n - 1 ? n - 1 : col));
      AT(u, k) = (AT(u, k) + min_val) - prev;
    }
    for (int j = 0; j < n; ++j)
      if ((sc >> j) & 1u) AT(v, j) = (AT(v, j) + AT(spc, j)) - min_val;
    // augment along the alternating path back from the sink
    int j = sink;
    for (int it = 0; it <= cur_row; ++it) {
      const int pi = AT(path, j);
      AT(row4col, j) = pi;
      const int nxt = AT(col4row, pi < 0 ? 0 : pi);
      if (pi >= 0) AT(col4row, pi) = j;
      j = nxt;
      if (pi == cur_row) break;
    }
  }
  // gate (in range, live tracker, IoU >= threshold) and invert
  for (int di = 0; di < D; ++di) {
    const int col = AT(col4row, di);
    const int safe = (col >= 0 && col < T) ? col : 0;
    if (col < T && valid(di, safe) && -C(di, safe) >= iou_threshold)
      t2d_sh[safe][tx] = di;
  }
#undef C
#undef AT
}

// Grid: one block per kStreams consecutive streams; block (kStreams, T):
// threadIdx.x is the stream within the block, threadIdx.y the tracker slot.
template <int kAssoc>
__global__ void __launch_bounds__(kStreams * kMaxT)
fused_chunk_kernel(const ChunkArgs a) {
  __shared__ float det_sh[kMaxD][4][kStreams];
  __shared__ float dm_sh[kMaxD][kStreams];
  __shared__ int t2d_sh[kMaxT][kStreams];
  __shared__ int alive_sh[kMaxT][kStreams];
  __shared__ int matched_sh[kMaxD][kStreams];
  // greedy: the [D*T] score tile; hungarian: the [n*n] cost tile, then
  // u, v, spc (float) and path, col4row, row4col (int), n each; all with
  // the block's streams on the minor axis
  extern __shared__ float dyn[];

  const int T = a.T, D = a.D, S = a.S;
  const int n = D > T ? D : T;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int s = blockIdx.x * kStreams + tx;
  const bool in_s = s < S;
  const long TS = static_cast<long>(T) * S;
  const long ts = static_cast<long>(ty) * S + s;

  float x[7], p[49];
  int alive = 0, age = 0, hits = 0, hs = 0, tsu = 0, uid = -1, cls = -1;
  int next_uid = 1, fc = 0;
  if (in_s) {
#pragma unroll
    for (int r = 0; r < 7; ++r) x[r] = a.in_x[r * TS + ts];
#pragma unroll
    for (int r = 0; r < 49; ++r) p[r] = a.in_p[r * TS + ts];
    alive = a.in_alive[ts];
    age = a.in_age[ts];
    hits = a.in_hits[ts];
    hs = a.in_hit_streak[ts];
    tsu = a.in_tsu[ts];
    uid = a.in_uid[ts];
    cls = a.in_cls[ts];
    next_uid = a.in_next_uid[s];
    fc = a.in_frame_count[s];
  } else {
#pragma unroll
    for (int r = 0; r < 7; ++r) x[r] = 0.0f;
#pragma unroll
    for (int r = 0; r < 49; ++r) p[r] = 0.0f;
  }

  for (int f = 0; f < a.F; ++f) {
    const long fs = static_cast<long>(f) * S + s;
    const bool act = in_s && a.active[fs] > 0.0f;
    // ---- masked lane re-init: a recycled lane's first frame ----
    if (in_s && a.reset[fs] > 0) {
#pragma unroll
      for (int r = 0; r < 7; ++r) x[r] = 0.0f;
#pragma unroll
      for (int r = 0; r < 49; ++r) p[r] = p0(r);
      alive = age = hits = hs = tsu = 0;
      uid = cls = -1;
      next_uid = 1;
      fc = 0;
    }
    const float* det_f = a.det + static_cast<long>(f) * D * 4 * S;
    for (int k = ty; k < 4 * D; k += T)
      det_sh[k >> 2][k & 3][tx] =
          in_s ? det_f[static_cast<long>(k) * S + s] : 0.0f;
    for (int k = ty; k < D; k += T)
      dm_sh[k][tx] = in_s ? a.det_mask[(static_cast<long>(f) * D + k) * S + s]
                          : 0.0f;
    alive_sh[ty][tx] = alive;
    t2d_sh[ty][tx] = -1;

    // ---- predict every slot of an active lane ----
    if (act) predict(x, p);
    __syncthreads();                        // det_sh, dm_sh, alive_sh

    // ---- association ----
    if constexpr (kAssoc == kGather) {
      if (in_s) t2d_sh[ty][tx] = a.t2d_in[(static_cast<long>(f) * T + ty) * S + s];
    } else if constexpr (kAssoc == kGreedy) {
      float* score = dyn;                   // [d*T + t][kStreams]
      const bool trk_ok = act && alive != 0;
      const Box b = trk_ok ? z_to_xyxy(x) : Box{0.0f, 0.0f, 0.0f, 0.0f};
      for (int d = 0; d < D; ++d) {
        float sc = -1.0f;
        if (trk_ok && dm_sh[d][tx] > 0.0f) {
          const float v = iou(det_sh[d][0][tx], det_sh[d][1][tx],
                              det_sh[d][2][tx], det_sh[d][3][tx], b);
          if (v >= a.iou_threshold) sc = v;
        }
        score[(d * T + ty) * kStreams + tx] = sc;
      }
      __syncthreads();
      // min(D, T) rounds over the flat d*T + t index, first index on ties
      if (ty == 0 && act) {
        const int rounds = D < T ? D : T;
        const int nn = D * T;
        for (int r = 0; r < rounds; ++r) {
          float best = score[tx];
          int idx = 0;
          for (int k = 1; k < nn; ++k) {
            const float v = score[k * kStreams + tx];
            if (v > best) { best = v; idx = k; }
          }
          if (!(best > 0.0f)) break;   // later rounds would match nothing
          const int di = idx / T, ti = idx % T;
          t2d_sh[ti][tx] = di;
          for (int k = 0; k < T; ++k) score[(di * T + k) * kStreams + tx] = -1.0f;
          for (int k = 0; k < D; ++k) score[(k * T + ti) * kStreams + tx] = -1.0f;
        }
      }
    } else {
      float* c = dyn;                       // [i*n + j][kStreams]
      if (act) {
        const Box b = z_to_xyxy(x);
        for (int d = 0; d < D; ++d)
          c[(d * n + ty) * kStreams + tx] =
              -iou(det_sh[d][0][tx], det_sh[d][1][tx], det_sh[d][2][tx],
                   det_sh[d][3][tx], b);
      }
      __syncthreads();
      if (ty == 0 && act && D > 0) {
        float* u = c + n * n * kStreams;
        float* v = u + n * kStreams;
        float* spc = v + n * kStreams;
        int* path = reinterpret_cast<int*>(spc + n * kStreams);
        int* col4row = path + n * kStreams;
        int* row4col = col4row + n * kStreams;
        hungarian_stream(c, u, v, spc, path, col4row, row4col, dm_sh,
                         alive_sh, t2d_sh, n, T, D, tx, a.iou_threshold);
      }
    }
    __syncthreads();                        // t2d_sh complete

    const int t2d = t2d_sh[ty][tx];
    for (int d = ty; d < D; d += T) {
      int m = 0;
      for (int k = 0; k < T; ++k) m |= (t2d_sh[k][tx] == d);
      matched_sh[d][tx] = m;
    }
    if (act) {
      // ---- masked update with the assigned observation ----
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (t2d >= 0 && t2d < D)
        xyxy_to_z(det_sh[t2d][0][tx], det_sh[t2d][1][tx],
                  det_sh[t2d][2][tx], det_sh[t2d][3][tx], z);
      masked_update(x, p, z, t2d >= 0 ? 1.0f : 0.0f);
      // ---- tick: matched slots refresh, the others age and may die ----
      const bool was = alive != 0;
      const bool hit = was && t2d >= 0;
      const bool miss = was && t2d < 0;
      tsu = hit ? 0 : tsu + (miss ? 1 : 0);
      const bool now = was && tsu <= a.max_age;
      if (was) age = age + 1;
      hits = hits + (hit ? 1 : 0);
      hs = hit ? hs + 1 : (miss ? 0 : hs);
      if (!now) { uid = -1; cls = -1; }
      alive = now ? 1 : 0;
    }
    __syncthreads();                        // matched_sh done, alive_sh free
    alive_sh[ty][tx] = alive;
    __syncthreads();

    if (act) {
      // ---- births: the k-th unmatched detection takes the k-th free slot
      int want = 0;
      for (int d = 0; d < D; ++d)
        want += (dm_sh[d][tx] > 0.0f && !matched_sh[d][tx]) ? 1 : 0;
      int free_all = 0, rank = 0;
      for (int k = 0; k < T; ++k) {
        const int fr = alive_sh[k][tx] == 0 ? 1 : 0;
        free_all += fr;
        if (k < ty) rank += fr;
      }
      if (alive == 0 && rank < want) {
        int d = 0, seen = 0;
        for (; d < D; ++d) {
          if (dm_sh[d][tx] > 0.0f && !matched_sh[d][tx]) {
            if (seen == rank) break;
            ++seen;
          }
        }
        float z[4];
        xyxy_to_z(det_sh[d][0][tx], det_sh[d][1][tx], det_sh[d][2][tx],
                  det_sh[d][3][tx], z);
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = z[r];
#pragma unroll
        for (int r = 4; r < 7; ++r) x[r] = 0.0f;
#pragma unroll
        for (int r = 0; r < 49; ++r) p[r] = p0(r);
        alive = 1;
        age = hits = hs = tsu = 0;
        uid = next_uid + rank;
        cls = 0;
      }
      next_uid = next_uid + (want < free_all ? want : free_all);
      fc = fc + 1;
    }

    // ---- emit and the frame's outputs ----
    if (in_s) {
      const bool emit = act && alive != 0 && tsu < 1 &&
                        (hs >= a.min_hits || fc <= a.min_hits);
      const Box b = z_to_xyxy(x);
      const long ft = (static_cast<long>(f) * T + ty) * S + s;
      float* bo = a.boxes + (static_cast<long>(f) * T + ty) * 4 * S + s;
      bo[0] = b.x1;
      bo[S] = b.y1;
      bo[2L * S] = b.x2;
      bo[3L * S] = b.y2;
      a.uid[ft] = uid;
      a.emit[ft] = emit ? 1 : 0;
      a.t2d[ft] = t2d;
      a.cls[ft] = cls;
      for (int d = ty; d < D; d += T)
        a.matched[(static_cast<long>(f) * D + d) * S + s] = matched_sh[d][tx];
    }
    __syncthreads();                        // shared tiles free for f + 1
  }

  if (!in_s) return;
#pragma unroll
  for (int r = 0; r < 7; ++r) a.out_x[r * TS + ts] = x[r];
#pragma unroll
  for (int r = 0; r < 49; ++r) a.out_p[r * TS + ts] = p[r];
  a.out_alive[ts] = alive;
  a.out_age[ts] = age;
  a.out_hits[ts] = hits;
  a.out_hit_streak[ts] = hs;
  a.out_tsu[ts] = tsu;
  a.out_uid[ts] = uid;
  a.out_cls[ts] = cls;
  if (ty == 0) {
    a.out_next_uid[s] = next_uid;
    a.out_frame_count[s] = fc;
  }
}

}  // namespace

// Plain C entry point for ctypes.  `a->t2d_in` is read only when
// `a->assoc` is 2 (gather).  Returns the CUDA error of the launch
// (0 = cudaSuccess); does not synchronise.
extern "C" int fused_chunk_launch(const ChunkArgs* a, void* stream) {
  const int T = a->T, D = a->D;
  if (T < 1 || T > kMaxT || D < 0 || D > kMaxD || a->S < 1 || a->F < 1 ||
      a->assoc < kGreedy || a->assoc > kGather ||
      (a->assoc == kGather && a->t2d_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = D > T ? D : T;
  const dim3 block(kStreams, T);
  const dim3 grid((a->S + kStreams - 1) / kStreams);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->assoc == kGreedy) {
    const size_t shm = sizeof(float) * D * T * kStreams;
    fused_chunk_kernel<kGreedy><<<grid, block, shm, st>>>(*a);
  } else if (a->assoc == kHungarian) {
    const size_t shm = sizeof(float) * (n * n + 6 * n) * kStreams;
    fused_chunk_kernel<kHungarian><<<grid, block, shm, st>>>(*a);
  } else {
    fused_chunk_kernel<kGather><<<grid, block, 0, st>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}
