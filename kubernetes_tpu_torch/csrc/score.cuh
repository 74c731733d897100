// Score arithmetic shared by the hand-written kernels (wave_solve.cu,
// wave_eval.cu): one copy of the float code, so that every kernel scores a
// (pod, node) pair with the same operations in the same order.
//
// It is the per-element form of ops/kernels.py's fit_score (the three
// NodeResourcesFit strategies) and balanced_allocation_score, with that
// module's association: 100 * (alloc - req) / safe_alloc, acc / tot_w,
// (1 - sqrt(var)) * 100, sums over R in index order. Built with -fmad=false
// and without fast math (IEEE division and square root), it agrees with the
// port's plain PyTorch versions to the last bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ktpu {

constexpr int kMaxR = 16;
constexpr int kMaxS = 16;
constexpr float kMaxNodeScore = 100.0f;

// Score-plugin parameters, staged in shared memory by each block.
struct ScoreParams {
  float colw[kMaxR];
  int balm[kMaxR];
  float su[kMaxS];
  float ss[kMaxS];
  int R;
  int n_shape;
  int strategy;  // 0 LeastAllocated, 1 MostAllocated, 2 RTCR
  float w_fit;
  float w_bal;
};

// Thread `tid` of the block copies its share of the parameters; the caller
// synchronises the block before reading them.
__device__ __forceinline__ void load_score_params(
    ScoreParams& p, int tid, const float* fit_col_w, const uint8_t* bal_mask,
    const float* shape_u, const float* shape_s, int R, int n_shape,
    int strategy, float w_fit, float w_bal) {
  if (tid == 0) {
    p.R = R;
    p.n_shape = n_shape;
    p.strategy = strategy;
    p.w_fit = w_fit;
    p.w_bal = w_bal;
  }
  if (tid < R) {
    p.colw[tid] = fit_col_w[tid];
    p.balm[tid] = bal_mask[tid] ? 1 : 0;
  }
  if (tid < n_shape) {
    p.su[tid] = shape_u[tid];
    p.ss[tid] = shape_s[tid];
  }
}

__device__ __forceinline__ float piecewise(float u, const ScoreParams& p) {
  const int S = p.n_shape;
  const bool below = u <= p.su[0];
  const bool above = u >= p.su[S - 1];
  float mid = 0.0f;
  for (int i = 0; i + 1 < S; ++i) {
    const float u0 = p.su[i], u1 = p.su[i + 1];
    const float s0 = p.ss[i], s1 = p.ss[i + 1];
    const float d = u1 - u0;
    const float t = (u - u0) / (d > 0.0f ? d : 1.0f);
    const float seg = s0 + (s1 - s0) * t;
    mid = mid + ((u > u0 && u <= u1) ? seg : 0.0f);
  }
  return below ? p.ss[0] : (above ? p.ss[S - 1] : mid);
}

// static + w_fit * fit + w_bal * balanced for one pod on one node. The
// node's scoring usage is used[r] (+ add[r] when add is given: a same-wave
// debit in the conflict check) + req[r], summed as ints like the reference.
__device__ inline float live_score(const ScoreParams& p, const int* alloc,
                                   const int* used, const int* add,
                                   const int* req, float st) {
  const int R = p.R;
  float tot_w = 0.0f, acc = 0.0f;
  for (int r = 0; r < R; ++r) {
    const float al = (float)alloc[r];
    const float rq = (float)(used[r] + (add ? add[r] : 0) + req[r]);
    const float sa = al > 0.0f ? al : 1.0f;
    float s;
    if (p.strategy == 1) {
      s = (kMaxNodeScore * rq) / sa;
    } else if (p.strategy == 2) {
      s = piecewise((kMaxNodeScore * rq) / sa, p) * (kMaxNodeScore / 10.0f);
    } else {
      s = (kMaxNodeScore * (al - rq)) / sa;
    }
    if (rq > al) s = 0.0f;
    const float w = (al > 0.0f && p.colw[r] > 0.0f) ? p.colw[r] : 0.0f;
    tot_w = tot_w + w;
    acc = acc + s * w;
  }
  const float fit = tot_w > 0.0f ? acc / tot_w : 0.0f;

  int cnt = 0;
  float sumf = 0.0f;
  for (int r = 0; r < R; ++r) {
    const float al = (float)alloc[r];
    const float rq = (float)(used[r] + (add ? add[r] : 0) + req[r]);
    const bool valid = al > 0.0f && p.balm[r];
    float frac = fminf(rq / (al > 0.0f ? al : 1.0f), 1.0f);
    frac = valid ? frac : 0.0f;
    cnt += valid ? 1 : 0;
    sumf = sumf + frac;
  }
  const float safe_cnt = cnt > 0 ? (float)cnt : 1.0f;
  const float mean = sumf / safe_cnt;
  float var = 0.0f;
  for (int r = 0; r < R; ++r) {
    const float al = (float)alloc[r];
    const float rq = (float)(used[r] + (add ? add[r] : 0) + req[r]);
    const bool valid = al > 0.0f && p.balm[r];
    float frac = fminf(rq / (al > 0.0f ? al : 1.0f), 1.0f);
    frac = valid ? frac : 0.0f;
    const float d = frac - mean;
    var = var + (valid ? d * d : 0.0f);
  }
  var = var / safe_cnt;
  float bal = (1.0f - sqrtf(var)) * kMaxNodeScore;
  bal = cnt >= 2 ? bal : 0.0f;

  float sc = st + p.w_fit * fit;
  sc = sc + p.w_bal * bal;
  return sc;
}

}  // namespace ktpu
