// Hand-written Hopper kernel for the greedy wavefront batch solve.
//
// Replaces: kubernetes_tpu/ops/pallas_kernel.py `wave_solve` /
// `_wave_step_kernel` (the Pallas kernel whose grid is K multistart orders
// x P/W waves, carry resident per order), and the `lowering_supported`
// `_probe_kernel` (x + 1 on an (8, 128) f32 tile) as `probe_kernel`.
//
// What it computes, per order k (one thread block each; a loop over waves
// inside the block stands in for the TPU grid's sequential wave axis,
// since CUDA blocks run in no order):
//   for each wave of W pods (in the order's permuted pod stream):
//     for each member w: one block-wide strided pass over the N nodes —
//       mask bit of class row rows[w] (big-endian packed), exception gate,
//       capacity fit, static + w_fit*fit + w_bal*balanced score, -inf on
//       nodes an earlier member of this wave picked — then a block
//       reduction on (score desc, node id asc): the serial argmax rule of
//       solver._wave_spec_picks;
//     the W x W same-wave conflict check of solver._wave_conflicts, one
//     thread per pair;
//     commit (picks are distinct nodes, so the W debits run in parallel),
//     or, with poison == 0 and a conflict, replay the wave serially
//     against the live carry; with poison == 1 a conflict sets the order's
//     poison flag and the wave commits.
// The carry (free_q, free_pods, used_nz) lives in per-order global memory
// (K,N,R)/(K,N)/(K,N,R), seeded from the chunk state; at N=5000, R=2 it is
// about 100 KB per order and stays in the 50 MB L2.
//
// Floats: the score arithmetic is score.cuh's, shared with wave_eval.cu
// (-fmad=false, IEEE division and square root, sums over R in index order,
// the association of ops/kernels.py). The kernel then agrees with the
// port's plain PyTorch version (ops/wave_kernel.wave_solve_reference) to
// the last bit, and its assignments and counters are identical.
//
// What bounds it on this card: latency, not bytes or operations. Only K
// blocks (K = 4 on the main path) run on 132 SMs, and each wave runs W
// block reductions one after another, each over a few thousand nodes.
// A later version would spread an order over several blocks with a
// cross-block argmax (a cluster and distributed shared memory), evaluate
// the W members of a wave in one pass with a per-member top-W, and capture
// the chunk's launches in a CUDA graph.

#include "score.cuh"

namespace {

using ktpu::kMaxR;
using ktpu::ScoreParams;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 64;

struct WaveArgs {
  const int* req_q;          // (P, R)
  const int* req_nz_q;       // (P, R)
  const int* rows;           // (P,) class row per pod
  const int* exc;            // (P,) exception column, -1 = none
  const int* perms;          // (K, P) pod order per block
  const int* free_q0;        // (N, R)
  const int* free_pods0;     // (N,)
  const int* used_nz0;       // (N, R)
  const int* alloc_q;        // (N, R)
  const uint8_t* bits;       // (C, nb) big-endian packed class mask
  const float* static_sc;    // (C, N)
  const float* fit_col_w;    // (R,)
  const uint8_t* bal_mask;   // (R,)
  const float* shape_u;      // (S,)
  const float* shape_s;      // (S,)
  int n_shape;
  float w_fit;
  float w_bal;
  int strategy;              // 0 LeastAllocated, 1 MostAllocated, 2 RTCR
  int K, P, N, R, nb, W, poison;
  int* assign;               // (K, P) out, permuted pod coordinates
  int* stats;                // (K, 4) out: commits, replays, poisoned, 0
  int* free_q;               // (K, N, R) carry
  int* free_pods;            // (K, N) carry
  int* used_nz;              // (K, N, R) carry
};

// One wave's members, staged in shared memory.
struct Members {
  const int* req;   // (W, R)
  const int* rnz;   // (W, R)
  const int* row;   // (W,)
  const int* exc;   // (W,)
  const int* real;  // (W,)
};

// One order's carry, in global memory.
struct Carry {
  int* fq;   // (N, R)
  int* fp;   // (N,)
  int* unz;  // (N, R)
};

// Gated mask of member w at node n: class row bit, exception column, real
// (non-padding) member.
__device__ __forceinline__ bool gated(const WaveArgs& a, const Members& m,
                                      int w, int n) {
  if (!m.real[w]) return false;
  const int e = m.exc[w];
  if (e >= 0 && n != e) return false;
  const uint8_t byte = a.bits[(size_t)m.row[w] * a.nb + (n >> 3)];
  return (byte >> (7 - (n & 7))) & 1;
}

// Gated mask and capacity fit of member w at node n against the carry.
__device__ __forceinline__ bool fits(const WaveArgs& a, const Members& m,
                                     const Carry& c, int w, int n) {
  if (!gated(a, m, w, n) || c.fp[n] < 1) return false;
  for (int r = 0; r < a.R; ++r)
    if (m.req[w * a.R + r] > c.fq[(size_t)n * a.R + r]) return false;
  return true;
}

__device__ __forceinline__ float score(const WaveArgs& a,
                                       const ScoreParams& p,
                                       const Members& m, const Carry& c,
                                       int w, int n, const int* add) {
  return ktpu::live_score(p, a.alloc_q + (size_t)n * a.R,
                    c.unz + (size_t)n * a.R, add, m.rnz + w * a.R,
                    a.static_sc[(size_t)m.row[w] * a.N + n]);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Block-wide argmax on (score desc, index asc); every thread gets the result.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : -INFINITY;
    i = lane < kWarps ? si[lane] : 0x7fffffff;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { sv[0] = v; si[0] = i; }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
wave_solve_kernel(WaveArgs a) {
  __shared__ ScoreParams p;
  __shared__ int s_req[kMaxW * kMaxR];
  __shared__ int s_rnz[kMaxW * kMaxR];
  __shared__ int s_row[kMaxW];
  __shared__ int s_exc[kMaxW];
  __shared__ int s_real[kMaxW];
  __shared__ float s_b[kMaxW];
  __shared__ int s_y[kMaxW];
  __shared__ float s_rv[kWarps];
  __shared__ int s_ri[kWarps];
  __shared__ int s_conf;

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = a.N, R = a.R, W = a.W, P = a.P;
  int* fq = a.free_q + (size_t)k * N * R;
  int* fp = a.free_pods + (size_t)k * N;
  int* unz = a.used_nz + (size_t)k * N * R;
  const int* perm = a.perms + (size_t)k * P;

  ktpu::load_score_params(p, tid, a.fit_col_w, a.bal_mask, a.shape_u,
                          a.shape_s, R, a.n_shape, a.strategy, a.w_fit,
                          a.w_bal);
  for (int idx = tid; idx < N * R; idx += kThreads) {
    fq[idx] = a.free_q0[idx];
    unz[idx] = a.used_nz0[idx];
  }
  for (int n = tid; n < N; n += kThreads) fp[n] = a.free_pods0[n];
  __syncthreads();

  const Members m{s_req, s_rnz, s_row, s_exc, s_real};
  const Carry c{fq, fp, unz};

  int ncom = 0, nrep = 0, pois = 0;
  const int n_waves = (P + W - 1) / W;
  for (int wave = 0; wave < n_waves; ++wave) {
    const int base = wave * W;
    const int nreal = min(W, P - base);
    if (tid < W) {
      const int i = base + tid;
      const bool real = i < P;
      const int pod = real ? perm[i] : 0;
      s_real[tid] = real ? 1 : 0;
      s_row[tid] = real ? a.rows[pod] : 0;
      s_exc[tid] = real ? a.exc[pod] : 0;
    }
    for (int idx = tid; idx < W * R; idx += kThreads) {
      const int w = idx / R, r = idx - w * R;
      const int i = base + w;
      const bool real = i < P;
      const int pod = real ? perm[i] : 0;
      s_req[idx] = real ? a.req_q[(size_t)pod * R + r] : 0;
      s_rnz[idx] = real ? a.req_nz_q[(size_t)pod * R + r] : 0;
    }
    __syncthreads();

    // Speculative prefix-distinct picks against the wave-start carry.
    for (int w = 0; w < W; ++w) {
      float bv = -INFINITY;
      int bi = N;
      for (int n = tid; n < N; n += kThreads) {
        if (!fits(a, m, c, w, n)) continue;
        bool taken = false;
        for (int j = 0; j < w; ++j) taken |= (s_y[j] == n);
        if (taken) continue;
        const float v = score(a, p, m, c, w, n, nullptr);
        if (v > bv) { bv = v; bi = n; }
      }
      block_argmax(bv, bi, s_rv, s_ri);
      if (tid == 0) {
        s_b[w] = bv;
        s_y[w] = bv > -INFINITY ? bi : N;
      }
      __syncthreads();
    }

    // Pairwise conflicts: does an earlier member's debit make its node
    // beat member w's pick for pod w?
    if (tid == 0) s_conf = 0;
    __syncthreads();
    for (int pair = tid; pair < W * W; pair += kThreads) {
      const int w = pair / W, j = pair - w * W;
      if (j >= w) continue;
      const int yj = s_y[j];
      if (yj >= N || !gated(a, m, w, yj)) continue;
      bool cap = true;
      for (int r = 0; r < R; ++r)
        cap = cap && s_req[w * R + r] <= fq[(size_t)yj * R + r] - s_req[j * R + r];
      if (!cap || fp[yj] - 1 < 1) continue;
      const float upd = score(a, p, m, c, w, yj, s_rnz + j * R);
      const float bw = s_b[w];
      if (upd > bw || (upd == bw && yj < s_y[w])) atomicOr(&s_conf, 1);
    }
    __syncthreads();
    const bool conflict = s_conf != 0;

    if (a.poison || !conflict) {
      if (tid < W) {
        const int y = s_y[tid];
        if (y < N) {
          for (int r = 0; r < R; ++r) {
            fq[(size_t)y * R + r] -= s_req[tid * R + r];
            unz[(size_t)y * R + r] += s_rnz[tid * R + r];
          }
          fp[y] -= 1;
        }
        if (base + tid < P) a.assign[(size_t)k * P + base + tid] = y < N ? y : -1;
      }
      ncom += nreal;
      pois |= conflict ? 1 : 0;
    } else {
      // Serial replay of the wave against the live carry.
      for (int w = 0; w < W; ++w) {
        float bv = -INFINITY;
        int bi = N;
        for (int n = tid; n < N; n += kThreads) {
          if (!fits(a, m, c, w, n)) continue;
          const float v = score(a, p, m, c, w, n, nullptr);
          if (v > bv) { bv = v; bi = n; }
        }
        block_argmax(bv, bi, s_rv, s_ri);
        if (tid == 0) {
          const int y = bv > -INFINITY ? bi : N;
          if (y < N) {
            for (int r = 0; r < R; ++r) {
              fq[(size_t)y * R + r] -= s_req[w * R + r];
              unz[(size_t)y * R + r] += s_rnz[w * R + r];
            }
            fp[y] -= 1;
          }
          if (base + w < P) a.assign[(size_t)k * P + base + w] = y < N ? y : -1;
        }
        __syncthreads();
      }
      nrep += nreal;
    }
    __syncthreads();
  }
  if (tid == 0) {
    a.stats[k * 4 + 0] = ncom;
    a.stats[k * 4 + 1] = nrep;
    a.stats[k * 4 + 2] = pois;
    a.stats[k * 4 + 3] = 0;
  }
}

__global__ void probe_kernel(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

int ktpu_max_wave_width() { return kMaxW; }
int ktpu_max_resources() { return kMaxR; }
int ktpu_max_shape_points() { return ktpu::kMaxS; }

const char* ktpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ktpu_probe(const float* x, float* out, int n, void* stream) {
  probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n);
  return static_cast<int>(cudaGetLastError());
}

int ktpu_wave_solve(const int* req_q, const int* req_nz_q, const int* rows,
                    const int* exc, const int* perms, const int* free_q0,
                    const int* free_pods0, const int* used_nz0,
                    const int* alloc_q, const uint8_t* bits,
                    const float* static_sc, const float* fit_col_w,
                    const uint8_t* bal_mask, const float* shape_u,
                    const float* shape_s, int n_shape, float w_fit,
                    float w_bal, int strategy, int K, int P, int N, int R,
                    int nb, int W, int poison, int* assign, int* stats,
                    int* free_q, int* free_pods, int* used_nz, void* stream) {
  WaveArgs a;
  a.req_q = req_q; a.req_nz_q = req_nz_q; a.rows = rows; a.exc = exc;
  a.perms = perms; a.free_q0 = free_q0; a.free_pods0 = free_pods0;
  a.used_nz0 = used_nz0; a.alloc_q = alloc_q; a.bits = bits;
  a.static_sc = static_sc; a.fit_col_w = fit_col_w; a.bal_mask = bal_mask;
  a.shape_u = shape_u; a.shape_s = shape_s; a.n_shape = n_shape;
  a.w_fit = w_fit; a.w_bal = w_bal; a.strategy = strategy;
  a.K = K; a.P = P; a.N = N; a.R = R; a.nb = nb; a.W = W; a.poison = poison;
  a.assign = assign; a.stats = stats; a.free_q = free_q;
  a.free_pods = free_pods; a.used_nz = used_nz;
  wave_solve_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
