// Hand-written Hopper kernel for one wave's shard-local evaluation in the
// node-sharded wavefront solve.
//
// Replaces: kubernetes_tpu/ops/pallas_kernel.py `wave_eval` /
// `_wave_eval_kernel`, the Pallas kernel that parallel/sharded.py's
// `_wave_body` launches once per wave on each shard.
//
// What it computes, for each shard s, wave member w and local node n (one
// thread per element, over a grid of node blocks x W members x shards):
//   m      = mask[s, row[w], n] && (e[w] < 0 || n == el[s, w]) && real[w]
//   fits   = m && all_r req[w, r] <= free_q[s, n, r] && free_pods[s, n] >= 1
//   masked = fits ? static_sc[s, row[w], n] + w_fit * fit + w_bal * balanced
//                 : -inf
// with fit and balanced scored against used_nz[s, n] + req_nz[w] by
// score.cuh's live_score, the arithmetic wave_solve.cu uses. `el` is the
// exception column in the shard's local coordinates (e - shard base); on a
// shard that does not own the column it lies outside [0, L), and the kernel
// only compares it, never indexes with it.
//
// Layout: every shard-local array carries a leading shard axis, so that the
// shards of a mesh whose shards share one device evaluate in one launch.
//
// What bounds it on this card: bytes. Each element reads its node's state
// (3R + 1 ints), the class row's mask byte and static score, and writes a
// float and a byte; it does 9R + 10 float operations. At the main path's
// shapes (W = 32, L = 5120, R = 2) that is about 1 MB, 0.3 us at 3.35 TB/s,
// far below the few microseconds a launch costs, so a launch is bounded by
// its own latency; the design keeps the kernel to one pass with no shared
// state beyond the score parameters. A later version would fuse the W
// prefix-distinct argmax rounds that follow it into the same launch.

#include "score.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 65535;  // gridDim.y
constexpr int kMaxShards = 65535;   // gridDim.z

struct EvalArgs {
  const uint8_t* mask;     // (S, C, L) bool class mask
  const float* static_sc;  // (S, C, L)
  const int* alloc_q;      // (S, L, R)
  const int* free_q;       // (S, L, R)
  const int* free_pods;    // (S, L)
  const int* used_nz;      // (S, L, R)
  const int* req;          // (W, R)
  const int* req_nz;       // (W, R)
  const int* row;          // (W,) class row per member
  const int* e;            // (W,) global exception column, -1 = none
  const int* el;           // (S, W) exception column in local coordinates
  const uint8_t* real;     // (W,) bool, false = padding member
  const float* fit_col_w;  // (R,)
  const uint8_t* bal_mask; // (R,)
  const float* shape_u;    // (n_shape,)
  const float* shape_s;    // (n_shape,)
  int n_shape;
  float w_fit;
  float w_bal;
  int strategy;
  int S, C, L, R, W;
  float* masked;           // (S, W, L) out
  uint8_t* m;              // (S, W, L) out, bool
};

__global__ void __launch_bounds__(kThreads) wave_eval_kernel(EvalArgs a) {
  __shared__ ktpu::ScoreParams p;
  ktpu::load_score_params(p, threadIdx.x, a.fit_col_w, a.bal_mask,
                          a.shape_u, a.shape_s, a.R, a.n_shape, a.strategy,
                          a.w_fit, a.w_bal);
  __syncthreads();

  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.L) return;
  const int w = blockIdx.y;
  const int s = blockIdx.z;
  const int R = a.R;
  const int row = a.row[w];
  const int e = a.e[w];
  const int el = a.el[(size_t)s * a.W + w];
  const size_t node = (size_t)s * a.L + n;
  const size_t plane = ((size_t)s * a.C + row) * a.L + n;

  const bool gate = a.mask[plane] && (e < 0 || n == el) && a.real[w];
  bool fits = gate && a.free_pods[node] >= 1;
  for (int r = 0; r < R; ++r)
    fits = fits && a.req[w * R + r] <= a.free_q[node * R + r];
  const float sc = ktpu::live_score(p, a.alloc_q + node * R,
                                    a.used_nz + node * R, nullptr,
                                    a.req_nz + w * R, a.static_sc[plane]);
  const size_t out = ((size_t)s * a.W + w) * a.L + n;
  a.masked[out] = fits ? sc : -INFINITY;
  a.m[out] = gate ? 1 : 0;
}

}  // namespace

extern "C" {

int ktpu_wave_eval_max_members() { return kMaxMembers; }
int ktpu_wave_eval_max_shards() { return kMaxShards; }

int ktpu_wave_eval(const uint8_t* mask, const float* static_sc,
                   const int* alloc_q, const int* free_q,
                   const int* free_pods, const int* used_nz, const int* req,
                   const int* req_nz, const int* row, const int* e,
                   const int* el, const uint8_t* real,
                   const float* fit_col_w, const uint8_t* bal_mask,
                   const float* shape_u, const float* shape_s, int n_shape,
                   float w_fit, float w_bal, int strategy, int S, int C,
                   int L, int R, int W, float* masked, uint8_t* m,
                   void* stream) {
  EvalArgs a;
  a.mask = mask; a.static_sc = static_sc; a.alloc_q = alloc_q;
  a.free_q = free_q; a.free_pods = free_pods; a.used_nz = used_nz;
  a.req = req; a.req_nz = req_nz; a.row = row; a.e = e; a.el = el;
  a.real = real; a.fit_col_w = fit_col_w; a.bal_mask = bal_mask;
  a.shape_u = shape_u; a.shape_s = shape_s; a.n_shape = n_shape;
  a.w_fit = w_fit; a.w_bal = w_bal; a.strategy = strategy;
  a.S = S; a.C = C; a.L = L; a.R = R; a.W = W;
  a.masked = masked; a.m = m;
  const dim3 grid((L + kThreads - 1) / kThreads, W, S);
  wave_eval_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
