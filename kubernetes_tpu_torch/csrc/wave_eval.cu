// Hand-written Hopper kernels for one wave of the node-sharded wavefront
// solve: the shard-local evaluation, and the wave step built around it.
//
// Replaces: kubernetes_tpu/ops/pallas_kernel.py `wave_eval` /
// `_wave_eval_kernel` (lines 385-444), the Pallas kernel that
// parallel/sharded.py's `_wave_body` launches once per wave on each shard;
// and, in the wave step, the rest of that body's `wave_step`
// (kubernetes_tpu/parallel/sharded.py:288-372): the W prefix-distinct
// winner rounds, the (W, W) conflict check and the commit / replay `cond`.
//
// Why the wave step crosses the TPU kernel's boundary: on the TPU each
// shard is a chip, so the winner rounds and the conflict bits are `pmax` /
// `pmin` over ICI and must stay outside a Pallas kernel. On one H100 every
// shard of a mesh lies on the one device, so those reductions are on-chip;
// issued from Python they were ~870 small launches and a host sync per
// wave. Here a wave is two launches and no host sync.
//
// The evaluation, for each shard s, wave member w and local node n (one
// thread per element, over a grid of node blocks x W members x shards):
//   m      = mask[s, row[w], n] && (e[w] < 0 || n == el[s, w]) && real[w]
//   fits   = m && all_r req[w, r] <= free_q[s, n, r] && free_pods[s, n] >= 1
//   masked = fits ? static_sc[s, row[w], n] + w_fit * fit + w_bal * balanced
//                 : -inf
// with fit and balanced scored against used_nz[s, n] + req_nz[w] by
// score.cuh's live_score, the arithmetic wave_solve.cu uses. Every
// shard-local array carries a leading shard axis, and shard s's node n is
// global node s * L + n.
//
// Launch A, `wave_eval_kernel`:
// - standalone (`ktpu_wave_eval`, the TPU kernel's counterpart): writes the
//   (S, W, L) masked scores and gated mask. `el` is the exception column in
//   the shard's local coordinates; the kernel only compares it.
// - wave step (`ktpu_wave_topk`): writes no plane. Each block sorts the
//   (score, global id) keys of its 256 nodes for its member w (score
//   descending, then id ascending; a bitonic sort in shared memory) and
//   writes the top w + 1 to a scratch list. Member w's pick is always among
//   its top w + 1 over all nodes, since at most w nodes are excluded by
//   earlier members, so one pass replaces the W argmax rounds. The
//   exception gate compares global ids (gid == e).
// Launch B, `wave_resolve_kernel`, one block per wave:
// 1. member by member, the best key over every block's list that no earlier
//    member took (a bitmap of taken nodes in shared memory): the
//    prefix-distinct picks, ties to the lowest global id, a best of -inf
//    meaning no pick (2^31 - 1);
// 2. the conflict check, one thread per (w, j < w): the pick y_j re-scored
//    for member w after member j's debit; w conflicts if y_j stays feasible
//    for it and scores more than w's pick, or the same at a lower id;
// 3. with no conflict, the picks debited in place; with any, the wave
//    replayed one member at a time from the carry as it was at the wave's
//    start: a block-wide argmax over all S * L nodes with live re-scoring,
//    then the debit;
// 4. the wave's (W,) assignments (-1 = none) and its replay flag written.
// max and min are associative, so the result does not depend on the
// mesh's shape: the same launches serve every mesh whose shards share one
// device. Ties agree with the plain version because score.cuh is built
// with -fmad=false and IEEE division and square root; -0 and +0 are one
// key, as they are equal to a float compare.
//
// What bounds each launch on this card. A: bytes and latency: each element
// reads its node's state (3R + 1 ints), one mask byte and one static float
// and does 9R + 10 float operations; at W = 32, N = 5120, R = 2 that is
// ~1 MB, 0.3 us at 3.35 TB/s, below a launch's own cost; its top lists add
// a 36-stage sort (one barrier each) per block. B: latency, on one SM: W
// dependent reductions for the picks, then W^2 / 2 score evaluations, and
// on a replay W block-wide scans of the S * L nodes.

#include "score.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 65535;  // gridDim.y
constexpr int kMaxShards = 65535;   // gridDim.z
constexpr int kMaxStepW = 64;       // wave step: members, top-list length
constexpr int kResolveThreads = 512;
constexpr int kNoPick = 0x7fffffff;

typedef unsigned long long u64;

struct EvalArgs {
  const uint8_t* mask;     // (S, C, L) bool class mask
  const float* static_sc;  // (S, C, L)
  const int* alloc_q;      // (S, L, R)
  int* free_q;             // (S, L, R), debited by the wave step
  int* free_pods;          // (S, L), debited by the wave step
  int* used_nz;            // (S, L, R), debited by the wave step
  const float* fit_col_w;  // (R,)
  const uint8_t* bal_mask; // (R,)
  const float* shape_u;    // (n_shape,)
  const float* shape_s;    // (n_shape,)
  u64* cand;               // wave step: (W, S * NB, W) top-list keys
  int n_shape;
  float w_fit;
  float w_bal;
  int strategy;
  int S, C, L, R, W;
  int NB;                  // node blocks per shard
  int smem;                // launch B's dynamic shared memory (bytes)
  // Per wave.
  const int* req;          // (W, R)
  const int* req_nz;       // (W, R)
  const int* row;          // (W,) class row per member
  const int* e;            // (W,) global exception column, -1 = none
  const int* el;           // standalone: (S, W) exception column, local
  const uint8_t* real;     // (W,) bool, false = padding member
  float* masked;           // standalone: (S, W, L) out
  uint8_t* m;              // standalone: (S, W, L) out, bool
  int* out;                // wave step: (W,) global node, -1 = none
  int* replayed;           // wave step: (1,) 1 if the wave replayed
};

// (score, global node id) as one ordered key: a larger key is a higher
// score, then a lower id. 0 stands for no candidate (an infeasible node).
__device__ __forceinline__ u64 pack_key(float sc, int gid) {
  if (sc == -INFINITY) return 0ull;
  const float f = sc == 0.0f ? 0.0f : sc;
  uint32_t u = __float_as_uint(f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(~(uint32_t)gid);
}

__device__ __forceinline__ int key_gid(u64 k) {
  return (int)(~(uint32_t)(k & 0xffffffffull));
}

__device__ __forceinline__ float key_score(u64 k) {
  uint32_t u = (uint32_t)(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = umax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's largest key, returned to every thread. The caller
// synchronises the block before `slots` is written again.
template <int kWarps>
__device__ __forceinline__ u64 block_max(u64 v, u64* slots) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 best = slots[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) best = umax(best, slots[i]);
  return best;
}

template <bool kTopK>
__global__ void __launch_bounds__(kThreads) wave_eval_kernel(EvalArgs a) {
  __shared__ ktpu::ScoreParams p;
  __shared__ u64 sorted[kThreads];
  ktpu::load_score_params(p, threadIdx.x, a.fit_col_w, a.bal_mask,
                          a.shape_u, a.shape_s, a.R, a.n_shape, a.strategy,
                          a.w_fit, a.w_bal);
  __syncthreads();

  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int w = blockIdx.y;
  const int s = blockIdx.z;
  const int R = a.R;
  float masked = -INFINITY;
  if (n < a.L) {
    const int row = a.row[w];
    const int e = a.e[w];
    const size_t node = (size_t)s * a.L + n;
    const size_t plane = ((size_t)s * a.C + row) * a.L + n;
    const bool col = kTopK ? (e < 0 || (int)node == e)
                           : (e < 0 || n == a.el[(size_t)s * a.W + w]);
    const bool gate = a.mask[plane] && col && a.real[w];
    bool fits = gate && a.free_pods[node] >= 1;
    for (int r = 0; r < R; ++r)
      fits = fits && a.req[w * R + r] <= a.free_q[node * R + r];
    const float sc = ktpu::live_score(p, a.alloc_q + node * R,
                                      a.used_nz + node * R, nullptr,
                                      a.req_nz + w * R, a.static_sc[plane]);
    masked = fits ? sc : -INFINITY;
    if (!kTopK) {
      const size_t out = ((size_t)s * a.W + w) * a.L + n;
      a.masked[out] = masked;
      a.m[out] = gate ? 1 : 0;
    }
  }
  if (!kTopK) return;

  // The block's top w + 1 keys, in descending order: a bitonic sort of its
  // 256 keys in shared memory (36 compare-exchange stages), whatever w is;
  // "none" (0) sorts last.
  const int tid = threadIdx.x;
  sorted[tid] = pack_key(masked, s * a.L + n);
  __syncthreads();
#pragma unroll
  for (int size = 2; size <= kThreads; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int other = tid ^ stride;
      if (other > tid) {
        const u64 x = sorted[tid], y = sorted[other];
        if ((tid & size) == 0 ? x < y : x > y) {
          sorted[tid] = y;
          sorted[other] = x;
        }
      }
      __syncthreads();
    }
  }
  u64* list = a.cand + (((size_t)w * a.S + s) * a.NB + blockIdx.x) * a.W;
  if (tid <= w) list[tid] = sorted[tid];
}

__device__ __forceinline__ void debit(const EvalArgs& a, int g,
                                      const int* req, const int* req_nz) {
  for (int r = 0; r < a.R; ++r) {
    a.free_q[(size_t)g * a.R + r] -= req[r];
    a.used_nz[(size_t)g * a.R + r] += req_nz[r];
  }
  a.free_pods[g] -= 1;
}

__global__ void __launch_bounds__(kResolveThreads)
    wave_resolve_kernel(EvalArgs a) {
  extern __shared__ uint32_t taken[];  // one bit per node of the mesh
  __shared__ ktpu::ScoreParams p;
  __shared__ u64 slots[kResolveThreads / 32];
  __shared__ int s_req[kMaxStepW * ktpu::kMaxR];
  __shared__ int s_nz[kMaxStepW * ktpu::kMaxR];
  __shared__ int s_row[kMaxStepW], s_e[kMaxStepW], s_real[kMaxStepW];
  __shared__ int s_y[kMaxStepW];
  __shared__ float s_b[kMaxStepW];
  const int tid = threadIdx.x;
  const int W = a.W, R = a.R, L = a.L;
  const int N = a.S * L;
  ktpu::load_score_params(p, tid, a.fit_col_w, a.bal_mask, a.shape_u,
                          a.shape_s, R, a.n_shape, a.strategy, a.w_fit,
                          a.w_bal);
  for (int i = tid; i < W * R; i += kResolveThreads) {
    s_req[i] = a.req[i];
    s_nz[i] = a.req_nz[i];
  }
  for (int i = tid; i < W; i += kResolveThreads) {
    s_row[i] = a.row[i];
    s_e[i] = a.e[i];
    s_real[i] = a.real[i] ? 1 : 0;
  }
  for (int i = tid; i < (N + 31) / 32; i += kResolveThreads) taken[i] = 0u;
  __syncthreads();

  // 1. Prefix-distinct picks from the blocks' top lists: member by member,
  // the best entry of the union of its lists that no earlier member took.
  const int lists = a.S * a.NB;
  for (int w = 0; w < W; ++w) {
    const int K = w + 1;
    const u64* cand = a.cand + (size_t)w * lists * W;
    u64 best = 0ull;
    for (int f = tid; f < lists * K; f += kResolveThreads) {
      const int blk = f / K;
      const u64 key = cand[(size_t)blk * W + (f - blk * K)];
      const int g = key_gid(key);
      if (key && !((taken[g >> 5] >> (g & 31)) & 1u)) best = umax(best, key);
    }
    best = block_max<kResolveThreads / 32>(best, slots);
    if (tid == 0) {
      s_y[w] = best ? key_gid(best) : kNoPick;
      s_b[w] = best ? key_score(best) : -INFINITY;
      if (best) taken[s_y[w] >> 5] |= 1u << (s_y[w] & 31);
    }
    __syncthreads();
  }

  // 2. Conflicts: member w against each earlier pick y_j after its debit.
  int conflict = 0;
  for (int f = tid; f < W * W; f += kResolveThreads) {
    const int w = f / W, j = f - w * W;
    const int yj = s_y[j];
    if (j >= w || yj == kNoPick || !s_real[w]) continue;
    const int ew = s_e[w];
    const size_t plane = ((size_t)(yj / L) * a.C + s_row[w]) * L + yj % L;
    if (!a.mask[plane] || !(ew < 0 || yj == ew) || a.free_pods[yj] - 1 < 1)
      continue;
    bool cap = true;
    for (int r = 0; r < R; ++r)
      cap = cap && s_req[w * R + r] <=
                       a.free_q[(size_t)yj * R + r] - s_req[j * R + r];
    if (!cap) continue;
    const float upd = ktpu::live_score(
        p, a.alloc_q + (size_t)yj * R, a.used_nz + (size_t)yj * R,
        s_nz + j * R, s_nz + w * R, a.static_sc[plane]);
    if (upd > s_b[w] || (upd == s_b[w] && yj < s_y[w])) conflict = 1;
  }
  if (!__syncthreads_or(conflict)) {
    // 3. Commit: the picks are distinct, so each debit is one thread's.
    for (int w = tid; w < W; w += kResolveThreads) {
      const int y = s_y[w];
      a.out[w] = y == kNoPick ? -1 : y;
      if (y != kNoPick) debit(a, y, s_req + w * R, s_nz + w * R);
    }
    if (tid == 0) *a.replayed = 0;
    return;
  }

  // 3'. Replay: one member at a time from the carry, exact.
  for (int w = 0; w < W; ++w) {
    const int row = s_row[w], e = s_e[w];
    const int* req = s_req + w * R;
    u64 best = 0ull;
    if (s_real[w]) {
      for (int g = tid; g < N; g += kResolveThreads) {
        if (e >= 0 && g != e) continue;
        const size_t plane = ((size_t)(g / L) * a.C + row) * L + g % L;
        bool fits = a.mask[plane] && a.free_pods[g] >= 1;
        for (int r = 0; r < R; ++r)
          fits = fits && req[r] <= a.free_q[(size_t)g * R + r];
        if (!fits) continue;
        best = umax(best, pack_key(
            ktpu::live_score(p, a.alloc_q + (size_t)g * R,
                             a.used_nz + (size_t)g * R, nullptr,
                             s_nz + w * R, a.static_sc[plane]), g));
      }
    }
    best = block_max<kResolveThreads / 32>(best, slots);
    if (tid == 0) {
      const int y = best ? key_gid(best) : -1;
      a.out[w] = y;
      if (y >= 0) debit(a, y, req, s_nz + w * R);
    }
    __syncthreads();
  }
  if (tid == 0) *a.replayed = 1;
}

}  // namespace

extern "C" {

int ktpu_wave_eval_max_members() { return kMaxMembers; }
int ktpu_wave_eval_max_shards() { return kMaxShards; }
int ktpu_wave_step_max_w() { return kMaxStepW; }
// Static shared memory of wave_resolve_kernel (the wrapper's limit on its
// dynamic bitmap is the card's 227 KB less this), or -1 on an error.
int ktpu_wave_resolve_static_smem() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, wave_resolve_kernel) != cudaSuccess)
    return -1;
  return static_cast<int>(attr.sharedSizeBytes);
}

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
  EvalArgs a = {};
  a.mask = mask; a.static_sc = static_sc; a.alloc_q = alloc_q;
  a.free_q = const_cast<int*>(free_q);
  a.free_pods = const_cast<int*>(free_pods);
  a.used_nz = const_cast<int*>(used_nz);
  a.req = req; a.req_nz = req_nz; a.row = row; a.e = e; a.el = el;
  a.real = real; a.fit_col_w = fit_col_w; a.bal_mask = bal_mask;
  a.shape_u = shape_u; a.shape_s = shape_s; a.n_shape = n_shape;
  a.w_fit = w_fit; a.w_bal = w_bal; a.strategy = strategy;
  a.S = S; a.C = C; a.L = L; a.R = R; a.W = W;
  a.masked = masked; a.m = m;
  const dim3 grid((L + kThreads - 1) / kThreads, W, S);
  wave_eval_kernel<false>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The wave step's launch A. `args` points to an EvalArgs holding the
// step's constant arguments (up to and including `smem`), built once per
// solve. (A void pointer: EvalArgs has internal linkage, and a C entry
// point taking it would too.)
int ktpu_wave_topk(const void* args, const int* req, const int* req_nz,
                   const int* row, const int* e, const uint8_t* real,
                   void* stream) {
  EvalArgs a = *static_cast<const EvalArgs*>(args);
  a.req = req; a.req_nz = req_nz; a.row = row; a.e = e; a.real = real;
  const dim3 grid(a.NB, a.W, a.S);
  wave_eval_kernel<true>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The wave step's launch B, on the same arguments, writing the wave's
// assignments and replay flag.
int ktpu_wave_resolve(const void* args, const int* req,
                      const int* req_nz, const int* row, const int* e,
                      const uint8_t* real, int* out, int* replayed,
                      void* stream) {
  EvalArgs a = *static_cast<const EvalArgs*>(args);
  a.req = req; a.req_nz = req_nz; a.row = row; a.e = e; a.real = real;
  a.out = out; a.replayed = replayed;
  // The default dynamic limit is 48 KB less the static arrays, so every
  // size is asked for, once, as in wave_solve.cu.
  static int smem_set = 0;
  if (a.smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wave_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = a.smem;
  }
  wave_resolve_kernel<<<1, kResolveThreads, a.smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
