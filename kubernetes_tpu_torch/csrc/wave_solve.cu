// Hand-written Hopper kernel for the greedy wavefront batch solve.
//
// Replaces: kubernetes_tpu/ops/pallas_kernel.py `wave_solve` /
// `_wave_step_kernel` (the Pallas kernel whose grid is K multistart orders
// x P/W waves, carry resident per order), and the `lowering_supported`
// `_probe_kernel` (x + 1 on an (8, 128) f32 tile) as `probe_kernel`.
//
// What it computes, per order k (one thread-block cluster each; a loop over
// waves inside the cluster stands in for the TPU grid's sequential wave
// axis, since CUDA clusters run in no order):
//   for each wave of W pods (in the order's permuted pod stream):
//     for each member w: mask bit of class row rows[w] (big-endian packed),
//       exception gate, capacity fit, static + w_fit*fit + w_bal*balanced
//       score, skipping nodes an earlier member of this wave picked; the
//       argmax on (score desc, node id asc) is the serial rule of
//       solver._wave_spec_picks;
//     the W x W same-wave conflict check of solver._wave_conflicts;
//     commit (picks are distinct nodes, so the W debits run in parallel),
//     or, with poison == 0 and a conflict, replay the wave serially
//     against the live carry; with poison == 1 a conflict sets the order's
//     poison flag and the wave commits.
//
// What bounds it on this card: latency. An order is a chain of P picks
// (plus the replays), each a reduction over all N nodes that the next pick
// waits for; the bytes (a few MB) and the score arithmetic (~0.01 ms at
// the fp32 peak) are far below the chain's length. The design shortens
// each link:
//   - One cluster of CS blocks per order (CS from ops/wave_kernel.
//     wave_launch_plan: 1 for small N, 8-16 at 5k nodes), launched with
//     cudaLaunchKernelEx. Block r owns the contiguous slice
//     [r*per, min((r+1)*per, N)) of the nodes; the last slice may be short
//     or empty.
//   - The order's carry (free_q, used_nz, free_pods) and alloc_q of the
//     block's slice live in its dynamic shared memory, copied in once:
//     every read and debit of the carry stays on-chip. Where a slice does
//     not fit (large N x R), the template's global form keeps the same
//     arrays in per-order global scratch instead; the code is the same.
//   - One pick = each thread scores its few local nodes, a warp-shuffle and
//     block argmax leave the block's best in a shared slot, one cluster
//     barrier, and every warp of every block reads all CS slots through
//     distributed shared memory and reduces them, so every thread holds the
//     same winner with no further barrier (ties to the lowest global node id; an
//     all-infeasible block offers (-inf, N)). The slot is double-buffered
//     by the barrier count's parity: a block overwrites a slot only after
//     every block has passed the next barrier, so one barrier per pick.
//   - Exclusion of earlier picks is a "taken" byte per node, set and read
//     only by the thread whose stride covers the node (no barrier), and
//     cleared when the wave ends.
//   - The conflict check runs on the owner block of each earlier pick's
//     node, against its own carry; the blocks' flags meet in one more
//     cluster barrier per wave. Replay runs the same pick loop serially;
//     the owner thread debits, so no extra barrier.
// Left for later: the W members of a wave evaluated in one pass (a
// per-member top-W), and CUDA graphs for the chunk's launches.
//
// Floats: the score arithmetic is score.cuh's, shared with wave_eval.cu
// (-fmad=false, IEEE division and square root, sums over R in index order,
// the association of ops/kernels.py). The kernel then agrees with the
// port's plain PyTorch version (ops/wave_kernel.wave_solve_reference) to
// the last bit, and its assignments and counters are identical.

#include <cooperative_groups.h>
#include <limits.h>

#include "score.cuh"

namespace cg = cooperative_groups;

namespace {

using ktpu::kMaxR;
using ktpu::ScoreParams;

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxW = 64;

struct WaveArgs {
  const int* req_q;          // (P, R)
  const int* req_nz_q;       // (P, R)
  const int* rows;           // (P,) class row per pod
  const int* exc;            // (P,) exception column, -1 = none
  const int* perms;          // (K, P) pod order per cluster
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
  int cs;                    // blocks per cluster
  int per;                   // nodes per block (the last slice may be short)
  int* assign;               // (K, P) out, permuted pod coordinates
  int* stats;                // (K, 4) out: commits, replays, poisoned, 0
  // Global form only: the carry in per-order scratch.
  int* g_fq;                 // (K, N, R)
  int* g_fp;                 // (K, N)
  int* g_unz;                // (K, N, R)
  uint8_t* g_taken;          // (K, N)
};

// One wave's members, staged in shared memory.
struct Members {
  const int* req;   // (W, R)
  const int* rnz;   // (W, R)
  const int* row;   // (W,)
  const int* exc;   // (W,)
  const int* real;  // (W,)
};

// One block's slice of its order's carry, indexed by LOCAL node id
// (node - lo): in shared memory, or in global scratch in the global form.
struct Carry {
  int* fq;            // (L, R)
  int* fp;            // (L,)
  int* unz;           // (L, R)
  const int* alloc;   // (L, R)
  uint8_t* taken;     // (L,) picked by an earlier member of this wave
};

// Dynamic shared memory of the shared form, for `per` nodes per block:
// fq, unz, alloc (per x R ints each), fp (per ints), taken (per bytes);
// ops/wave_kernel.carry_bytes computes its size.

// Member w's gate, loaded once per scan: its class row's packed mask bits
// and static scores, its exception column (-1 = none), and whether it is a
// real (non-padding) member.
struct Gate {
  const uint8_t* bits;  // (nb,)
  const float* stat;    // (N,)
  int exc;
  bool real;
};

__device__ __forceinline__ Gate gate_of(const WaveArgs& a, const Members& m,
                                        int w) {
  const int row = m.row[w];
  return {a.bits + (size_t)row * a.nb, a.static_sc + (size_t)row * a.N,
          m.exc[w], m.real[w] != 0};
}

// Gated mask at node n: real member, exception column, class row bit.
__device__ __forceinline__ bool gated(const Gate& g, int n) {
  if (!g.real || (g.exc >= 0 && n != g.exc)) return false;
  return (__ldg(g.bits + (n >> 3)) >> (7 - (n & 7))) & 1;
}

// Live score of member w at local node li, over the carry plus `add` (the
// request of an earlier member's debit, or nullptr), from its static score.
__device__ __forceinline__ float score(const WaveArgs& a,
                                       const ScoreParams& p,
                                       const Members& m, const Carry& c,
                                       int w, int li, const int* add,
                                       float st) {
  return ktpu::live_score(p, c.alloc + (size_t)li * a.R,
                          c.unz + (size_t)li * a.R, add, m.rnz + w * a.R, st);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// The cluster's shared-memory exchange: each block publishes one (value,
// index) per barrier into slot[phase & 1], and after the barrier every warp
// of every block reads all CS slots, so no block-wide broadcast follows.
struct Exchange {
  float* wv;      // (kMaxWarps,) per-warp partials
  int* wi;
  float* slot_v;  // (2,) published to the cluster
  int* slot_i;
  unsigned phase;
};

// Argmax over the warp's lanes on (score desc, node id asc); every lane
// gets the result.
__device__ __forceinline__ void warp_allmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Cluster-wide argmax on (score desc, node id asc) of every thread's
// candidate; every thread of every block gets the winner.
__device__ void cluster_argmax(cg::cluster_group& cluster, int cs,
                               Exchange& x, float& v, int& i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int buf = x.phase & 1;
  warp_argmax(v, i);
  if (lane == 0) { x.wv[warp] = v; x.wi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? x.wv[lane] : -INFINITY;
    i = lane < nw ? x.wi[lane] : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) { x.slot_v[buf] = v; x.slot_i[buf] = i; }
  }
  cluster.sync();
  v = lane < cs ? *cluster.map_shared_rank(x.slot_v + buf, lane)
                : -INFINITY;
  i = lane < cs ? *cluster.map_shared_rank(x.slot_i + buf, lane) : INT_MAX;
  warp_allmax(v, i);
  ++x.phase;
}

// Cluster-wide OR of every thread's flag; every thread gets the result.
__device__ bool cluster_any(cg::cluster_group& cluster, int cs, Exchange& x,
                            bool flag) {
  const int lane = threadIdx.x & 31;
  const int buf = x.phase & 1;
  flag = __syncthreads_or(flag);
  if (threadIdx.x == 0) x.slot_i[buf] = flag ? 1 : 0;
  cluster.sync();
  const int f = lane < cs ? *cluster.map_shared_rank(x.slot_i + buf, lane)
                          : 0;
  ++x.phase;
  return __any_sync(0xffffffffu, f != 0);
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
wave_solve_kernel(WaveArgs a) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ ScoreParams p;
  __shared__ int s_req[kMaxW * kMaxR];
  __shared__ int s_rnz[kMaxW * kMaxR];
  __shared__ int s_row[kMaxW];
  __shared__ int s_exc[kMaxW];
  __shared__ int s_real[kMaxW];
  __shared__ float s_b[kMaxW];
  __shared__ int s_y[kMaxW];
  __shared__ float s_wv[kMaxWarps];
  __shared__ int s_wi[kMaxWarps];
  __shared__ float s_slot_v[2];
  __shared__ int s_slot_i[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cs;
  const int rank = (int)cluster.block_rank();
  const int k = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int N = a.N, R = a.R, W = a.W, P = a.P;
  const int lo = min(rank * a.per, N);
  const int hi = min(lo + a.per, N);
  const int L = hi - lo;
  const int* perm = a.perms + (size_t)k * P;

  ktpu::load_score_params(p, tid, a.fit_col_w, a.bal_mask, a.shape_u,
                          a.shape_s, R, a.n_shape, a.strategy, a.w_fit,
                          a.w_bal);
  Carry c;
  if constexpr (kShared) {
    int* base = reinterpret_cast<int*>(s_dyn);
    const size_t slab = (size_t)a.per * R;
    c.fq = base;
    c.unz = base + slab;
    int* alloc = base + 2 * slab;
    c.fp = base + 3 * slab;
    c.taken = reinterpret_cast<uint8_t*>(base + 3 * slab + a.per);
    for (int idx = tid; idx < L * R; idx += T)
      alloc[idx] = a.alloc_q[(size_t)lo * R + idx];
    c.alloc = alloc;
  } else {
    c.fq = a.g_fq + ((size_t)k * N + lo) * R;
    c.unz = a.g_unz + ((size_t)k * N + lo) * R;
    c.fp = a.g_fp + (size_t)k * N + lo;
    c.taken = a.g_taken + (size_t)k * N + lo;
    c.alloc = a.alloc_q + (size_t)lo * R;
  }
  for (int idx = tid; idx < L * R; idx += T) {
    c.fq[idx] = a.free_q0[(size_t)lo * R + idx];
    c.unz[idx] = a.used_nz0[(size_t)lo * R + idx];
  }
  for (int li = tid; li < L; li += T) {
    c.fp[li] = a.free_pods0[lo + li];
    c.taken[li] = 0;
  }
  __syncthreads();

  const Members m{s_req, s_rnz, s_row, s_exc, s_real};
  Exchange x{s_wv, s_wi, s_slot_v, s_slot_i, 0u};

  // The block's best candidate for member w over its slice; `spec` skips
  // nodes an earlier member of the wave took. The static score is loaded
  // before the gate's mask byte, so their L2 latencies overlap.
  auto local_best = [&](int w, bool spec, float& bv, int& bi) {
    bv = -INFINITY;
    bi = N;
    const Gate g = gate_of(a, m, w);
    for (int li = tid; li < L; li += T) {
      const int n = lo + li;
      if (spec && c.taken[li]) continue;
      const float st = __ldg(g.stat + n);
      if (!gated(g, n) || c.fp[li] < 1) continue;
      bool fit = true;
      for (int r = 0; r < R; ++r)
        fit = fit && m.req[w * R + r] <= c.fq[(size_t)li * R + r];
      if (!fit) continue;
      const float v = score(a, p, m, c, w, li, nullptr, st);
      if (v > bv) { bv = v; bi = n; }
    }
  };
  auto debit = [&](int w, int li) {
    for (int r = 0; r < R; ++r) {
      c.fq[(size_t)li * R + r] -= s_req[w * R + r];
      c.unz[(size_t)li * R + r] += s_rnz[w * R + r];
    }
    c.fp[li] -= 1;
  };

  int ncom = 0, nrep = 0, pois = 0;
  const int n_waves = (P + W - 1) / W;
  for (int wave = 0; wave < n_waves; ++wave) {
    const int base = wave * W;
    const int nreal = min(W, P - base);
    for (int w = tid; w < W; w += T) {
      const int i = base + w;
      const bool real = i < P;
      const int pod = real ? perm[i] : 0;
      s_real[w] = real ? 1 : 0;
      s_row[w] = real ? a.rows[pod] : 0;
      s_exc[w] = real ? a.exc[pod] : 0;
    }
    for (int idx = tid; idx < W * R; idx += T) {
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
      float bv;
      int bi;
      local_best(w, true, bv, bi);
      cluster_argmax(cluster, cs, x, bv, bi);
      const int y = bv > -INFINITY ? bi : N;
      if (tid == 0) {
        s_b[w] = bv;
        s_y[w] = y;
      }
      // Only the thread whose stride covers the node reads its byte.
      if (y >= lo && y < hi && (y - lo) % T == tid) c.taken[y - lo] = 1;
    }
    __syncthreads();

    // Pairwise conflicts, on the block that owns each earlier pick's node:
    // does member j's debit leave its node better than member w's pick for
    // pod w?
    bool conflict = false;
    if (W > 1) {
      bool mine = false;
      for (int pair = tid; pair < W * W; pair += T) {
        const int w = pair / W, j = pair - w * W;
        if (j >= w) continue;
        const int yj = s_y[j];
        if (yj < lo || yj >= hi) continue;
        const Gate g = gate_of(a, m, w);
        if (!gated(g, yj)) continue;
        const int li = yj - lo;
        bool cap = true;
        for (int r = 0; r < R; ++r)
          cap = cap && s_req[w * R + r] <=
                           c.fq[(size_t)li * R + r] - s_req[j * R + r];
        if (!cap || c.fp[li] - 1 < 1) continue;
        const float upd =
            score(a, p, m, c, w, li, s_rnz + j * R, __ldg(g.stat + yj));
        const float bw = s_b[w];
        mine = mine || upd > bw || (upd == bw && yj < s_y[w]);
      }
      conflict = cluster_any(cluster, cs, x, mine);
    }

    if (a.poison || !conflict) {
      for (int w = tid; w < W; w += T) {
        const int y = s_y[w];
        if (y >= lo && y < hi) {
          c.taken[y - lo] = 0;
          debit(w, y - lo);
        }
        if (rank == 0 && base + w < P)
          a.assign[(size_t)k * P + base + w] = y < N ? y : -1;
      }
      ncom += nreal;
      pois |= conflict ? 1 : 0;
    } else {
      for (int w = tid; w < W; w += T) {
        const int y = s_y[w];
        if (y >= lo && y < hi) c.taken[y - lo] = 0;
      }
      // Serial replay of the wave against the live carry. The thread that
      // owns the winner's node debits it: only that thread reads the
      // node's carry in the next pick.
      for (int w = 0; w < W; ++w) {
        float bv;
        int bi;
        local_best(w, false, bv, bi);
        cluster_argmax(cluster, cs, x, bv, bi);
        const int y = bv > -INFINITY ? bi : N;
        if (y >= lo && y < hi && (y - lo) % T == tid) debit(w, y - lo);
        if (rank == 0 && tid == 0 && base + w < P)
          a.assign[(size_t)k * P + base + w] = y < N ? y : -1;
      }
      nrep += nreal;
    }
    __syncthreads();
  }
  if (rank == 0 && tid == 0) {
    a.stats[k * 4 + 0] = ncom;
    a.stats[k * 4 + 1] = nrep;
    a.stats[k * 4 + 2] = pois;
    a.stats[k * 4 + 3] = 0;
  }
  // No block leaves while another may still read its slots.
  cluster.sync();
}

// x + 1: one thread per four elements, float4 loads and stores when the
// length is a multiple of 4 and both pointers are 16-byte aligned.
__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int n, int vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    if (i < n / 4) {
      float4 v = reinterpret_cast<const float4*>(x)[i];
      v.x += 1.0f; v.y += 1.0f; v.z += 1.0f; v.w += 1.0f;
      reinterpret_cast<float4*>(out)[i] = v;
    }
    return;
  }
  for (int j = 4 * i; j < min(4 * i + 4, n); ++j) out[j] = x[j] + 1.0f;
}

template <bool kShared>
cudaError_t set_attributes(int cs, size_t smem) {
  // Each form's attributes are raised once to the largest size asked for.
  // The default dynamic limit is 48 KB less the kernel's static shared
  // memory, so any dynamic size is asked for explicitly.
  static bool nonportable = false;
  static size_t smem_set = 0;
  cudaError_t err = cudaSuccess;
  if (cs > 8 && !nonportable) {
    err = cudaFuncSetAttribute(wave_solve_kernel<kShared>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(wave_solve_kernel<kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  return err;
}

template <bool kShared>
int launch(const WaveArgs& a, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = set_attributes<kShared>(a.cs, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.K * a.cs, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // A cluster the card cannot hold fails here, and the wrapper raises.
  err = cudaLaunchKernelEx(&cfg, wave_solve_kernel<kShared>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (n == 0) return 0;
  const int threads = (n + 3) / 4;
  probe_kernel<<<(threads + 255) / 256, 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, out, n, vec);
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
                    int nb, int W, int poison, int cs, int per, int threads,
                    int smem, int shared_form, int* assign, int* stats,
                    int* g_fq, int* g_fp, int* g_unz, uint8_t* g_taken,
                    void* stream) {
  WaveArgs a;
  a.req_q = req_q; a.req_nz_q = req_nz_q; a.rows = rows; a.exc = exc;
  a.perms = perms; a.free_q0 = free_q0; a.free_pods0 = free_pods0;
  a.used_nz0 = used_nz0; a.alloc_q = alloc_q; a.bits = bits;
  a.static_sc = static_sc; a.fit_col_w = fit_col_w; a.bal_mask = bal_mask;
  a.shape_u = shape_u; a.shape_s = shape_s; a.n_shape = n_shape;
  a.w_fit = w_fit; a.w_bal = w_bal; a.strategy = strategy;
  a.K = K; a.P = P; a.N = N; a.R = R; a.nb = nb; a.W = W; a.poison = poison;
  a.cs = cs; a.per = per;
  a.assign = assign; a.stats = stats;
  a.g_fq = g_fq; a.g_fp = g_fp; a.g_unz = g_unz; a.g_taken = g_taken;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return shared_form ? launch<true>(a, threads, (size_t)smem, s)
                     : launch<false>(a, threads, (size_t)smem, s);
}

}  // extern "C"
