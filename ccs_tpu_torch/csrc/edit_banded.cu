// Batched banded global edit distance for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _edit_kernel of ccs_tpu/ops/align_pallas.py
// (:70, wrapped by edit_distance_banded) -> ccs_edit_distance_banded.
// For each of B (read, template) pairs it computes the unit-cost
// (substitution 1, gap 1) global edit distance restricted to the band
// |j - i| <= W around the main diagonal, i the read position and j the
// template position. The state of read row i is E[k], k = j - i + W in
// [0, 2W]:
//   u[k]    = min(E[i-1][k] + sub(read[i-1], tpl[j-1]),  E[i-1][k+1] + 1)
//   E[i][k] = min over k' <= k of (u[k'] + (k - k'))      (deletion chain)
// with every cell whose j lies outside [0, tlen] held at BIG, a pad code
// (< 0) matching nothing, and the answer read at k_end = tlen - rlen + W,
// BIG where k_end falls outside the band. ccs_tpu_torch/ops/align_banded.py
// holds the plain PyTorch version the kernel is compared with.
//
// What bounds it on the H100: operations, not bytes. A pair moves about
// tlen + rlen bytes once and does rlen * (2W+1) cell updates of ~8 integer
// operations each (none where |tlen - rlen| > W), and the rows are a serial
// recurrence, so the kernel is bound by the integer instruction rate and
// the latency of one row. The design:
//   - one warp per pair, WARPS warps per CTA; no shared memory, no atomics,
//     so reruns are bit-identical;
//   - each lane keeps P consecutive diagonals of the row in registers
//     (32*P >= 2W+1; P = 5 at W = 64); slots past 2W stay at BIG;
//   - E[i-1][k+1] of a lane's last slot comes from the next lane
//     (__shfl_down_sync);
//   - the deletion chain is a prefix-min in the space x[k] = u[k] - k:
//     serial inside the lane's run, a warp scan (__shfl_up_sync) across
//     lanes. min is idempotent, so the scan is exact;
//   - the template window slides by one base per row: every lane hands its
//     first base to the lane below and the top lane takes one new base, so
//     a row costs no memory access. Read and template bases are fetched 32
//     rows at a time, one per lane, one block ahead of their use, and
//     broadcast with one shuffle per row;
//   - the row loop runs to the pair's own rlen, and a pair whose lengths
//     differ by more than W is BIG from its lengths alone: its warp writes
//     that and leaves before the first row;
//   - integer arithmetic throughout (every in-band value is below 2^24, so
//     the float32 result is exact).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BIG = 10000000;       // "left the band"; 1e7 as the float result
constexpr int INF = 2 * BIG;        // identity of the prefix-min scan
constexpr int WARPS = 4;            // pairs per CTA
constexpr int MAX_P = 8;            // diagonals per lane: band <= 127
constexpr unsigned FULL = 0xffffffffu;

// Base at `idx` of a sequence of length n (pad code -1 outside), as the low
// byte of the packed (read | template << 8) word.
__device__ __forceinline__ unsigned base_at(const int8_t* seq, int idx, int n) {
  return (idx >= 0 && idx < n) ? (unsigned(uint8_t(seq[idx]))) : 0xffu;
}

template <int P>
__global__ void __launch_bounds__(WARPS * 32)
edit_kernel(const int8_t* __restrict__ tpl, const int32_t* __restrict__ tlen,
            const int8_t* __restrict__ reads, const int32_t* __restrict__ rlens,
            float* __restrict__ dist, int B, int TMAX, int RMAX, int W) {
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= B) return;                       // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int8_t* t_seq = tpl + size_t(pair) * TMAX;
  const int8_t* r_seq = reads + size_t(pair) * RMAX;
  const int tl = tlen[pair];
  const int rl = rlens[pair];
  const int tn = tl < TMAX ? tl : TMAX;        // bases that may be loaded
  const int rn = rl < RMAX ? rl : RMAX;
  const int KB = 2 * W + 1;
  const int k_end = tl - rl + W;               // where the distance is read
  if (k_end < 0 || k_end >= KB) {              // whole warp leaves together
    if (lane == 0) dist[pair] = float(BIG);
    return;
  }
  const int k0 = lane * P;                     // this lane's first diagonal

  // row 0: all-deletions to j = k - W; template window of row 1, whose
  // slot k faces template index j - 1 = k - W
  int e[P];
  int tb[P];
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const int k = k0 + c;
    const int j = k - W;
    e[c] = (k < KB && j >= 0 && j <= tl) ? j : BIG;
    tb[c] = int(int8_t(base_at(t_seq, j, tn)));
  }

  // The base entering the top slot (k = 32P - 1) for row i + 1 is template
  // index i + 32P - 1 - W; with r = i - 1 that is q0 + r, in phase with the
  // read index r. One lane fetches one r of a block of 32.
  const int q0 = 32 * P - W;
  unsigned nxt = base_at(r_seq, lane, rn) | (base_at(t_seq, q0 + lane, tn) << 8);

  for (int r0 = 0; r0 < rl; r0 += 32) {
    const unsigned cur = nxt;
    nxt = base_at(r_seq, r0 + 32 + lane, rn) |
          (base_at(t_seq, q0 + r0 + 32 + lane, tn) << 8);
    const int steps = (rl - r0) < 32 ? (rl - r0) : 32;
    for (int s = 0; s < steps; ++s) {
      const int i = r0 + s + 1;                // read row
      const unsigned word = __shfl_sync(FULL, cur, s);
      const int rb = int(int8_t(word & 0xffu));
      const int t_in = int(int8_t(word >> 8));

      int e_next = __shfl_down_sync(FULL, e[0], 1);
      if (lane == 31) e_next = BIG;
      int t_next = __shfl_down_sync(FULL, tb[0], 1);
      if (lane == 31) t_next = t_in;

      // u in the offset space x = u - k, with the lane's serial prefix-min
      int x[P];
      bool in_tpl[P];
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const int k = k0 + c;
        const int j = i + k - W;
        in_tpl[c] = (k < KB) && (j >= 0) && (j <= tl);
        const bool match = (tb[c] == rb) && (tb[c] >= 0);
        const int diag = e[c] + (match ? 0 : 1);
        const int up = ((c + 1 < P) ? e[c + 1] : e_next) + 1;
        const int u = in_tpl[c] ? min(diag, up) : BIG;
        x[c] = u - k;
        if (c > 0) x[c] = min(x[c], x[c - 1]);
      }
      // inclusive warp scan of the lanes' totals, then the exclusive prefix
      int v = x[P - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v = min(v, o);
      }
      int below = __shfl_up_sync(FULL, v, 1);
      if (lane == 0) below = INF;
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const int k = k0 + c;
        e[c] = in_tpl[c] ? (min(x[c], below) + k) : BIG;
        tb[c] = (c + 1 < P) ? tb[c + 1] : t_next;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < P; ++c)
    if (k0 + c == k_end) dist[pair] = float(e[c]);
}

template <int P>
int launch(const void* tpl, const void* tlen, const void* reads,
           const void* rlens, void* dist, int B, int TMAX, int RMAX, int W,
           void* stream) {
  const int ctas = (B + WARPS - 1) / WARPS;
  edit_kernel<P><<<ctas, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tpl), static_cast<const int32_t*>(tlen),
      static_cast<const int8_t*>(reads), static_cast<const int32_t*>(rlens),
      static_cast<float*>(dist), B, TMAX, RMAX, W);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest band the kernel supports (32 * MAX_P >= 2 * band + 1).
int ccs_edit_max_band() { return (32 * MAX_P - 1) / 2; }

// dist[B] f32 from tpl [B, TMAX] i8, tlen [B] i32, reads [B, RMAX] i8,
// rlens [B] i32 (tlen <= TMAX, rlens <= RMAX). Returns a cudaError_t code;
// a band outside [0, ccs_edit_max_band()] is cudaErrorInvalidValue.
int ccs_edit_distance_banded(const void* tpl, const void* tlen,
                             const void* reads, const void* rlens, void* dist,
                             int B, int TMAX, int RMAX, int band,
                             void* stream) {
  if (B <= 0) return 0;
  if (TMAX <= 0 || RMAX <= 0 || band < 0 || band > ccs_edit_max_band())
    return int(cudaErrorInvalidValue);
  const int P = (2 * band + 1 + 31) / 32;      // diagonals per lane
  switch (P) {
#define CCS_EDIT_CASE(N)                                                     \
  case N:                                                                    \
    return launch<N>(tpl, tlen, reads, rlens, dist, B, TMAX, RMAX, band,     \
                     stream);
    CCS_EDIT_CASE(1) CCS_EDIT_CASE(2) CCS_EDIT_CASE(3) CCS_EDIT_CASE(4)
    CCS_EDIT_CASE(5) CCS_EDIT_CASE(6) CCS_EDIT_CASE(7) CCS_EDIT_CASE(8)
#undef CCS_EDIT_CASE
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
