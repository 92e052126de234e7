// Arrow pair-HMM mutation scorer for NVIDIA Hopper (sm_90a): dense and
// candidate-sparse.
//
// Replaces the two Pallas TPU kernels of ccs_tpu/ops/hmm_score_pallas.py:
//   _score_kernel  (:151, wrapped by score_all_pallas)    -> ccs_hmm_score_dense
//   _sparse_kernel (:582, wrapped by score_sparse_pallas) -> ccs_hmm_score_sparse
// Both compute, per window, the exact log-likelihood ll0 of the current
// template summed over its live subreads, and the summed log-likelihood of
// single-point mutations by alpha/beta column bridging (the algebra of
// ccs_tpu/ops/hmm_cols.py, which ccs_tpu_torch/ops/hmm_cols.py ports and
// which is the plain version these kernels are held against). The sparse
// entry point bridges only the positions flagged in `cand` (prepends always);
// every slot it does not bridge is exactly 0.
//
// Output layout (absolute, m = 9p + k): lls[b, 9p + k] for k 0..3
// substitute base k at p (the self-substitution slot stays 0), 4 delete p,
// 5..8 insert base k-5 after p; lls[b, 9T + x] prepend base x. Positions
// p >= tlen hold 0. ll0[b] is the sum over live subreads.
//
// What bounds it on the H100: neither bytes nor peak arithmetic. A window
// reads ~1 KB per subread from device memory and does a few MFLOP of
// float32 recurrences over small vectors (S = R+1 = 40 read boundaries, ~30
// template columns), so the time is set by dependent-instruction latency and
// the schedulers' instruction rate. Tensor cores, TMA and clusters do not
// serve it: the work is float32 first-order recurrences on ~1 KB of input
// per subread, and TF32 cannot meet the 2e-3 / 5e-3 bars on sums over 16
// subreads. The card's levers here are warp shuffles, registers, 227 KB of
// shared memory per SM and occupancy. The design:
//   - one CTA per window; subreads are processed in groups of G that fit the
//     shared-memory budget (forward columns + backward sensitivities take
//     (2T+3)*S*4 B per subread, ~15 KB at T=44, R=39);
//   - a column sweep is one warp per (subread, direction), lanes along the
//     read axis, 1, 2 or 4 consecutive cells per lane by the read's own
//     length. A column lives in registers; the neighbour v[i-1] is one
//     __shfl_up_sync; the within-column insertion chain w[i] = y[i] +
//     a[i]*w[i-1] is solved exactly by an inclusive scan of the affine maps
//     (a, y) under composition, five shuffle steps after an in-lane
//     composition. The backward sweep is the forward sweep of the reversed
//     read (so it scans upward too) and stores its pre-solve values. The 2G
//     chains of a group go round-robin over all warps of the CTA;
//   - a column is rescaled by the maximum of the column two before it, so
//     the warp-wide maximum is off the step's critical path; the factor that
//     normalises a stored column to maximum 1 is kept beside it for the
//     bridges (see sweep_chain);
//   - each mutation bridge is one thread's pass over the read axis: the
//     three column operators are streamed together, carrying only scalars.
//     A thread builds the operators of its slot once and uses them for
//     several of the group's reads;
//   - loops run to each window's own tlen, live-read count and read length.
// The sum over subreads is taken in a fixed order (subread index ascending)
// in shared memory, with no atomics, so reruns are bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float TINY = 1e-30f;
constexpr int CTX_W = 9;          // ME[4] | IE[4] | DP per context
constexpr int MAX_GROUP = 32;
constexpr int MAX_R = 127;        // 4 cells per lane at most
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// Launch shape: threads per CTA and the shared-memory budget that sizes a
// read group. 256 threads, 112 KB and at most 128 registers put two CTAs
// (16 warps) on an SM.
constexpr int THREADS = 256;
constexpr int CTAS_PER_SM = 2;
constexpr size_t SMEM_TARGET = 112 * 1024;

struct Dims {
  int T, C, R, n_snr, G, S, SP;
};

struct Op {
  float4 me, ie;
  float dp;
};

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ Op ctx_op(const float* ctx, int prev, int cur) {
  const float* c = ctx + (4 * prev + cur) * CTX_W;
  Op o;
  o.me = make_float4(c[0], c[1], c[2], c[3]);
  o.ie = make_float4(c[4], c[5], c[6], c[7]);
  o.dp = c[8];
  return o;
}

__device__ __forceinline__ Op make_op(float4 me, float4 ie, float dp) {
  Op o;
  o.me = me;
  o.ie = ie;
  o.dp = dp;
  return o;
}

// Original (unmutated) operators of the window's template positions
// j = -1 .. T+1 at index j+1, identity (me = ie = 0, dp = 1) outside [0, tl).
struct OpTable {
  const float4* me;
  const float4* ie;
  const float* dp;
  __device__ __forceinline__ Op at(int j) const {
    return make_op(me[j + 1], ie[j + 1], dp[j + 1]);
  }
};

// Shared-memory carve-up, identical on host (sizing) and device.
struct Layout {
  size_t oh, cols, betas, lsc, lsb, imc, imb, contrib, acc, row, ctx, pw, llr;
  size_t tme, tie, tdp, tplc, pos, live, rlg, cnt, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline Layout make_layout(const Dims& d) {
  const size_t G = d.G, T = d.T, S = d.S, SP = d.SP;
  const size_t nslot = 8 * T + 4;
  Layout L;
  size_t o = 0;
  L.oh = o;      o = align16(o + G * S * 2 * sizeof(float4));   // (ohm, ohi)
  L.cols = o;    o = align16(o + G * (T + 2) * SP * 4);
  L.betas = o;   o = align16(o + G * (T + 1) * SP * 4);
  L.lsc = o;     o = align16(o + G * (T + 2) * 4);
  L.lsb = o;     o = align16(o + G * (T + 1) * 4);
  L.imc = o;     o = align16(o + G * (T + 2) * 4);
  L.imb = o;     o = align16(o + G * (T + 1) * 4);
  L.contrib = o; o = align16(o + G * nslot * 4);
  L.acc = o;     o = align16(o + nslot * 4);
  L.row = o;     o = align16(o + (9 * T + 4) * 4);
  L.ctx = o;     o = align16(o + 16 * CTX_W * 4);
  L.pw = o;      o = align16(o + 8 * 4);
  L.llr = o;     o = align16(o + G * 4);
  L.tme = o;     o = align16(o + (T + 3) * sizeof(float4));
  L.tie = o;     o = align16(o + (T + 3) * sizeof(float4));
  L.tdp = o;     o = align16(o + (T + 3) * 4);
  L.tplc = o;    o = align16(o + T * 4);
  L.pos = o;     o = align16(o + T * 4);
  L.live = o;    o = align16(o + size_t(d.C) * 4);
  L.rlg = o;     o = align16(o + G * 4);
  L.cnt = o;     o = align16(o + 2 * 4);
  L.total = o;
  return L;
}

// All columns of one (subread, direction) chain, by one warp.
//
// Lane l holds the K consecutive cells r = K*l .. K*l+K-1 of the current
// column in registers, with its reads' emission rows. Forward (BWD false),
// cell r is read boundary i = r, step t computes col_t from col_{t-1} with
// the operators (me, dp)[t-1], ie[t] and stores the solved column in
// out[t+1] (out[0] = e_0), as cols[k] = col_{k-1}. Backward, the chain runs
// on the reversed read: cell r is boundary i = rl - r and uses the emission
// of read base i+1, so the start e_rl is again a one at r = 0 and the
// neighbour i+1 is again r-1; step t takes j = tl-1-t, forms the pre-solve
// sensitivity u_j = g*(dp*c + em*c[r-1]) from the full sensitivity c of
// column j+1, stores u_j in out[j] (out[tl] = e_rl), and solves the chain
// to get c for the next step. Cells r > rl hold exact 0 and are not stored.
//
// Per step: v[r-1] of a lane's first cell by one __shfl_up_sync;
// y[r] = g*(dp*v[r] + em[r]*v[r-1]) and a[r] = ei[r] per cell; the chain
// w[r] = y[r] + a[r]*w[r-1] as the inclusive scan of the affine maps (a, y)
// under (a2,y2) o (a1,y1) = (a2*a1, y2 + a2*y1): composed over the lane's K
// cells, scanned across lanes in 5 shuffle steps, then applied in the lane
// to the previous lane's result.
//
// Scaling. Columns are computed and stored unnormalised: the true column k
// is stored[k] * exp(L[k]), and any positive g keeps that exact as long as
// L[k+1] = L[k] - log g. Step t uses g_t = 1 / (g_{t-1} * m_{t-1}), m being
// the maximum of the stored input column of a step; it is known one step
// ahead, so the warp-wide maximum is never waited for. By induction
// exp(L[k+1]) is the true maximum of column k-1: every stored column is the
// true column divided by the true maximum two columns earlier. Its maximum
// is therefore the product of two consecutive per-column ratios rho =
// max(col_k) / max(col_{k-1}), whatever T is: no drift accumulates. A ratio
// is at most (dp + max em) / (1 - max a), below 10 for any table whose
// scaled insertion emission stays under 0.75, and at least the smallest
// deletion or match-times-emission probability of the model, far above
// 1e-10; so a stored maximum lies within [1e-20, 1e2], inside float32 with
// 18 decades to spare on either side, and g within [1e-1, 1e10].
// What a bridge needs is the column normalised to maximum 1 (the plain
// version's form, so that the TINY clamps fall at the same values): im[k] =
// 1 / max(m_k, TINY) turns stored[k] into it and ls[k] is its log-scale.
// Forward, 1/m_t = g_{t+1} * g_t and ls[t] = L[t+2]. The backward chain
// stores pre-solve values, whose maximum it reduces apart. The steps leave
// only the raw g (and backward maxima) in ls/im; the logarithms, their
// running sums and the backward reciprocals are taken after the last step,
// one column per lane, so no step pays for a logf. g itself may be any
// positive number, so its reciprocal is the fast approximate one.
// TINY guards the all-zero column (an impossible read) as before.
// Returns log P(read | template) when forward.
template <int K, bool BWD>
__device__ __forceinline__ float sweep_chain(const float4* __restrict__ oh,
                                             float* __restrict__ out,
                                             float* __restrict__ ls_out,
                                             float* __restrict__ im_out,
                                             const OpTable tab, int tl, int rl,
                                             int SP) {
  const int lane = threadIdx.x & 31;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 m[K], n[K];
  float v[K];
  int off[K];                    // the cell's offset in a stored column, or -1
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = K * lane + k;
    const bool emits = r >= 1 && r <= rl;
    const int src = BWD ? rl - r + 1 : r;
    m[k] = emits ? oh[2 * src] : z4;
    n[k] = emits ? oh[2 * src + 1] : z4;
    v[k] = r == 0 ? 1.f : 0.f;
    off[k] = r <= rl ? (BWD ? rl - r : r) : -1;
  }
  {
    float* col = out + (BWD ? tl : 0) * SP;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (off[k] >= 0) col[off[k]] = v[k];
    if (BWD && lane == 0) {
      ls_out[tl] = 0.f;
      im_out[tl] = 1.f;
    }
  }
  float g = 1.f;
  const int nsteps = BWD ? tl : tl + 1;
  for (int t = 0; t < nsteps; ++t) {
    const int jm = BWD ? tl - 1 - t : t - 1;       // (me, dp) of this step
    const int ji = BWD ? jm : t;                   // ie of this step
    const int jout = BWD ? jm : t + 1;
    const float4 me = tab.me[jm + 1];
    const float4 ie = tab.ie[ji + 1];
    const float dp = tab.dp[jm + 1];
    // maximum of the input column, for the step after this one; values are
    // non-negative, so their bit patterns order as unsigned integers
    float mx = v[0];
#pragma unroll
    for (int k = 1; k < K; ++k) mx = fmaxf(mx, v[k]);
    mx = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(mx)));
    float vl = __shfl_up_sync(FULL, v[K - 1], 1);
    if (lane == 0) vl = 0.f;
    float y[K], a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float vp = k ? v[k - 1] : vl;
      y[k] = g * (dp * v[k] + dot4(m[k], me) * vp);
      a[k] = dot4(n[k], ie);
    }
    float A = a[0], Y = y[0], my = y[0];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      Y = y[k] + a[k] * Y;
      A *= a[k];
      my = fmaxf(my, y[k]);
    }
    if (BWD) my = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(my)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float Au = __shfl_up_sync(FULL, A, d);
      const float Yu = __shfl_up_sync(FULL, Y, d);
      if (lane >= d) {
        Y = Y + A * Yu;
        A *= Au;
      }
    }
    float w = __shfl_up_sync(FULL, Y, 1);          // w of the cell before
    if (lane == 0) w = 0.f;
    float* col = out + jout * SP;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w = y[k] + a[k] * w;
      v[k] = w;
      if (off[k] >= 0) col[off[k]] = BWD ? y[k] : w;
    }
    const float gn = __fdividef(1.f, fmaxf(g * mx, TINY));
    if (lane == 0) {
      if (BWD) {
        ls_out[jout] = g;                          // raw, see below
        im_out[jout] = fmaxf(my, TINY);
      } else {
        ls_out[t] = gn;                            // raw g_{t+1}
        im_out[t] = gn * g;                        // 1 / m_t
      }
    }
    g = gn;
  }
  __syncwarp();
  // Log-scales from the raw factors, one column per lane. Forward:
  // ls[k] = L[k+2] = -sum_{i<=k} log g_{i+1}, k = 0..tl. Backward, in step
  // order t (column j = tl-1-t): L after step t is -sum_{i<=t} log g_i, and
  // ls[j] adds the log of the stored values' maximum.
  float run = 0.f;                                 // L[tl+1] when forward ends
  for (int base = 0; base < nsteps; base += 32) {
    const int t = base + lane;
    const int k = BWD ? tl - 1 - t : t;
    float x = t < nsteps ? -logf(ls_out[k]) : 0.f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float xu = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += xu;
    }
    x += run;
    if (t < nsteps) {
      if (BWD) {
        const float c = im_out[k];
        ls_out[k] = x + logf(c);
        im_out[k] = 1.f / c;
      } else {
        ls_out[k] = x;
      }
    }
    // forward needs L[tl+1] = ls[tl-1], the sum through t = tl-1
    const int last = BWD ? 31 : min(31, tl - 1 - base);
    if (last >= 0) run = __shfl_sync(FULL, x, last);
  }
  if (BWD) return 0.f;
  // the last column's own maximum and scale
  float mf = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mf = fmaxf(mf, v[k]);
  mf = fmaxf(__uint_as_float(__reduce_max_sync(FULL, __float_as_uint(mf))),
             TINY);
  const float imf = 1.f / mf;
  const float lsf = run + logf(mf);
  if (lane == 0) {
    ls_out[tl + 1] = lsf;
    im_out[tl + 1] = imf;
  }
  float x = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (rl % K == k) x = v[k];
  x = __shfl_sync(FULL, x, rl / K);
  return logf(fmaxf(x * imf, TINY)) + lsf;
}

template <bool BWD>
__device__ __forceinline__ float sweep(const float4* oh, float* out,
                                       float* ls_out, float* im_out,
                                       const OpTable tab, int tl, int rl,
                                       int SP) {
  if (rl < 32)
    return sweep_chain<1, BWD>(oh, out, ls_out, im_out, tab, tl, rl, SP);
  if (rl < 64)
    return sweep_chain<2, BWD>(oh, out, ls_out, im_out, tab, tl, rl, SP);
  return sweep_chain<4, BWD>(oh, out, ls_out, im_out, tab, tl, rl, SP);
}

// Mutation slot `u` of a window with `npos` scored positions.
// Slots 0..8*npos-1: position index k = u/8 (p = pos[k]), m = u%8:
// m 0..2 substitute alt base (cur+1+m)%4, 3 delete, 4..7 insert base m-4
// after p. Slots 8*npos..8*npos+3: prepend base u-8*npos.
// Its index in the absolute output layout:
__device__ __forceinline__ int slot_out_idx(int u, int npos, const int* pos,
                                            const int* tplc, int T) {
  if (u >= 8 * npos) return 9 * T + (u - 8 * npos);
  const int p = pos[u >> 3];
  const int m = u & 7;
  if (m == 3) return 9 * p + 4;
  return m < 3 ? 9 * p + ((tplc[p] + 1 + m) & 3) : 9 * p + m + 1;
}

// The three column operators and bridge endpoints of mutation slot `u`:
// the operators map cols[s] to the boundary scored against betas[q].
// Mirrors ccs_tpu_torch/ops/hmm_cols.py mutation_ops_at / prepend_ops.
__device__ void slot_ops(int u, int npos, const int* pos, const int* tplc,
                         const float* ctx, const OpTable tab, int T, int tl,
                         Op& o0, Op& o1, Op& o2, int& s, int& q) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  if (u >= 8 * npos) {
    const int x = u - 8 * npos;
    const int t0 = tplc[0];
    const Op pxx = ctx_op(ctx, x, x);
    const Op px0 = ctx_op(ctx, x, t0);
    const bool h0 = tl > 0;                       // an old base 0 to follow
    o0 = make_op(z, pxx.ie, 1.f);
    o1 = make_op(pxx.me, h0 ? px0.ie : z, pxx.dp);
    o2 = h0 ? make_op(px0.me, tab.ie[1 + 1], px0.dp) : make_op(z, z, 1.f);
    s = 0;
    q = min(1, tl);
    return;
  }
  const int p = pos[u >> 3];
  const int m = u & 7;
  const int cur = tplc[p];
  const int nxt = tplc[min(p + 1, T - 1)];
  const bool hn = (p + 1) < tl;
  q = min(p + 2, tl);
  const float4 ie_p2 = tab.ie[p + 2 + 1];
  if (m == 3) {                                   // delete p
    const Op om1 = tab.at(p - 1);
    const Op D = ctx_op(ctx, p > 0 ? tplc[p - 1] : nxt, nxt);
    o0 = make_op(om1.me, hn ? D.ie : z, om1.dp);
    o1 = make_op(hn ? D.me : z, ie_p2, hn ? D.dp : 1.f);
    o2 = make_op(z, z, 1.f);
    s = p;
    return;
  }
  const int x = (m < 3) ? ((cur + 1 + m) & 3) : (m - 4);
  const Op Bx = ctx_op(ctx, x, nxt);
  o2 = make_op(hn ? Bx.me : z, ie_p2, hn ? Bx.dp : 1.f);
  if (m < 3) {                                    // substitute x at p
    const Op om1 = tab.at(p - 1);
    const Op A = ctx_op(ctx, p > 0 ? tplc[p - 1] : x, x);
    o0 = make_op(om1.me, A.ie, om1.dp);
    o1 = make_op(A.me, hn ? Bx.ie : z, A.dp);
    s = p;
  } else {                                        // insert x after p
    const Op op_ = tab.at(p);
    const Op Cx = ctx_op(ctx, cur, x);
    o0 = make_op(op_.me, Cx.ie, op_.dp);
    o1 = make_op(Cx.me, hn ? Bx.ie : z, Cx.dp);
    s = p + 1;
  }
}

// One bridge: apply the three operators to col_{s-1} (each a forward
// column step with an exact insertion-chain solve), streamed together over
// the read axis, and dot the result with u_q.
__device__ float bridge(const float4* oh, const float* colS, const float* uq,
                        const Op& o0, const Op& o1, const Op& o2, int rl) {
  float vp = 0.f, w1p = 0.f, w2p = 0.f, w3p = 0.f, dot = 0.f;
  for (int i = 0; i <= rl; ++i) {
    const float4 m = oh[2 * i];
    const float4 n = oh[2 * i + 1];
    const float v = colS[i];
    const float w1 = o0.dp * v + dot4(m, o0.me) * vp + dot4(n, o0.ie) * w1p;
    const float w2 = o1.dp * w1 + dot4(m, o1.me) * w1p + dot4(n, o1.ie) * w2p;
    const float w3 = o2.dp * w2 + dot4(m, o2.me) * w2p + dot4(n, o2.ie) * w3p;
    dot += w3 * uq[i];
    vp = v;
    w1p = w1;
    w2p = w2;
    w3p = w3;
  }
  return dot;
}

// In warp `w`: the ascending list of indices k < n with flag(k) set, by
// ballot and popcount; every thread of the CTA calls it, the count is
// written by the warp's first lane.
template <typename F>
__device__ __forceinline__ void warp_compact(int w, int n, int* list,
                                             int* count, F flag) {
  if ((threadIdx.x >> 5) != w) return;
  const int lane = threadIdx.x & 31;
  int total = 0;
  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    const bool f = k < n && flag(k);
    const unsigned mask = __ballot_sync(FULL, f);
    if (f) list[total + __popc(mask & ((1u << lane) - 1u))] = k;
    total += __popc(mask);
  }
  if (lane == 0) *count = total;
}

// Stage a group's reads: pw-scaled one-hot emission rows (row 0 and pads
// are zero) and the reads' lengths.
__device__ __forceinline__ void stage_group(
    const int8_t* __restrict__ reads, const int32_t* __restrict__ rlens,
    const int* live, const float* pwf, float4* oh, int* rlg, int b, int C,
    int R, int S, int lo, int ng) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int k = tid; k < ng * S; k += nthreads) {
    const int g = k / S, i = k - g * S;
    const int c = live[lo + g];
    int base = -1;
    float e = 0.f, f = 0.f;
    if (i > 0) {
      const int code = reads[(size_t(b) * C + c) * R + (i - 1)];
      if (code >= 0) {
        const int cc = min(code, 15);
        base = cc & 3;
        e = pwf[cc >> 2];
        f = pwf[4 + (cc >> 2)];
      }
    }
    oh[(size_t(g) * S + i) * 2] = make_float4(
        base == 0 ? e : 0.f, base == 1 ? e : 0.f, base == 2 ? e : 0.f,
        base == 3 ? e : 0.f);
    oh[(size_t(g) * S + i) * 2 + 1] = make_float4(
        base == 0 ? f : 0.f, base == 1 ? f : 0.f, base == 2 ? f : 0.f,
        base == 3 ? f : 0.f);
  }
  if (tid < ng) rlg[tid] = min(rlens[size_t(b) * C + live[lo + tid]], R);
}

template <bool SPARSE>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
score_kernel(const int8_t* __restrict__ tpl, const int32_t* __restrict__ tlen,
             const int32_t* __restrict__ snr_bin,
             const int8_t* __restrict__ reads,
             const int32_t* __restrict__ rlens,
             const bool* __restrict__ cand,
             const float* __restrict__ ctx_tab,
             const float* __restrict__ pw_tab, float* __restrict__ lls,
             float* __restrict__ ll0, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(d);
  float4* oh = reinterpret_cast<float4*>(smem + L.oh);
  float* cols = reinterpret_cast<float*>(smem + L.cols);
  float* betas = reinterpret_cast<float*>(smem + L.betas);
  float* lsc = reinterpret_cast<float*>(smem + L.lsc);
  float* lsb = reinterpret_cast<float*>(smem + L.lsb);
  float* imc = reinterpret_cast<float*>(smem + L.imc);
  float* imb = reinterpret_cast<float*>(smem + L.imb);
  float* contrib = reinterpret_cast<float*>(smem + L.contrib);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* row = reinterpret_cast<float*>(smem + L.row);
  float* ctx = reinterpret_cast<float*>(smem + L.ctx);
  float* pwf = reinterpret_cast<float*>(smem + L.pw);
  float* llr = reinterpret_cast<float*>(smem + L.llr);
  float4* tme = reinterpret_cast<float4*>(smem + L.tme);
  float4* tie = reinterpret_cast<float4*>(smem + L.tie);
  float* tdp = reinterpret_cast<float*>(smem + L.tdp);
  int* tplc = reinterpret_cast<int*>(smem + L.tplc);
  int* pos = reinterpret_cast<int*>(smem + L.pos);
  int* live = reinterpret_cast<int*>(smem + L.live);
  int* rlg = reinterpret_cast<int*>(smem + L.rlg);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, nwarps = nthreads >> 5;
  const int T = d.T, C = d.C, R = d.R, S = d.S, SP = d.SP;
  const int NSLOT = 8 * T + 4;
  const int NOUT = 9 * T + 4;
  const int tl = min(max(tlen[b], 0), T);
  const int sb = min(max(snr_bin[b], 0), d.n_snr - 1);

  for (int k = tid; k < 16 * CTX_W; k += nthreads)
    ctx[k] = ctx_tab[sb * 16 * CTX_W + k];
  if (tid < 8) pwf[tid] = pw_tab[sb * 8 + tid];
  for (int j = tid; j < T; j += nthreads)
    tplc[j] = min(max(int(tpl[size_t(b) * T + j]), 0), 3);
  for (int k = tid; k < NSLOT; k += nthreads) acc[k] = 0.f;
  for (int k = tid; k < NOUT; k += nthreads) row[k] = 0.f;
  // scored positions and live subreads, each list by one warp
  warp_compact(0, tl, pos, &cnt[0], [&](int p) {
    return !SPARSE || cand[size_t(b) * T + p];
  });
  warp_compact(nwarps > 1 ? 1 : 0, C, live, &cnt[1], [&](int c) {
    return rlens[size_t(b) * C + c] >= 0;
  });
  __syncthreads();
  const int npos = cnt[0];
  const int nlive = cnt[1];
  const int nslot = 8 * npos + 4;
  const int ngroups = (nlive + d.G - 1) / d.G;
  const OpTable tab = {tme, tie, tdp};
  float ll_sum = 0.f;                                  // thread 0 only

  // the window's original operators, identity-padded
  for (int k = tid; k < T + 3; k += nthreads) {
    const int j = k - 1;
    Op o = make_op(make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f), 1.f);
    if (j >= 0 && j < tl) o = ctx_op(ctx, j > 0 ? tplc[j - 1] : tplc[j], tplc[j]);
    tme[k] = o.me;
    tie[k] = o.ie;
    tdp[k] = o.dp;
  }
  if (ngroups > 0)
    stage_group(reads, rlens, live, pwf, oh, rlg, b, C, R, S, 0,
                nlive / ngroups);
  __syncthreads();

  for (int grp = 0; grp < ngroups; ++grp) {
    const int lo = grp * nlive / ngroups;
    const int ng = (grp + 1) * nlive / ngroups - lo;

    // ---- column sweeps: one warp per (read, direction), round-robin ----
    for (int c = warp; c < 2 * ng; c += nwarps) {
      const int g = c >> 1;
      const float4* ohg = oh + size_t(g) * S * 2;
      if (c & 1) {
        sweep<true>(ohg, betas + size_t(g) * (T + 1) * SP,
                    lsb + size_t(g) * (T + 1), imb + size_t(g) * (T + 1), tab,
                    tl, rlg[g], SP);
      } else {
        const float ll = sweep<false>(ohg, cols + size_t(g) * (T + 2) * SP,
                                      lsc + size_t(g) * (T + 2),
                                      imc + size_t(g) * (T + 2), tab, tl,
                                      rlg[g], SP);
        if ((tid & 31) == 0) llr[g] = ll;
      }
    }
    __syncthreads();

    // ---- bridges: a thread takes one slot and every H-th read ----
    const int H = min(ng, max(1, nthreads / nslot));
    for (int task = tid; task < nslot * H; task += nthreads) {
      const int h = task / nslot;
      const int u = task - h * nslot;
      Op o0, o1, o2;
      int s, q;
      slot_ops(u, npos, pos, tplc, ctx, tab, T, tl, o0, o1, o2, s, q);
      for (int g = h; g < ng; g += H) {
        const size_t cs = size_t(g) * (T + 2) + s, bq = size_t(g) * (T + 1) + q;
        const float dot = bridge(oh + size_t(g) * S * 2, cols + cs * SP,
                                 betas + bq * SP, o0, o1, o2, rlg[g])
            * imc[cs] * imb[bq];
        contrib[size_t(g) * NSLOT + u] =
            logf(fmaxf(dot, TINY)) + lsc[cs] + lsb[bq];
      }
    }
    __syncthreads();

    // ---- fixed-order sum over the group's reads; stage the next group ----
    for (int u = tid; u < nslot; u += nthreads) {
      float a = acc[u];
      for (int g = 0; g < ng; ++g) a += contrib[size_t(g) * NSLOT + u];
      acc[u] = a;
    }
    if (tid == 0)
      for (int g = 0; g < ng; ++g) ll_sum += llr[g];
    if (grp + 1 < ngroups) {
      const int lo2 = (grp + 1) * nlive / ngroups;
      stage_group(reads, rlens, live, pwf, oh, rlg, b, C, R, S, lo2,
                  (grp + 2) * nlive / ngroups - lo2);
    }
    __syncthreads();
  }

  // ---- scatter slots to the absolute layout, write the row ----
  for (int u = tid; u < nslot; u += nthreads)
    row[slot_out_idx(u, npos, pos, tplc, T)] = acc[u];
  __syncthreads();
  for (int k = tid; k < NOUT; k += nthreads) lls[size_t(b) * NOUT + k] = row[k];
  if (tid == 0) ll0[b] = ll_sum;
}

// Dimensions of a launch, with the largest read group G that fits the
// per-CTA shared-memory target (at least one read).
Dims make_dims(int T, int C, int R, int n_snr) {
  Dims d;
  d.T = T;
  d.C = C;
  d.R = R;
  d.n_snr = n_snr;
  d.S = R + 1;
  d.SP = d.S | 1;           // odd column stride: no bank conflicts across columns
  int G = C < MAX_GROUP ? C : MAX_GROUP;
  for (; G > 1; --G) {
    d.G = G;
    if (make_layout(d).total <= SMEM_TARGET) break;
  }
  d.G = G;
  return d;
}

template <bool SPARSE>
cudaError_t prepare(const Dims& d, size_t* smem) {
  *smem = make_layout(d).total;
  if (*smem > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(score_kernel<SPARSE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(*smem));
}

template <bool SPARSE>
int launch(const void* tpl, const void* tlen, const void* snr_bin,
           const void* reads, const void* rlens, const void* cand,
           const void* ctx_tab, const void* pw_tab, void* lls, void* ll0,
           int B, int T, int C, int R, int n_snr, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || C <= 0 || R <= 0 || R > MAX_R || n_snr <= 0)
    return int(cudaErrorInvalidValue);
  const Dims d = make_dims(T, C, R, n_snr);
  size_t smem;
  const cudaError_t err = prepare<SPARSE>(d, &smem);
  if (err != cudaSuccess) return int(err);
  score_kernel<SPARSE><<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tpl), static_cast<const int32_t*>(tlen),
      static_cast<const int32_t*>(snr_bin), static_cast<const int8_t*>(reads),
      static_cast<const int32_t*>(rlens), static_cast<const bool*>(cand),
      static_cast<const float*>(ctx_tab), static_cast<const float*>(pw_tab),
      static_cast<float*>(lls), static_cast<float*>(ll0), d);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int ccs_hmm_score_dense(const void* tpl, const void* tlen, const void* snr_bin,
                        const void* reads, const void* rlens,
                        const void* ctx_tab, const void* pw_tab, void* lls,
                        void* ll0, int B, int T, int C, int R, int n_snr,
                        void* stream) {
  return launch<false>(tpl, tlen, snr_bin, reads, rlens, nullptr, ctx_tab,
                       pw_tab, lls, ll0, B, T, C, R, n_snr, stream);
}

int ccs_hmm_score_sparse(const void* tpl, const void* tlen,
                         const void* snr_bin, const void* reads,
                         const void* rlens, const void* cand,
                         const void* ctx_tab, const void* pw_tab, void* lls,
                         void* ll0, int B, int T, int C, int R, int n_snr,
                         void* stream) {
  return launch<true>(tpl, tlen, snr_bin, reads, rlens, cand, ctx_tab, pw_tab,
                      lls, ll0, B, T, C, R, n_snr, stream);
}

// What a launch at these caps would use: reads per group, dynamic shared
// memory per CTA, threads per CTA, and how many CTAs fit on an SM.
int ccs_hmm_launch_shape(int T, int C, int R, int* group, int* smem_bytes,
                         int* threads, int* ctas_per_sm) {
  const Dims d = make_dims(T, C, R, 1);
  size_t smem;
  cudaError_t err = prepare<true>(d, &smem);
  if (err != cudaSuccess) return int(err);
  *group = d.G;
  *smem_bytes = int(smem);
  *threads = THREADS;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, score_kernel<true>, THREADS, smem);
  return int(err);
}

// Text of a cudaError_t code returned by any entry point of the library.
const char* ccs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
