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
// What bounds it on the H100: the column sweeps are serial recurrences over
// small vectors (S = R+1 = 40 read boundaries, ~30 template columns), so the
// kernel is latency- and issue-bound, not FLOP- or byte-bound: per window it
// reads ~1 KB per subread from device memory and does ~5 MFLOP of dependent
// scalar arithmetic. The design keeps everything a window needs in shared
// memory and turns the work into many independent serial chains:
//   - one CTA per window; subreads are processed in groups of G that fit the
//     shared-memory budget (forward columns + backward sensitivities take
//     (2T+3)*S*4 B per subread, ~15 KB at T=44, R=39);
//   - the forward and backward sweeps of the G subreads run as 2G
//     independent single-thread chains (warp 0 forward, warp 1 backward),
//     each solving the within-column insertion chain w[i] = y[i] +
//     a[i]*w[i-1] exactly and sequentially (no truncated doubling);
//   - each mutation bridge is its own thread: the three column operators are
//     streamed together over the read axis, carrying only scalars, so a
//     bridge is one pass of R+1 steps with no intermediate vectors;
//   - loops run to each window's own tlen, live-read count and read length.
// The sum over subreads is taken in a fixed order (subread index ascending)
// in shared memory, with no atomics, so reruns are bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float TINY = 1e-30f;
constexpr int NTHREADS = 256;
constexpr int CTX_W = 9;          // ME[4] | IE[4] | DP per context
constexpr int MAX_GROUP = 32;     // one lane per subread in a sweep warp
constexpr size_t SMEM_TARGET = 112 * 1024;   // two CTAs per SM
constexpr size_t SMEM_MAX = 227 * 1024;

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

// Original (unmutated) operator of template position j, identity-padded
// outside [0, tl): me = ie = 0, dp = 1.
__device__ __forceinline__ Op orig_op(const float* ctx, const int* tplc,
                                      int j, int tl) {
  if (j < 0 || j >= tl) {
    Op o;
    o.me = make_float4(0.f, 0.f, 0.f, 0.f);
    o.ie = o.me;
    o.dp = 1.f;
    return o;
  }
  return ctx_op(ctx, j > 0 ? tplc[j - 1] : tplc[j], tplc[j]);
}

__device__ __forceinline__ Op make_op(float4 me, float4 ie, float dp) {
  Op o;
  o.me = me;
  o.ie = ie;
  o.dp = dp;
  return o;
}

// Shared-memory carve-up, identical on host (sizing) and device.
struct Layout {
  size_t oh, cols, betas, carry, lsc, lsb, contrib, acc, row, ctx, pw, llr;
  size_t tplc, pos, live, rlg, cnt, total;
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
  L.carry = o;   o = align16(o + G * SP * 4);                   // bwd carry
  L.lsc = o;     o = align16(o + G * (T + 2) * 4);
  L.lsb = o;     o = align16(o + G * (T + 1) * 4);
  L.contrib = o; o = align16(o + G * nslot * 4);
  L.acc = o;     o = align16(o + nslot * 4);
  L.row = o;     o = align16(o + (9 * T + 4) * 4);
  L.ctx = o;     o = align16(o + 16 * CTX_W * 4);
  L.pw = o;      o = align16(o + 8 * 4);
  L.llr = o;     o = align16(o + G * 4);
  L.tplc = o;    o = align16(o + T * 4);
  L.pos = o;     o = align16(o + T * 4);
  L.live = o;    o = align16(o + size_t(d.C) * 4);
  L.rlg = o;     o = align16(o + G * 4);
  L.cnt = o;     o = align16(o + 2 * 4);
  L.total = o;
  return L;
}

// Forward columns of one subread. cols[k] holds col_{k-1} (cols[0] = e_0)
// UNNORMALISED: each column is computed from its predecessor scaled to
// max 1, and that 1/max is folded into the next column's step instead of a
// separate pass. lsc[k] is the log-scale of the normalised predecessor
// chain, so log(x . cols[k]) + lsc[k] is exact for any linear functional x.
// Returns log P(read | template).
__device__ float forward_read(const float4* oh, float* cols, float* lsc,
                              const float* ctx, const int* tplc, int tl,
                              int rl, int SP) {
  cols[0] = 1.f;
  for (int i = 1; i <= rl; ++i) cols[i] = 0.f;
  lsc[0] = 0.f;
  float ls = 0.f, inv = 1.f;
  const float* prev = cols;
  for (int j = 0; j <= tl; ++j) {
    // boundary j uses dp[j-1], me[j-1] (identity at j = 0) and ie[j]
    // (0 at j = tl: no insertions past the end)
    float4 me = make_float4(0.f, 0.f, 0.f, 0.f), ie = me;
    float dpj = 1.f;
    if (j > 0) {
      const Op o = orig_op(ctx, tplc, j - 1, tl);
      me = o.me;
      dpj = o.dp;
    }
    if (j < tl) ie = orig_op(ctx, tplc, j, tl).ie;
    float* cur = cols + (j + 1) * SP;
    float vprev = 0.f, wprev = 0.f, mx = 0.f;
#pragma unroll 4
    for (int i = 0; i <= rl; ++i) {
      const float v = prev[i];
      const float em = dot4(oh[2 * i], me);
      const float ei = dot4(oh[2 * i + 1], ie);
      const float w = inv * (dpj * v + em * vprev) + ei * wprev;
      cur[i] = w;
      mx = fmaxf(mx, w);
      vprev = v;
      wprev = w;
    }
    const float s = fmaxf(mx, TINY);
    lsc[j + 1] = ls;
    ls += logf(s);
    inv = 1.f / s;
    prev = cur;
  }
  return logf(fmaxf(prev[rl] * inv, TINY)) + ls;
}

// Backward pre-solve sensitivities of one subread: betas[j] = u_j for
// j = 0..tl (u_tl = e_rl), each computed from the normalised full
// sensitivity beta_{j+1}; lsb[j] is that beta's log-scale. `carry` holds
// beta_{j+1} unnormalised between steps (its 1/max is folded in, as in
// the forward sweep). One descending pass per column forms u_j and solves
// the insertion chain w[i] = u[i] + a[i]*w[i+1] exactly.
__device__ void backward_read(const float4* oh, float* betas, float* lsb,
                              float* carry, const float* ctx, const int* tplc,
                              int tl, int rl, int SP) {
  float* ut = betas + tl * SP;
  for (int i = 0; i <= rl; ++i) {
    ut[i] = (i == rl) ? 1.f : 0.f;
    carry[i] = ut[i];
  }
  lsb[tl] = 0.f;
  float ls = 0.f, inv = 1.f;
  for (int j = tl - 1; j >= 0; --j) {
    const Op o = orig_op(ctx, tplc, j, tl);
    float* u = betas + j * SP;
    // i = rl: no read base past the end
    float cnext = carry[rl];
    float wnext = inv * o.dp * cnext;
    u[rl] = wnext;
    carry[rl] = wnext;
    float mx = wnext;
#pragma unroll 4
    for (int i = rl - 1; i >= 0; --i) {
      const float c = carry[i];
      // emission of read base i+1
      const float em = dot4(oh[2 * (i + 1)], o.me);
      const float a = dot4(oh[2 * (i + 1) + 1], o.ie);
      const float ui = inv * (o.dp * c + em * cnext);
      u[i] = ui;
      const float w = ui + a * wnext;
      carry[i] = w;
      mx = fmaxf(mx, w);
      cnext = c;
      wnext = w;
    }
    lsb[j] = ls;
    const float s = fmaxf(mx, TINY);
    ls += logf(s);
    inv = 1.f / s;
  }
}

// The three column operators and bridge endpoints of mutation slot `u`.
// Slots 0..8*npos-1: position index k = u/8 (p = pos[k]), m = u%8:
// m 0..2 substitute alt base (cur+1+m)%4, 3 delete, 4..7 insert base m-4
// after p. Slots 8*npos..8*npos+3: prepend base u-8*npos.
// Mirrors ccs_tpu_torch/ops/hmm_cols.py mutation_ops_at / prepend_ops.
__device__ void slot_ops(int u, int npos, const int* pos, const int* tplc,
                         const float* ctx, int T, int tl, Op& o0, Op& o1,
                         Op& o2, int& s, int& q, int& out_idx) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  if (u >= 8 * npos) {
    const int x = u - 8 * npos;
    const int t0 = tplc[0];
    const Op pxx = ctx_op(ctx, x, x);
    const Op px0 = ctx_op(ctx, x, t0);
    o0 = make_op(z, pxx.ie, 1.f);
    o1 = make_op(pxx.me, px0.ie, pxx.dp);
    o2 = make_op(px0.me, orig_op(ctx, tplc, 1, tl).ie, px0.dp);
    s = 0;
    q = min(1, tl);
    out_idx = 9 * T + x;
    return;
  }
  const int p = pos[u >> 3];
  const int m = u & 7;
  const int cur = tplc[p];
  const int nxt = tplc[min(p + 1, T - 1)];
  const bool hn = (p + 1) < tl;
  q = min(p + 2, tl);
  const float4 ie_p2 = orig_op(ctx, tplc, p + 2, tl).ie;
  if (m == 3) {                                   // delete p
    const Op om1 = orig_op(ctx, tplc, p - 1, tl);
    const Op D = ctx_op(ctx, p > 0 ? tplc[p - 1] : nxt, nxt);
    o0 = make_op(om1.me, hn ? D.ie : z, om1.dp);
    o1 = make_op(hn ? D.me : z, ie_p2, hn ? D.dp : 1.f);
    o2 = make_op(z, z, 1.f);
    s = p;
    out_idx = 9 * p + 4;
    return;
  }
  const int x = (m < 3) ? ((cur + 1 + m) & 3) : (m - 4);
  const Op Bx = ctx_op(ctx, x, nxt);
  o2 = make_op(hn ? Bx.me : z, ie_p2, hn ? Bx.dp : 1.f);
  if (m < 3) {                                    // substitute x at p
    const Op om1 = orig_op(ctx, tplc, p - 1, tl);
    const Op A = ctx_op(ctx, p > 0 ? tplc[p - 1] : x, x);
    o0 = make_op(om1.me, A.ie, om1.dp);
    o1 = make_op(A.me, hn ? Bx.ie : z, A.dp);
    s = p;
    out_idx = 9 * p + x;
  } else {                                        // insert x after p
    const Op op_ = orig_op(ctx, tplc, p, tl);
    const Op Cx = ctx_op(ctx, cur, x);
    o0 = make_op(op_.me, Cx.ie, op_.dp);
    o1 = make_op(Cx.me, hn ? Bx.ie : z, Cx.dp);
    s = p + 1;
    out_idx = 9 * p + 5 + x;
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

template <bool SPARSE>
__global__ void __launch_bounds__(NTHREADS, 2)
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
  float* carry = reinterpret_cast<float*>(smem + L.carry);
  float* lsc = reinterpret_cast<float*>(smem + L.lsc);
  float* lsb = reinterpret_cast<float*>(smem + L.lsb);
  float* contrib = reinterpret_cast<float*>(smem + L.contrib);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* row = reinterpret_cast<float*>(smem + L.row);
  float* ctx = reinterpret_cast<float*>(smem + L.ctx);
  float* pwf = reinterpret_cast<float*>(smem + L.pw);
  float* llr = reinterpret_cast<float*>(smem + L.llr);
  int* tplc = reinterpret_cast<int*>(smem + L.tplc);
  int* pos = reinterpret_cast<int*>(smem + L.pos);
  int* live = reinterpret_cast<int*>(smem + L.live);
  int* rlg = reinterpret_cast<int*>(smem + L.rlg);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = d.T, C = d.C, R = d.R, S = d.S, SP = d.SP;
  const int NSLOT = 8 * T + 4;
  const int NOUT = 9 * T + 4;
  const int tl = min(max(tlen[b], 0), T);
  const int sb = min(max(snr_bin[b], 0), d.n_snr - 1);

  for (int k = tid; k < 16 * CTX_W; k += NTHREADS)
    ctx[k] = ctx_tab[sb * 16 * CTX_W + k];
  if (tid < 8) pwf[tid] = pw_tab[sb * 8 + tid];
  for (int j = tid; j < T; j += NTHREADS)
    tplc[j] = min(max(int(tpl[size_t(b) * T + j]), 0), 3);
  for (int k = tid; k < NSLOT; k += NTHREADS) acc[k] = 0.f;
  for (int k = tid; k < NOUT; k += NTHREADS) row[k] = 0.f;
  if (tid == 0) {
    int np = 0;
    for (int p = 0; p < tl; ++p)
      if (!SPARSE || cand[size_t(b) * T + p]) pos[np++] = p;
    int nl = 0;
    for (int c = 0; c < C; ++c)
      if (rlens[size_t(b) * C + c] >= 0) live[nl++] = c;
    cnt[0] = np;
    cnt[1] = nl;
  }
  __syncthreads();
  const int npos = cnt[0];
  const int nlive = cnt[1];
  const int nslot = 8 * npos + 4;
  float ll_sum = 0.f;                                  // thread 0 only

  const int ngroups = (nlive + d.G - 1) / d.G;
  for (int grp = 0; grp < ngroups; ++grp) {
    const int lo = grp * nlive / ngroups;
    const int ng = (grp + 1) * nlive / ngroups - lo;
    // ---- stage the group's reads: pw-scaled one-hot emission rows ----
    for (int k = tid; k < ng * S; k += NTHREADS) {
      const int g = k / S, i = k - (k / S) * S;
      const int c = live[lo + g];
      float e[4] = {0.f, 0.f, 0.f, 0.f}, f[4] = {0.f, 0.f, 0.f, 0.f};
      if (i > 0) {
        const int code = reads[(size_t(b) * C + c) * R + (i - 1)];
        if (code >= 0) {
          const int cc = min(code, 15);
          const int base = cc & 3, w = cc >> 2;
          e[base] = pwf[w];
          f[base] = pwf[4 + w];
        }
      }
      oh[(size_t(g) * S + i) * 2] = make_float4(e[0], e[1], e[2], e[3]);
      oh[(size_t(g) * S + i) * 2 + 1] = make_float4(f[0], f[1], f[2], f[3]);
    }
    if (tid < ng) rlg[tid] = min(rlens[size_t(b) * C + live[lo + tid]], R);
    __syncthreads();

    // ---- column sweeps: warp 0 forward, warp 1 backward, lane = read ----
    if (tid < ng) {
      const int g = tid;
      llr[g] = forward_read(oh + size_t(g) * S * 2,
                            cols + size_t(g) * (T + 2) * SP,
                            lsc + size_t(g) * (T + 2), ctx, tplc, tl, rlg[g],
                            SP);
    } else if (tid >= 32 && tid - 32 < ng) {
      const int g = tid - 32;
      backward_read(oh + size_t(g) * S * 2, betas + size_t(g) * (T + 1) * SP,
                    lsb + size_t(g) * (T + 1), carry + size_t(g) * SP, ctx,
                    tplc, tl, rlg[g], SP);
    }
    __syncthreads();

    // ---- bridges: one thread per (read, mutation slot) ----
    for (int task = tid; task < ng * nslot; task += NTHREADS) {
      const int g = task / nslot;
      const int u = task - g * nslot;
      Op o0, o1, o2;
      int s, q, out_idx;
      slot_ops(u, npos, pos, tplc, ctx, T, tl, o0, o1, o2, s, q, out_idx);
      const float dot = bridge(oh + size_t(g) * S * 2,
                               cols + (size_t(g) * (T + 2) + s) * SP,
                               betas + (size_t(g) * (T + 1) + q) * SP,
                               o0, o1, o2, rlg[g]);
      contrib[size_t(g) * NSLOT + u] = logf(fmaxf(dot, TINY))
          + lsc[size_t(g) * (T + 2) + s] + lsb[size_t(g) * (T + 1) + q];
    }
    __syncthreads();

    // ---- fixed-order sum over the group's reads ----
    for (int u = tid; u < nslot; u += NTHREADS) {
      float a = acc[u];
      for (int g = 0; g < ng; ++g) a += contrib[size_t(g) * NSLOT + u];
      acc[u] = a;
    }
    if (tid == 0)
      for (int g = 0; g < ng; ++g) ll_sum += llr[g];
    __syncthreads();
  }

  // ---- scatter slots to the absolute layout, write the row ----
  for (int u = tid; u < nslot; u += NTHREADS) {
    Op o0, o1, o2;
    int s, q, out_idx;
    slot_ops(u, npos, pos, tplc, ctx, T, tl, o0, o1, o2, s, q, out_idx);
    row[out_idx] = acc[u];
  }
  __syncthreads();
  for (int k = tid; k < NOUT; k += NTHREADS) lls[size_t(b) * NOUT + k] = row[k];
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
int launch(const void* tpl, const void* tlen, const void* snr_bin,
           const void* reads, const void* rlens, const void* cand,
           const void* ctx_tab, const void* pw_tab, void* lls, void* ll0,
           int B, int T, int C, int R, int n_snr, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || C <= 0 || R <= 0 || n_snr <= 0) return int(cudaErrorInvalidValue);
  const Dims d = make_dims(T, C, R, n_snr);
  const size_t smem = make_layout(d).total;
  if (smem > SMEM_MAX) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel<SPARSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  score_kernel<SPARSE><<<B, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
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

// Group size and dynamic shared memory a launch would use (for reports).
int ccs_hmm_launch_shape(int T, int C, int R, int* group, int* smem_bytes) {
  const Dims d = make_dims(T, C, R, 1);
  *group = d.G;
  *smem_bytes = int(make_layout(d).total);
  return 0;
}

const char* ccs_hmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
