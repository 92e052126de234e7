// Batched banded global edit distance for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _edit_kernel of ccs_tpu/ops/align_pallas.py
// (:70, wrapped by edit_distance_banded) -> ccs_edit_distance_banded.
// For each of B (read, template) pairs it computes the unit-cost
// (substitution 1, gap 1) global edit distance restricted to the band
// |j - i| <= W around the main diagonal, i the read position and j the
// template position, read at k_end = tlen - rlen + W and BIG where k_end
// falls outside [0, 2W]. Bases are codes 0..3; every other code (the pad,
// -1, among them) matches nothing, on either side.
// ccs_tpu_torch/ops/align_banded.py holds the plain PyTorch version
// the kernel is compared with, cell by cell the recurrence
//   E[i][k] = min(E[i-1][k] + sub, E[i-1][k+1] + 1, E[i][k-1] + 1),
// k = j - i + W, with every cell whose j lies outside [0, tlen] held at BIG.
//
// The formulation: a bit-vector row step (Myers 1999; Hyyro 2003 for the
// diagonal band). Neighbouring cells of a row differ by -1, 0 or +1, so the
// row is two bit masks: bit k of Pv (Mv) says E[i][k+1] - E[i][k] is +1
// (-1), k in [0, 2W). With Eq bit k set where the row's read base equals
// the template base that cell k faces, a row is
//   Xv = Eq | Mv
//   D0 = (((Eq & Pv) + Pv) ^ Pv) | Xv            the add carries the
//   Ph = Mv | ~(D0 | Pv);   Mh = Pv & D0         deletion chain up the row
//   S += 1 - (D0 & 1)                            S follows E[i][0]
//   Xs = Xv >> 1, bit 2W of Eq coming in at the top
//   Pv = Mh | ~(Xs | Ph);   Mv = Ph & Xs
// and the answer is S + popcount(Pv & m) - popcount(Mv & m), m the bits
// below k_end. (Myers' Xh is D0 without Mv; Pv and Mv never share a bit, so
// Ph and Mh come out the same from D0, and Eq then enters a row only through
// Xv and Eq & Pv.) The top cell k = 2W has no difference above it to keep, so
// the state is 2W bits: NW = ceil(2W / 32) words (4 at W = 64). The cells
// the plain version holds at BIG need nothing: above the band the missing
// difference reads as +1 and `up` loses to the diagonal; below it the add
// has no carry in, so the left neighbour loses; template positions j < 0
// behave as i + |j| under pads that never match, which leaves E[i][0] = i;
// positions j > tlen feed only larger j, and the answer is read at j = tlen.
//
// What bounds it on the H100: the row recurrence is serial, a pair moves
// about tlen + rlen bytes once, and a row is about 60 word-wide integer
// instructions at W = 64, so neither bytes nor the card's integer rate is
// near: the kernel's time is the time one warp's scheduler needs for a row's
// instructions (an integer instruction of a warp takes two cycles on the 16
// integer lanes of an SM quarter, however many of its lanes are active; an
// H100 at 1980 MHz takes about 170 cycles a row), times the longest read.
// The row's dependent chain (Eq & Pv, the carry through the words, Xh, Ph,
// Pv) is 8 deep at W = 64 and hides behind that. The design keeps a row's
// instruction count low and everything it touches in registers:
//   - one thread per pair, 32 pairs per CTA (one warp), so that a few
//     thousand pairs spread over all 132 SMs and each warp has a scheduler
//     to itself; occupancy is not the aim, the row's instruction count is.
//     No shared memory, no shuffle, no barrier, no atomics: reruns are
//     bit-identical;
//   - NW is a template parameter: every loop over words unrolls, Pv and Mv
//     stay in registers, the multi-word add is one add.cc/addc.cc chain;
//   - Eq without a gather: the template lies in registers as three bit
//     planes (bit 0 and bit 1 of the base code, and "is a base": inside
//     [0, tlen) and not a pad) of NW + 1 words that stand still for 32 rows.
//     A row matches them against the read base with two three-input logic
//     operations a word and cuts its window out with one funnel shift a
//     word, by the row's number inside the block. A read code that is no
//     base clears the row's Eq: its mask is a third input of the operations
//     that form Xv and Eq & Pv, and costs no operation a word, so there is
//     one row step for every read. Four occurrence masks in
//     registers would need a three-operation select a word, and masks in
//     shared memory a staging pass with barriers and a cap on the template
//     length. Every 32 rows the planes move down a word and one new word
//     comes in. The read's 32 bases of a block are two plane words as well,
//     and a third that marks the codes that are no base, kept bit-reversed
//     and moved up a bit a row: the row's masks are three sign extensions;
//   - memory: a thread reads its own rows, 32 bytes of each per 32 rows, as
//     nine aligned 32-bit words (rows start at any byte, so the words are
//     re-aligned with funnel shifts) one block ahead of their use: no load
//     is on a row's path. Four bytes become four plane bits with one
//     multiply each (the bits of 0x01010101-spaced fields gathered into the
//     top nibble); "no base" is any of bits 2..7 of the byte, folded into
//     bit 7 with one add that cannot carry out of a byte;
//   - threads of a warp loop to their own read length and out-of-band pairs
//     leave before the first row; the idle lanes cost nothing while each
//     warp has its scheduler, so the wrapper does not sort pairs by length;
//   - integer arithmetic throughout; the float32 result is exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BIG = 10000000;       // "left the band"; 1e7 as the float result
constexpr int PAIRS = 32;           // pairs (threads) per CTA: one warp
constexpr int MAX_NW = 8;           // words of row state: band <= 127

// Bits [0, c) of a word, c clamped to [0, 32].
__device__ __forceinline__ uint32_t low_mask(int c) {
  return c >= 32 ? 0xffffffffu : (c <= 0 ? 0u : ((1u << c) - 1u));
}

// Bits b of a word with 0 <= base + b < n.
__device__ __forceinline__ uint32_t range_mask(int base, int n) {
  return low_mask(n - base) & ~low_mask(-base);
}

// 32 bytes of a row as loaded: nine aligned words and the bit offset of the
// first wanted byte in the first of them.
struct Raw {
  uint32_t w[9];
  int shift;
};

// Loads bytes off .. off + 31 of a row of n bytes (off may lie outside the
// row); bytes outside [0, n) read as 0.
__device__ __forceinline__ void fetch(const uint8_t* row, int n, int off,
                                      Raw& r) {
  const int mis = int((reinterpret_cast<uintptr_t>(row) + off) & 3);
  const int a = off - mis;                     // row + a is 4-byte aligned
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int o = a + 4 * k;
    uint32_t w = 0;
    if (o >= 0 && o + 4 <= n) {
      w = __ldg(reinterpret_cast<const uint32_t*>(row + o));
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (o + b >= 0 && o + b < n) w |= uint32_t(__ldg(row + o + b)) << (8 * b);
    }
    r.w[k] = w;
  }
  r.shift = 8 * mis;
}

// The 32 bases of a fetch as bit planes, base b at bit b: bit 0 and bit 1 of
// the code, and "no base" (a code outside 0..3: any of bits 2..7 set). The
// multiplies gather the four marked bits of a word, one per byte, into its
// top nibble.
__device__ __forceinline__ void planes(const Raw& r, uint32_t& lo,
                                       uint32_t& hi, uint32_t& pad) {
  lo = hi = pad = 0;
#pragma unroll
  for (int g = 7; g >= 0; --g) {
    const uint32_t x = __funnelshift_r(r.w[g], r.w[g + 1], r.shift);
    lo = __funnelshift_l((x & 0x01010101u) * 0x10204080u, lo, 4);
    hi = __funnelshift_l((x & 0x02020202u) * 0x08102040u, hi, 4);
    // bits 2..6 of a byte, if any is set, carry into its bit 7
    const uint32_t nb = (((x & 0x7c7c7c7cu) + 0x7c7c7c7cu) | x) & 0x80808080u;
    pad = __funnelshift_l(nb * 0x00204081u, pad, 4);
  }
}

// sum = a + b over NW words, the carry running up the words.
template <int NW>
__device__ __forceinline__ void add_words(const uint32_t (&a)[NW],
                                          const uint32_t (&b)[NW],
                                          uint32_t (&sum)[NW]) {
  if constexpr (NW == 1) {
    sum[0] = a[0] + b[0];
  } else {
    asm volatile("add.cc.u32 %0, %1, %2;"
                 : "=r"(sum[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
    for (int w = 1; w < NW - 1; ++w)
      asm volatile("addc.cc.u32 %0, %1, %2;"
                   : "=r"(sum[w]) : "r"(a[w]), "r"(b[w]));
    asm volatile("addc.u32 %0, %1, %2;"
                 : "=r"(sum[NW - 1]) : "r"(a[NW - 1]), "r"(b[NW - 1]));
  }
}

// One read row, number s of its 32-row block. L, H, V are the template's
// planes for the block; RL, RH the read's and RB its "is a base" word, all
// three bit-reversed and shifted up a bit a row, so that the row's base
// stands at the sign bit; m_last and m_top keep the Eq bits up to 2W in words
// NW - 1 and NW; bit 0 of D0 (cell 0 took the diagonal at no cost) is
// shifted into dw.
template <int NW>
__device__ __forceinline__ void row_step(
    const uint32_t (&L)[NW + 1], const uint32_t (&H)[NW + 1],
    const uint32_t (&V)[NW + 1], uint32_t& RL, uint32_t& RH, uint32_t& RB,
    int s, uint32_t m_last, uint32_t m_top, uint32_t (&pv)[NW],
    uint32_t (&mv)[NW], uint32_t& dw) {
  const uint32_t rlo = uint32_t(int32_t(RL) >> 31);
  const uint32_t rhi = uint32_t(int32_t(RH) >> 31);
  const uint32_t rb = uint32_t(int32_t(RB) >> 31);
  RL <<= 1;
  RH <<= 1;
  RB <<= 1;
  uint32_t e[NW + 1];
#pragma unroll
  for (int w = 0; w <= NW; ++w)
    e[w] = ~(L[w] ^ rlo) & V[w] & ~(H[w] ^ rhi);
  uint32_t eq[NW], xv[NW], t[NW], sum[NW], ph[NW], mh[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) eq[w] = __funnelshift_r(e[w], e[w + 1], s);
  eq[NW - 1] &= m_last;
  const uint32_t top = (e[NW] >> s) & m_top & rb;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    xv[w] = (eq[w] & rb) | mv[w];
    t[w] = eq[w] & rb & pv[w];
  }
  add_words<NW>(t, pv, sum);
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint32_t d = (sum[w] ^ pv[w]) | xv[w];
    if (w == 0) dw = __funnelshift_r(dw, d, 1);
    ph[w] = mv[w] | ~(d | pv[w]);
    mh[w] = pv[w] & d;
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint32_t xs =
        __funnelshift_r(xv[w], (w + 1 < NW) ? xv[w + 1] : top, 1);
    pv[w] = mh[w] | ~(xs | ph[w]);
    mv[w] = ph[w] & xs;
  }
}

template <int NW>
__global__ void __launch_bounds__(PAIRS)
edit_kernel(const int8_t* __restrict__ tpl, const int32_t* __restrict__ tlen,
            const int8_t* __restrict__ reads, const int32_t* __restrict__ rlens,
            float* __restrict__ dist, int B, int TMAX, int RMAX, int W) {
  const int pair = blockIdx.x * PAIRS + threadIdx.x;
  if (pair >= B) return;
  const int tl = tlen[pair];
  const int rl = rlens[pair];
  const int k_end = tl - rl + W;               // where the distance is read
  if (k_end < 0 || k_end > 2 * W) {
    dist[pair] = float(BIG);
    return;
  }
  const int tn = tl < TMAX ? tl : TMAX;        // bases that may be loaded
  const int rn = rl < RMAX ? rl : RMAX;        // rows, as the plain version
  const uint8_t* t_row =
      reinterpret_cast<const uint8_t*>(tpl) + size_t(pair) * TMAX;
  const uint8_t* r_row =
      reinterpret_cast<const uint8_t*>(reads) + size_t(pair) * RMAX;

  // Word w of the planes holds template indices 32 * (block + w) - W + b at
  // bit b; the window of row s of the block starts at bit s of word 0.
  // The first NW + 1 words come in from the top one by one, as every later
  // word does.
  uint32_t L[NW + 1] = {}, H[NW + 1] = {}, V[NW + 1] = {}, pad;
  Raw raw_t, raw_r;
#pragma unroll 1
  for (int w = 0; w <= NW; ++w) {
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      L[v] = L[v + 1];
      H[v] = H[v + 1];
      V[v] = V[v + 1];
    }
    fetch(t_row, tn, 32 * w - W, raw_t);
    planes(raw_t, L[NW], H[NW], pad);
    V[NW] = range_mask(32 * w - W, tn) & ~pad;
  }
  fetch(r_row, rn, 0, raw_r);

  // row 0 is |k - W|: falling by one up to cell W, rising after it
  uint32_t pv[NW], mv[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    mv[w] = low_mask(W - 32 * w);
    pv[w] = low_mask(2 * W - 32 * w) & ~mv[w];
  }
  const uint32_t m_last = low_mask(2 * W + 1 - 32 * (NW - 1));
  const uint32_t m_top = low_mask(2 * W + 1 - 32 * NW);
  int d0 = 0;

  for (int r0 = 0; r0 < rn; r0 += 32) {
    uint32_t RL, RH, RB, dw = 0;
    planes(raw_r, RL, RH, pad);
    RL = __brev(RL);
    RH = __brev(RH);
    RB = __brev(~pad);
    // the next block's bytes, in flight while this block's rows run
    const int t_next = r0 + 32 * (NW + 1) - W;
    fetch(t_row, tn, t_next, raw_t);
    fetch(r_row, rn, r0 + 32, raw_r);
    const int steps = (rn - r0) < 32 ? (rn - r0) : 32;
#pragma unroll 4
    for (int s = 0; s < steps; ++s)
      row_step<NW>(L, H, V, RL, RH, RB, s, m_last, m_top, pv, mv, dw);
    d0 += __popc(dw);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      L[w] = L[w + 1];
      H[w] = H[w + 1];
      V[w] = V[w + 1];
    }
    planes(raw_t, L[NW], H[NW], pad);
    V[NW] = range_mask(t_next, tn) & ~pad;
  }

  int d = W + rn - d0;                         // E[rn][0]
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint32_t m = low_mask(k_end - 32 * w);
    d += __popc(pv[w] & m) - __popc(mv[w] & m);
  }
  dist[pair] = float(d);
}

template <int NW>
int launch(const void* tpl, const void* tlen, const void* reads,
           const void* rlens, void* dist, int B, int TMAX, int RMAX, int W,
           void* stream) {
  const int ctas = (B + PAIRS - 1) / PAIRS;
  edit_kernel<NW><<<ctas, PAIRS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tpl), static_cast<const int32_t*>(tlen),
      static_cast<const int8_t*>(reads), static_cast<const int32_t*>(rlens),
      static_cast<float*>(dist), B, TMAX, RMAX, W);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest band the kernel supports (2 * band + 1 <= 32 * MAX_NW).
int ccs_edit_max_band() { return (32 * MAX_NW - 1) / 2; }

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
  const int NW = band == 0 ? 1 : (2 * band + 31) / 32;   // words of row state
  switch (NW) {
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
