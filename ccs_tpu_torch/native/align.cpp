// Banded global alignment with traceback — native host kernel.
//
// Exact port of ccs_tpu_torch.ops.align.edit_align's NumPy formulation (same band
// framing, costs, tie-breaking and traceback), called via ctypes. This is
// the host-side bookkeeping aligner (backbone pileup for drafting, window
// boundary mapping — the edlib/KSW2 role in the reference,
// reference docs, how-does-ccs-work.md:41-55); the consensus itself
// marginalizes over alignments in the pair-HMM on the TPU. The Python loop
// version costs ~150 ms per 2 kb subread; this runs the same DP in ~1 ms,
// keeping the host feeder ahead of the device polish.
//
// Build: g++ -O3 -shared -fPIC -o libccsalign.so align.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
#define CCS_AVX512 1
#endif

namespace {
constexpr int64_t BIG = int64_t(1) << 30;
constexpr int8_t M_DIAG = 0, M_UP = 1, M_LEFT = 2;

#ifdef CCS_AVX512
// Exclusive prefix-min over s[0..n) into pm[0..n) (pm[k] = min of s[0..k-1],
// pm[0] = init). Log-step lane shifts inside each 16-lane block + a scalar
// carry between blocks — min is associative, so this is bit-identical to
// the sequential scan it replaces.
inline void prefix_min_exclusive(const int32_t* s, int32_t* pm, int64_t n,
                                 int32_t init) {
    const __m512i vbig = _mm512_set1_epi32(init);
    int32_t carry = init;
    for (int64_t k = 0; k < n; k += 16) {
        const int nn = int(n - k < 16 ? n - k : 16);
        const __mmask16 mk = __mmask16((1u << (nn & 31)) - 1u | (nn == 16 ? 0xFFFFu : 0u));
        __m512i x = _mm512_mask_loadu_epi32(vbig, mk, s + k);
        // inclusive prefix-min within the block
        x = _mm512_min_epi32(x, _mm512_alignr_epi32(x, vbig, 15));  // shift 1
        x = _mm512_min_epi32(x, _mm512_alignr_epi32(x, vbig, 14));  // shift 2
        x = _mm512_min_epi32(x, _mm512_alignr_epi32(x, vbig, 12));  // shift 4
        x = _mm512_min_epi32(x, _mm512_alignr_epi32(x, vbig, 8));   // shift 8
        // exclusive = inclusive shifted down one, carry at lane 0
        __m512i carry_v = _mm512_set1_epi32(carry);
        __m512i excl = _mm512_alignr_epi32(x, _mm512_setzero_si512(), 15);
        excl = _mm512_mask_mov_epi32(excl, __mmask16(1), carry_v);
        excl = _mm512_min_epi32(excl, carry_v);
        _mm512_mask_storeu_epi32(pm + k, mk, excl);
        // block carry: min(carry, inclusive min of the block's live lanes)
        alignas(64) int32_t tmp[16];
        _mm512_store_si512(reinterpret_cast<__m512i*>(tmp), x);
        const int32_t last = tmp[nn - 1];
        carry = last < carry ? last : carry;
    }
}
#endif
}

extern "C" {

// Returns the alignment score, or -1 if the optimal path escapes the band.
//
//   read[R], tpl[T]      int8 base codes (negative = PAD, never matches)
//   centers[R+1]         band center column per read row (monotone, int64)
//   W                    half band width; band columns = centers[i]-W .. +W
//   rpos_at[T+1]         out: lowest read index visited at template pos j
//   ops_rev / ops_len    out: traceback ops (0=M,1=I,2=D), END-FIRST order,
//                        capacity must be >= R+T
//   n_match              out: exact base matches on M columns
int64_t ccs_edit_align(const int8_t* read, int64_t R,
                       const int8_t* tpl, int64_t T,
                       const int64_t* centers, int64_t W,
                       int64_t sub_cost, int64_t gap_cost,
                       int64_t* rpos_at,
                       int8_t* ops_rev, int64_t* ops_len,
                       int64_t* n_match) {
    const int64_t width = 2 * W + 1;
    std::vector<int64_t> prev(width, BIG), cur(width, BIG);
    std::vector<int8_t> moves(size_t(R) * width);

    // row 0: all deletions
    for (int64_t k = 0; k < width; ++k) {
        const int64_t j = centers[0] - W + k;
        if (j >= 0 && j <= T) prev[k] = j * gap_cost;
    }

    for (int64_t i = 1; i <= R; ++i) {
        const int64_t shift = centers[i] - centers[i - 1];
        const int8_t rc = read[i - 1];
        int8_t* mrow = moves.data() + (i - 1) * width;
        int64_t runmin = BIG;  // min over k' <= k of (tmp[k'] - g*k')
        for (int64_t k = 0; k < width; ++k) {
            const int64_t j = centers[i] - W + k;
            const bool valid = (j >= 0 && j <= T);
            // prev frame value at column j (vertical) and j-1 (diagonal)
            const int64_t kp = k + shift;           // same column, prev frame
            const int64_t pv = (kp >= 0 && kp < width) ? prev[kp] : BIG;
            const int64_t kd = kp - 1;              // column j-1, prev frame
            const int64_t dv = (kd >= 0 && kd < width) ? prev[kd] : BIG;
            const int64_t jm1 = j - 1;
            int64_t sub_v = BIG;
            if (jm1 >= 0) {
                const int8_t tc = (jm1 < T) ? tpl[jm1] : int8_t(-2);
                sub_v = dv + ((tc == rc) ? 0 : sub_cost);
            }
            const int64_t ins_v = pv + gap_cost;
            int64_t tmp = sub_v <= ins_v ? sub_v : ins_v;
            int8_t mv = (sub_v <= ins_v) ? M_DIAG : M_UP;
            if (!valid) tmp = BIG;
            // horizontal chain: cur[k] = min_{k'<=k} tmp[k'] + g*(k-k')
            const int64_t shifted = tmp - gap_cost * k;
            if (shifted < runmin) runmin = shifted;
            int64_t c = runmin + gap_cost * k;
            if (c < tmp) mv = M_LEFT;
            if (!valid) c = BIG;
            mrow[k] = mv;
            cur[k] = c;
        }
        std::swap(prev, cur);
    }

    const int64_t end_k = T - centers[R] + W;
    if (end_k < 0 || end_k >= width || prev[end_k] >= BIG) return -1;
    const int64_t score = prev[end_k];

    // traceback from (R, T); backward walk => final write to rpos_at[j] is
    // the lowest read index visited at template position j
    int64_t i = R, k = end_k, nm = 0, no = 0;
    for (;;) {
        const int64_t j = centers[i] - W + k;
        rpos_at[j] = i;
        if (i == 0 && j == 0) break;
        int8_t mv;
        if (i == 0) mv = M_LEFT;
        else if (j == 0) mv = M_UP;
        else mv = moves[(i - 1) * width + k];
        if (mv == M_DIAG) {
            if (read[i - 1] == tpl[j - 1]) ++nm;
            const int64_t shift = centers[i] - centers[i - 1];
            i -= 1; k = k - 1 + shift;
            ops_rev[no++] = M_DIAG;
        } else if (mv == M_UP) {
            const int64_t shift = centers[i] - centers[i - 1];
            i -= 1; k = k + shift;
            ops_rev[no++] = M_UP;
        } else {
            k -= 1;
            ops_rev[no++] = M_LEFT;
        }
    }
    *ops_len = no;
    *n_match = nm;
    return score;
}

}  // extern "C"

namespace {

// Core of the affine (Gotoh) banded DP; shared by the ctypes entry point
// and the native pileup-draft kernel. ops_rev is END-FIRST; rpos_at may be
// null. Returns the score, or -1 if the path escapes the band.
int64_t affine_core(const int8_t* read, int64_t R,
                    const int8_t* tpl, int64_t T,
                    const int64_t* centers, int64_t W,
                    int64_t sub_cost64, int64_t gap_open64, int64_t gap_ext64,
                    int64_t* rpos_at,
                    int8_t* ops_rev, int64_t* ops_len,
                    int64_t* n_match) {
    // int32 cost arithmetic (all real costs are tiny; BIG32 + a few adds
    // stays far below INT32_MAX) and thread-local scratch: this DP runs
    // once per (read, draft-round) on the host feeder path, so allocation
    // and memory traffic dominate — packed backpointers (vmove | iext<<2)
    // and 4-byte rows roughly halve the per-cell traffic vs the round-2
    // version.
    constexpr int32_t BIG32 = int32_t(1) << 28;
    const int32_t sub_cost = int32_t(sub_cost64);
    const int32_t gap_open = int32_t(gap_open64);
    const int32_t gap_ext = int32_t(gap_ext64);
    const int64_t width = 2 * W + 1;
    thread_local std::vector<int32_t> prevV_s, prevI_s, curV_s, curI_s;
    thread_local std::vector<int8_t> moves_s, dexts_s;
    prevV_s.assign(width, BIG32);
    prevI_s.assign(width, BIG32);
    curV_s.assign(width, BIG32);
    curI_s.assign(width, BIG32);
    moves_s.resize(size_t(R) * width);       // vmove (2 bits) | iext << 2
    dexts_s.resize(size_t(R + 1) * width);
    int32_t* prevV = prevV_s.data();
    int32_t* prevI = prevI_s.data();
    int32_t* curV = curV_s.data();
    int32_t* curI = curI_s.data();

    for (int64_t k = 0; k < width; ++k) {
        const int64_t j = centers[0] - W + k;
        if (j >= 0 && j <= T)
            prevV[k] = (j == 0) ? 0 : int32_t(gap_open + j * gap_ext);
    }

    // per-row scratch for the three-pass formulation (A: independent cell
    // values, vectorizable; B: scalar prefix-min deletion scan; C: combine,
    // vectorizable). The loop-carried D-chain is isolated into pass B so
    // passes A/C auto-vectorize — same trick as the NumPy oracle's
    // prefix-min, same results bit-for-bit.
    thread_local std::vector<int32_t> ubuf_s, dbuf_s, sbuf_s, pmbuf_s;
    ubuf_s.resize(width);
    dbuf_s.resize(width);
    sbuf_s.resize(width);
    pmbuf_s.resize(width);
    int32_t* ubuf = ubuf_s.data();
    int32_t* dbuf = dbuf_s.data();
    int32_t* sbuf = sbuf_s.data();
    int32_t* pmbuf = pmbuf_s.data();
    const int32_t go_ge = gap_open + gap_ext;

    for (int64_t i = 1; i <= R; ++i) {
        const int64_t shift = centers[i] - centers[i - 1];
        const int8_t rc = read[i - 1];
        int8_t* mrow = moves_s.data() + (i - 1) * width;
        int8_t* drow = dexts_s.data() + i * width;
        const int64_t jbase = centers[i] - W;
        // interior range: j in [1, T], k+shift in [1, width-1] — all loads
        // in-bounds and jm1 >= 0 there
        int64_t klo = 1 - shift > 1 - jbase ? 1 - shift : 1 - jbase;
        if (klo < 1) klo = 1;
        int64_t khi = width - 1 - shift < T - jbase ? width - 1 - shift
                                                    : T - jbase;
        if (khi > width - 1) khi = width - 1;
        if (khi < klo) { klo = width; khi = width - 1; }  // no interior

        // ---- pass A: u[k] (BIG-masked), i_val -> curI, mv|iext -> mrow
        const auto cellA = [&](int64_t k) {
            const int64_t j = jbase + k;
            const bool valid = (j >= 0 && j <= T);
            const int64_t kp = k + shift;
            const int32_t pV = (kp >= 0 && kp < width) ? prevV[kp] : BIG32;
            const int32_t pI = (kp >= 0 && kp < width) ? prevI[kp] : BIG32;
            const int64_t kd = kp - 1;
            const int32_t dV = (kd >= 0 && kd < width) ? prevV[kd] : BIG32;
            int32_t m_val = BIG32;
            if (j - 1 >= 0) {
                const int8_t tc = (j - 1 < T) ? tpl[j - 1] : int8_t(-2);
                m_val = dV + ((tc == rc) ? 0 : sub_cost);
            }
            const int32_t i_open = pV + go_ge;
            const int32_t i_ext = pI + gap_ext;
            const int32_t i_val = i_ext <= i_open ? i_ext : i_open;
            int32_t u = m_val <= i_val ? m_val : i_val;
            if (!valid) u = BIG32;
            ubuf[k] = u;
            curI[k] = valid ? i_val : BIG32;
            mrow[k] = int8_t((m_val <= i_val ? M_DIAG : M_UP)
                             | ((i_ext <= i_open) ? 4 : 0));
        };
        for (int64_t k = 0; k < klo; ++k) cellA(k);
        {
            const int32_t* __restrict__ pVs = prevV + shift;
            const int32_t* __restrict__ pIs = prevI + shift;
            const int8_t* __restrict__ tj = tpl + jbase - 1;  // tpl[j-1]
            int32_t* __restrict__ ub = ubuf;
            int32_t* __restrict__ cI = curI;
            int8_t* __restrict__ mr = mrow;
#ifdef CCS_AVX512
            // 16 cells per iteration; masked loads/stores fault-suppress the
            // tail lanes, so only in-range (interior-guaranteed) lanes touch
            // memory. Bit-identical to the scalar loop below. Pass B1's
            // shifted value s = u - k*ge is fused in (one loop fewer per
            // row; the boundary cells get theirs in the prologue below).
            const __m512i v_sub = _mm512_set1_epi32(sub_cost);
            const __m512i v_goge = _mm512_set1_epi32(go_ge);
            const __m512i v_ge = _mm512_set1_epi32(gap_ext);
            const __m512i v_up = _mm512_set1_epi32(int32_t(M_UP));
            const __m512i v_diag = _mm512_set1_epi32(int32_t(M_DIAG));
            const __m512i v_four = _mm512_set1_epi32(4);
            const __m512i v_rc = _mm512_set1_epi32(int32_t(rc));
            const __m512i v_iota = _mm512_setr_epi32(
                0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
            int32_t* __restrict__ sbA = sbuf;
            for (int64_t k = klo; k <= khi; k += 16) {
                const int nn = int(khi - k + 1 < 16 ? khi - k + 1 : 16);
                const __mmask16 mk = __mmask16(
                    nn == 16 ? 0xFFFFu : ((1u << nn) - 1u));
                const __m512i pVd = _mm512_maskz_loadu_epi32(mk, pVs + k - 1);
                const __m512i pV = _mm512_maskz_loadu_epi32(mk, pVs + k);
                const __m512i pI = _mm512_maskz_loadu_epi32(mk, pIs + k);
                const __m128i t8 = _mm_maskz_loadu_epi8(mk, tj + k);
                const __m512i tv = _mm512_cvtepi8_epi32(t8);
                const __mmask16 meq = _mm512_cmpeq_epi32_mask(tv, v_rc);
                const __m512i m_val = _mm512_mask_mov_epi32(
                    _mm512_add_epi32(pVd, v_sub), meq, pVd);
                const __m512i i_open = _mm512_add_epi32(pV, v_goge);
                const __m512i i_ext = _mm512_add_epi32(pI, v_ge);
                const __mmask16 mext = _mm512_cmple_epi32_mask(i_ext, i_open);
                const __m512i i_val = _mm512_min_epi32(i_ext, i_open);
                const __mmask16 mdiag = _mm512_cmple_epi32_mask(m_val, i_val);
                const __m512i u = _mm512_min_epi32(m_val, i_val);
                _mm512_mask_storeu_epi32(ub + k, mk, u);
                _mm512_mask_storeu_epi32(cI + k, mk, i_val);
                __m512i mv = _mm512_mask_mov_epi32(v_up, mdiag, v_diag);
                mv = _mm512_mask_or_epi32(mv, mext, mv, v_four);
                _mm_mask_storeu_epi8(mr + k, mk, _mm512_cvtepi32_epi8(mv));
                const __m512i kk = _mm512_add_epi32(
                    v_iota, _mm512_set1_epi32(int32_t(k)));
                _mm512_mask_storeu_epi32(
                    sbA + k, mk,
                    _mm512_sub_epi32(u, _mm512_mullo_epi32(kk, v_ge)));
            }
#else
            for (int64_t k = klo; k <= khi; ++k) {
                const int32_t m_val = pVs[k - 1]
                                      + ((tj[k] == rc) ? 0 : sub_cost);
                const int32_t i_open = pVs[k] + go_ge;
                const int32_t i_ext = pIs[k] + gap_ext;
                const int32_t i_val = i_ext <= i_open ? i_ext : i_open;
                ub[k] = m_val <= i_val ? m_val : i_val;
                cI[k] = i_val;
                mr[k] = int8_t((m_val <= i_val ? M_DIAG : M_UP)
                               | ((i_ext <= i_open) ? 4 : 0));
            }
#endif
        }
        for (int64_t k = khi + 1; k < width; ++k) cellA(k);
#ifdef CCS_AVX512
        // boundary cells' B1 values (the interior loop fused its own)
        for (int64_t k = 0; k < klo; ++k)
            sbuf[k] = ubuf[k] - int32_t(k) * gap_ext;
        for (int64_t k = khi + 1; k < width; ++k)
            sbuf[k] = ubuf[k] - int32_t(k) * gap_ext;
#endif

        // ---- pass B: exclusive prefix-min deletion scan, split so only
        // the 1-op/iter min scan stays scalar (B1/B3/B4 auto-vectorize).
        // s[k] = u[k] - ge*k; runmin(k) = min_{k'<k} s[k']; pollution from
        // BIG-masked cells stays > BIG32 after re-adding ge*k + gap_open,
        // so every comparison below behaves exactly like the fused scalar
        // scan it replaces.
        {
            const int64_t kv_lo = jbase < 0 ? -jbase : 0;        // j >= 0
            int64_t kv_hi = T - jbase;                           // j <= T
            if (kv_hi > width - 1) kv_hi = width - 1;
            const int64_t kj_lo = (1 - jbase) > 1 ? (1 - jbase) : 1;  // j>=1
            int64_t dlo = kj_lo > kv_lo ? kj_lo : kv_lo;
            if (dlo < 1) dlo = 1;
#ifndef CCS_AVX512
            // B1: shifted values (vector) — fused into pass A on AVX-512
            {
                const int32_t* __restrict__ ub = ubuf;
                int32_t* __restrict__ sb = sbuf;
                for (int64_t k = 0; k < width; ++k)
                    sb[k] = ub[k] - int32_t(k) * gap_ext;
            }
#endif
            // B2: exclusive prefix min (log-step lane shifts on AVX-512;
            // scalar 1-min/iter chain otherwise — min reassociates exactly)
#ifdef CCS_AVX512
            prefix_min_exclusive(sbuf, pmbuf, width, BIG32);
#else
            {
                int32_t rm = BIG32;
                for (int64_t k = 0; k < width; ++k) {
                    pmbuf[k] = rm;
                    const int32_t s = sbuf[k];
                    rm = s < rm ? s : rm;
                }
            }
#endif
#ifdef CCS_AVX512
            // fused B3+B4+C: deletion candidates, D-extension flags, and
            // the combine in ONE register-resident pass — dval never
            // round-trips through dbuf. Bit-identical to the split scalar
            // passes in the fallback branch.
            {
                const int32_t* __restrict__ pm = pmbuf;
                const int32_t* __restrict__ ub = ubuf;
                int32_t* __restrict__ cV = curV;
                int8_t* __restrict__ mr = mrow;
                drow[0] = 0;
                const __m512i iota = _mm512_setr_epi32(
                    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
                const __m512i v_ge = _mm512_set1_epi32(gap_ext);
                const __m512i v_go = _mm512_set1_epi32(gap_open);
                const __m512i v_goge = _mm512_set1_epi32(go_ge);
                const __m512i v_big = _mm512_set1_epi32(BIG32);
                const __m512i v_one = _mm512_set1_epi32(1);
                const __m512i v_left4 = _mm512_set1_epi32(4);
                const __m512i v_mleft = _mm512_set1_epi32(int32_t(M_LEFT));
                const __m512i v_dlo = _mm512_set1_epi32(int32_t(dlo));
                const __m512i v_dhi = _mm512_set1_epi32(int32_t(kv_hi));
                for (int64_t k = 0; k < width; k += 16) {
                    const int nn = int(width - k < 16 ? width - k : 16);
                    const __mmask16 mk = __mmask16(
                        nn == 16 ? 0xFFFFu : ((1u << nn) - 1u));
                    const __m512i kk = _mm512_add_epi32(
                        iota, _mm512_set1_epi32(int32_t(k)));
                    const __m512i rm = _mm512_maskz_loadu_epi32(mk, pm + k);
                    const __mmask16 rng =
                        _mm512_cmpge_epi32_mask(kk, v_dlo)
                        & _mm512_cmple_epi32_mask(kk, v_dhi);
                    const __mmask16 okm =
                        rng & _mm512_cmplt_epi32_mask(rm, v_big) & mk;
                    const __m512i val = _mm512_add_epi32(
                        rm, _mm512_add_epi32(
                                _mm512_mullo_epi32(kk, v_ge), v_go));
                    const __m512i dval = _mm512_mask_mov_epi32(v_big, okm,
                                                               val);
                    const __m512i u = _mm512_maskz_loadu_epi32(mk, ub + k);
                    _mm512_mask_storeu_epi32(cV + k, mk,
                                             _mm512_min_epi32(u, dval));
                    const __mmask16 dw = _mm512_cmplt_epi32_mask(dval, u);
                    const __m128i m8 = _mm_maskz_loadu_epi8(mk, mr + k);
                    const __m512i m32 = _mm512_cvtepi8_epi32(m8);
                    const __m512i dwin = _mm512_or_epi32(
                        _mm512_and_epi32(m32, v_left4), v_mleft);
                    const __m512i mout = _mm512_mask_mov_epi32(m32, dw,
                                                               dwin);
                    _mm_mask_storeu_epi8(mr + k, mk,
                                         _mm512_cvtepi32_epi8(mout));
                    // drow[k+1+lane] = dval<BIG && dval+ge <= u+go_ge
                    const int nn2 = int(width - 1 - k < nn ? width - 1 - k
                                                           : nn);
                    if (nn2 > 0) {
                        const __mmask16 mk2 = __mmask16(
                            nn2 == 16 ? 0xFFFFu : ((1u << nn2) - 1u));
                        const __mmask16 cond =
                            _mm512_cmplt_epi32_mask(dval, v_big)
                            & _mm512_cmple_epi32_mask(
                                  _mm512_add_epi32(dval, v_ge),
                                  _mm512_add_epi32(u, v_goge));
                        _mm_mask_storeu_epi8(
                            drow + k + 1, mk2,
                            _mm512_cvtepi32_epi8(
                                _mm512_maskz_mov_epi32(cond, v_one)));
                    }
                }
            }
        }
#else
            // B3: deletion candidates (vector); out-of-range stays BIG32
            for (int64_t k = 0; k < width; ++k) dbuf[k] = BIG32;
            if (dlo <= kv_hi) {
                const int32_t* __restrict__ pm = pmbuf;
                int32_t* __restrict__ db = dbuf;
                for (int64_t k = dlo; k <= kv_hi; ++k) {
                    const int32_t rm = pm[k];
                    db[k] = rm < BIG32
                        ? rm + int32_t(k) * gap_ext + gap_open : BIG32;
                }
            }
            // B4: D-extension flags for the traceback (vector)
            {
                const int32_t* __restrict__ db = dbuf;
                const int32_t* __restrict__ ub = ubuf;
                drow[0] = 0;
                for (int64_t k = 1; k < width; ++k)
                    drow[k] = (db[k - 1] < BIG32 &&
                               db[k - 1] + gap_ext <= ub[k - 1] + go_ge)
                                  ? 1 : 0;
            }
        }

        // ---- pass C: combine V = min(U, D), record D-wins in the move
        {
            const int32_t* __restrict__ ub = ubuf;
            const int32_t* __restrict__ db = dbuf;
            int32_t* __restrict__ cV = curV;
            int8_t* __restrict__ mr = mrow;
            for (int64_t k = 0; k < width; ++k) {
                const int32_t u = ub[k];
                const int32_t d_val = db[k];
                cV[k] = u <= d_val ? u : d_val;
                mr[k] = (d_val < u) ? int8_t((mr[k] & 4) | M_LEFT) : mr[k];
            }
        }
#endif
        std::swap(prevV, curV);
        std::swap(prevI, curI);
    }

    const int64_t end_k = T - centers[R] + W;
    if (end_k < 0 || end_k >= width || prevV[end_k] >= BIG32) return -1;
    const int64_t score = prevV[end_k];

    // traceback with explicit Gotoh state: 0 = V, 1 = I-chain, 2 = D-chain
    int64_t i = R, k = end_k, nm = 0, no = 0;
    int state = 0;
    for (;;) {
        const int64_t j = centers[i] - W + k;
        if (rpos_at) rpos_at[j] = i;
        if (i == 0 && j == 0) break;
        if (state == 0) {
            if (i == 0) { state = 2; continue; }
            if (j == 0) { state = 1; continue; }
            const int8_t mv = moves_s[(i - 1) * width + k] & 3;
            if (mv == M_DIAG) {
                if (read[i - 1] == tpl[j - 1]) ++nm;
                const int64_t shift = centers[i] - centers[i - 1];
                i -= 1; k = k - 1 + shift;
                ops_rev[no++] = M_DIAG;
            } else if (mv == M_UP) state = 1;
            else state = 2;
        } else if (state == 1) {
            const bool was_ext =
                i > 0 && (moves_s[(i - 1) * width + k] & 4);
            const int64_t shift = centers[i] - centers[i - 1];
            i -= 1; k = k + shift;
            ops_rev[no++] = M_UP;
            state = was_ext ? 1 : 0;
        } else {
            const bool was_ext = i > 0 && dexts_s[i * width + k];
            k -= 1;
            ops_rev[no++] = M_LEFT;
            state = was_ext ? 2 : 0;
        }
    }
    *ops_len = no;
    *n_match = nm;
    return score;
}

// --------------------------------------------------------------------------
// k-mer anchor chaining (port of ccs_tpu_torch.ops.align.anchor_chain: unique
// template k-mers matched against the read, then patience LIS on tpos).
// --------------------------------------------------------------------------

// Unique-k-mer index of a template: code -> position, -2 for duplicates.
// PAD bases poison their k windows. Built once, shared across the reads of
// a ZMW (the per-call rebuild dominated the round-3 anchor profile).
// Open-addressing flat table (power-of-2 capacity, linear probing):
// ~3-4x faster build+lookup than unordered_map on this access pattern,
// which is the fixed per-read cost of the draft pileup.
struct FlatKmerIndex {
    std::vector<uint64_t> keys;   // EMPTY_KEY = all-ones sentinel
    std::vector<int64_t> vals;
    uint64_t cap_mask = 0;
    int64_t n = 0;
    static constexpr uint64_t EMPTY_KEY = ~uint64_t(0);

    static inline uint64_t mix(uint64_t x) {
        x += 0x9e3779b97f4a7c15ULL;
        x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
        x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
        return x ^ (x >> 31);
    }
    void reset(int64_t expect) {
        uint64_t cap = 16;
        while (int64_t(cap) < expect * 2) cap <<= 1;
        cap_mask = cap - 1;
        keys.assign(cap, EMPTY_KEY);
        vals.assign(cap, 0);
        n = 0;
    }
    inline void upsert(uint64_t code, int64_t p) {
        uint64_t h = mix(code) & cap_mask;
        for (;;) {
            if (keys[h] == EMPTY_KEY) {
                keys[h] = code;
                vals[h] = p;
                ++n;
                return;
            }
            if (keys[h] == code) { vals[h] = -2; return; }  // duplicate
            h = (h + 1) & cap_mask;
        }
    }
    // returns position >= 0, -2 for duplicate, INT64_MIN for absent
    inline int64_t find(uint64_t code) const {
        uint64_t h = mix(code) & cap_mask;
        for (;;) {
            if (keys[h] == EMPTY_KEY) return INT64_MIN;
            if (keys[h] == code) return vals[h];
            h = (h + 1) & cap_mask;
        }
    }
    bool empty() const { return n == 0; }
};

void build_kmer_index(const int8_t* tpl, int64_t T, int64_t k,
                      FlatKmerIndex* pos) {
    const int64_t nt = T - k + 1;
    pos->reset(nt > 0 ? nt : 1);
    if (nt <= 0) return;
    uint64_t code = 0;
    const uint64_t mask = (k >= 32) ? ~uint64_t(0)
                                    : ((uint64_t(1) << (2 * k)) - 1);
    int64_t bad = 0;  // count of PAD bases in the current window
    for (int64_t i = 0; i < T; ++i) {
        const int8_t b = tpl[i];
        code = ((code << 2) | uint64_t(b < 0 ? 0 : (b & 3))) & mask;
        if (b < 0) bad = k;       // poisons the next k windows
        else if (bad > 0) --bad;
        if (i >= k - 1 && bad == 0) pos->upsert(code, i - k + 1);
    }
}

void chain_with_index(const int8_t* read, int64_t R,
                      const FlatKmerIndex& pos,
                      int64_t k,
                      std::vector<std::pair<int64_t, int64_t>>* chain) {
    chain->clear();
    const int64_t nr = R - k + 1;
    if (nr <= 0 || pos.empty()) return;
    // read k-mers hitting unique template k-mers, in rpos order
    // (thread_local: fresh per-read vector allocations were ~25% of the
    // whole pileup call — capacity persists across calls)
    thread_local std::vector<int64_t> rpos, tpos;
    rpos.clear();
    tpos.clear();
    {
        uint64_t code = 0;
        const uint64_t mask = (k >= 32) ? ~uint64_t(0)
                                        : ((uint64_t(1) << (2 * k)) - 1);
        int64_t bad = 0;
        for (int64_t i = 0; i < R; ++i) {
            const int8_t b = read[i];
            code = ((code << 2) | uint64_t(b < 0 ? 0 : (b & 3))) & mask;
            if (b < 0) bad = k;
            else if (bad > 0) --bad;
            if (i >= k - 1 && bad == 0) {
                const int64_t v = pos.find(code);
                if (v >= 0) {
                    rpos.push_back(i - k + 1);
                    tpos.push_back(v);
                }
            }
        }
    }
    const int64_t n = int64_t(rpos.size());
    if (n == 0) return;
    // patience LIS on tpos (strictly increasing), identical tie handling to
    // the Python bisect_left formulation
    thread_local std::vector<int64_t> tails, tails_idx, parent;
    tails.clear();
    tails_idx.clear();
    parent.assign(size_t(n), -1);
    for (int64_t a = 0; a < n; ++a) {
        const int64_t t = tpos[a];
        const int64_t h = std::lower_bound(tails.begin(), tails.end(), t)
                          - tails.begin();
        if (h == int64_t(tails.size())) {
            tails.push_back(t);
            tails_idx.push_back(a);
        } else {
            tails[h] = t;
            tails_idx[h] = a;
        }
        parent[a] = (h > 0) ? tails_idx[h - 1] : -1;
    }
    for (int64_t a = tails_idx.back(); a >= 0; a = parent[a])
        chain->emplace_back(rpos[a], tpos[a]);
    std::reverse(chain->begin(), chain->end());
}

void anchor_chain_core(const int8_t* read, int64_t R,
                       const int8_t* tpl, int64_t T, int64_t k,
                       std::vector<std::pair<int64_t, int64_t>>* chain) {
    FlatKmerIndex pos;
    build_kmer_index(tpl, T, k, &pos);
    chain_with_index(read, R, pos, k, chain);
}

// Band centers for each read row, interpolated from the anchor chain —
// exact port of guided_align's np.interp(+np.round half-even) path.
void centers_from_chain(const std::vector<std::pair<int64_t, int64_t>>& chain,
                        int64_t R, int64_t T, std::vector<int64_t>* centers) {
    const int64_t m = int64_t(chain.size()) + 2;
    thread_local std::vector<double> rp, tp;
    rp.assign(size_t(m), 0.0);
    tp.assign(size_t(m), 0.0);
    rp[0] = 0.0;
    tp[0] = 0.0;
    for (size_t a = 0; a < chain.size(); ++a) {
        rp[a + 1] = double(chain[a].first);
        tp[a + 1] = double(chain[a].second);
    }
    rp[m - 1] = double(R);
    tp[m - 1] = double(T);
    for (int64_t a = 1; a < m; ++a) {   // np.maximum.accumulate
        if (rp[a] < rp[a - 1]) rp[a] = rp[a - 1];
        if (tp[a] < tp[a - 1]) tp[a] = tp[a - 1];
    }
    centers->assign(R + 1, 0);
    // np.interp semantics: for query x, the segment is [i, i+1] with
    // i = upper_bound(rp, x) - 1 (x == a duplicated knot -> LAST duplicate)
    int64_t i = 0;
    for (int64_t x = 0; x <= R; ++x) {
        while (i + 1 < m && rp[i + 1] <= double(x)) ++i;
        double v;
        if (i >= m - 1) v = tp[m - 1];
        else if (double(x) <= rp[0]) v = tp[0];
        else {
            const double dx = rp[i + 1] - rp[i];
            v = (dx <= 0.0) ? tp[i]
                            : tp[i] + (double(x) - rp[i]) / dx * (tp[i + 1] - tp[i]);
        }
        (*centers)[x] = int64_t(std::nearbyint(v));  // np.round = half-even
    }
}

// Python band_width_for: int(base + frac*max(R,T)) + |R-T|
int64_t band_width_for(int64_t R, int64_t T) {
    const int64_t mx = R > T ? R : T;
    return int64_t(24.0 + 0.18 * double(mx)) + (R > T ? R - T : T - R);
}

// Rescaled-diagonal centers: np.round(arange(R+1) * (T/R)) — half-even.
void diag_centers(int64_t R, int64_t T, std::vector<int64_t>* centers) {
    centers->assign(R + 1, 0);
    const double s = double(T) / double(R);
    for (int64_t i = 0; i <= R; ++i)
        (*centers)[i] = int64_t(std::nearbyint(double(i) * s));
}

// Python affine_align's centers post-processing for explicit centers:
// clip to [0, T], maximum.accumulate, pin endpoints.
void sanitize_centers(std::vector<int64_t>* centers, int64_t T) {
    int64_t prev = 0;
    for (auto& c : *centers) {
        if (c < 0) c = 0;
        if (c > T) c = T;
        if (c < prev) c = prev;
        prev = c;
    }
    (*centers)[0] = 0;
    centers->back() = T;
}

// guided_align (affine flavor): anchor-chain banding with fallback widening.
// Returns false if no alignment fits any band.
bool guided_affine_idx(const int8_t* read, int64_t R,
                       const int8_t* tpl, int64_t T,
                       const FlatKmerIndex* idx,
                       int64_t k, int64_t band,
                       int64_t sub_cost, int64_t gap_open, int64_t gap_ext,
                       std::vector<int8_t>* ops_buf, int64_t* ops_len,
                       int64_t* n_match, int64_t* score,
                       int64_t* rpos_at = nullptr) {
    ops_buf->resize(size_t(R + T + 2));
    if (R == 0 || T == 0) {
        // degenerate alignments (match Python affine_align's R==0/T==0)
        *ops_len = 0;
        *n_match = 0;
        if (R == 0) {
            for (int64_t j = 0; j < T; ++j) (*ops_buf)[(*ops_len)++] = M_LEFT;
            *score = T ? gap_open + T * gap_ext : 0;
            if (rpos_at) for (int64_t j = 0; j <= T; ++j) rpos_at[j] = 0;
        } else {
            for (int64_t i = 0; i < R; ++i) (*ops_buf)[(*ops_len)++] = M_UP;
            *score = gap_open + R * gap_ext;
            if (rpos_at) rpos_at[0] = 0;
        }
        return true;
    }
    thread_local std::vector<std::pair<int64_t, int64_t>> chain;
    chain.clear();
    if (idx != nullptr) chain_with_index(read, R, *idx, k, &chain);
    else anchor_chain_core(read, R, tpl, T, k, &chain);
    thread_local std::vector<int64_t> centers;
    if (int64_t(chain.size()) >= 3) {
        centers_from_chain(chain, R, T, &centers);
        sanitize_centers(&centers, T);
        for (int64_t w : {band, band * 2}) {
            const int64_t W = w < T ? w : T;
            *score = affine_core(read, R, tpl, T, centers.data(), W, sub_cost,
                                 gap_open, gap_ext, rpos_at, ops_buf->data(),
                                 ops_len, n_match);
            if (*score >= 0) return true;
        }
    }
    diag_centers(R, T, &centers);
    int64_t w = band_width_for(R, T);
    const int64_t limit = R > T ? R : T;
    for (;;) {
        const int64_t W = w < T ? w : T;
        *score = affine_core(read, R, tpl, T, centers.data(), W, sub_cost,
                             gap_open, gap_ext, rpos_at, ops_buf->data(),
                             ops_len, n_match);
        if (*score >= 0) return true;
        if (w >= limit) return false;
        w = w * 2 < limit ? w * 2 : limit;
    }
}

bool guided_affine(const int8_t* read, int64_t R,
                   const int8_t* tpl, int64_t T,
                   int64_t k, int64_t band,
                   int64_t sub_cost, int64_t gap_open, int64_t gap_ext,
                   std::vector<int8_t>* ops_buf, int64_t* ops_len,
                   int64_t* n_match, int64_t* score) {
    return guided_affine_idx(read, R, tpl, T, nullptr, k, band, sub_cost,
                             gap_open, gap_ext, ops_buf, ops_len, n_match,
                             score);
}

}  // namespace

extern "C" {

// Banded global alignment with AFFINE gap costs (Gotoh 3-matrix DP) —
// exact port of ccs_tpu_torch.ops.align.affine_align's NumPy formulation (same
// band framing, prefix-min deletion chain, tie-breaking and traceback).
// The KSW2-equivalent host aligner (how-does-ccs-work.md:53-55).
//
// Returns the alignment cost, or -1 if the optimal path escapes the band.
int64_t ccs_affine_align(const int8_t* read, int64_t R,
                         const int8_t* tpl, int64_t T,
                         const int64_t* centers, int64_t W,
                         int64_t sub_cost, int64_t gap_open, int64_t gap_ext,
                         int64_t* rpos_at,
                         int8_t* ops_rev, int64_t* ops_len,
                         int64_t* n_match) {
    return affine_core(read, R, tpl, T, centers, W, sub_cost, gap_open,
                       gap_ext, rpos_at, ops_rev, ops_len, n_match);
}

// Monotone chain of unique-k-mer anchors; out_rt is [cap][2] row-major
// (rpos, tpos). Returns the chain length (clamped to cap).
int64_t ccs_anchor_chain(const int8_t* read, int64_t R,
                         const int8_t* tpl, int64_t T,
                         int64_t k, int64_t* out_rt, int64_t cap) {
    std::vector<std::pair<int64_t, int64_t>> chain;
    anchor_chain_core(read, R, tpl, T, k, &chain);
    const int64_t n = int64_t(chain.size()) < cap ? int64_t(chain.size()) : cap;
    for (int64_t a = 0; a < n; ++a) {
        out_rt[2 * a] = chain[a].first;
        out_rt[2 * a + 1] = chain[a].second;
    }
    return n;
}

// Whole-pileup draft round (port of pipeline.draft._pileup_consensus): for
// each read, anchor-chain-guided affine alignment to tpl, then weighted
// votes (substitution / deletion / insertion-variant) and weighted-majority
// consensus emission. One native call replaces the per-read per-cigar-op
// Python loop that dominated round-2 host time.
//
//   reads_flat/offs[n+1]   concatenated oriented reads
//   out_mapped[n]          1 if the read aligned with identity >= min_identity
//   out_ident[n]           alignment identity per read (0 if unaligned);
//                          the draft cascade uses the mapped mean to detect
//                          chimeric backbones
//   out_draft/out_cap      consensus buffer; returns -2 if it would overflow
// Returns n_mapped (>= 0), or -2 on buffer overflow (caller falls back).
int64_t ccs_pileup_draft(const int8_t* tpl, int64_t T,
                         const int8_t* reads_flat, const int64_t* offs,
                         int64_t n_reads,
                         int64_t k, int64_t band,
                         int64_t sub_cost, int64_t gap_open, int64_t gap_ext,
                         double min_identity,
                         int8_t* out_draft, int64_t out_cap, int64_t* out_len,
                         uint8_t* out_mapped, double* out_ident,
                         double* out_weak, float* out_stats,
                         int64_t* out_rpos, int32_t* out_src) {
    std::vector<int32_t> sub_votes(size_t(T) * 4, 0);
    std::vector<int32_t> del_votes(size_t(T), 0), cov(size_t(T), 0);
    // insertion variants per junction: a flat per-junction chain (head
    // index into a node pool) instead of an unordered_map — the emit loop
    // touches every junction and per-position map lookups were ~1 ms of a
    // ~5 ms pileup call. Chain order = first-inserted order, so count ties
    // resolve like Counter.most_common.
    struct InsVar { int32_t next, count, off, len; };
    std::vector<int32_t> ins_head(size_t(T) + 1, -1);
    std::vector<InsVar> ins_pool;
    std::vector<int8_t> ins_chars;
    std::vector<int8_t> pending;
    std::vector<int8_t> ops_buf;
    int64_t n_mapped = 0;
    FlatKmerIndex idx;                 // one template index for all reads
    build_kmer_index(tpl, T, k, &idx);

    for (int64_t r = 0; r < n_reads; ++r) {
        const int8_t* read = reads_flat + offs[r];
        const int64_t R = offs[r + 1] - offs[r];
        int64_t ops_len = 0, n_match = 0, score = 0;
        out_mapped[r] = 0;
        out_ident[r] = 0.0;
        if (!guided_affine_idx(read, R, tpl, T, &idx, k, band, sub_cost,
                               gap_open, gap_ext, &ops_buf, &ops_len,
                               &n_match, &score,
                               out_rpos ? out_rpos + r * (T + 1) : nullptr))
            continue;
        const int64_t total = ops_len > 0 ? ops_len : 1;
        const double ident = double(n_match) / double(total);
        out_ident[r] = ident;
        if (ident < min_identity) continue;
        out_mapped[r] = 1;
        ++n_mapped;
        // walk ops start-first (ops_buf is end-first), accumulating votes
        int64_t i = 0, j = 0;
        auto flush = [&](int64_t at) {
            if (pending.empty()) return;
            const int32_t plen = int32_t(pending.size());
            int32_t* slot = &ins_head[at];
            while (*slot >= 0) {
                InsVar& v = ins_pool[*slot];
                if (v.len == plen &&
                    std::memcmp(ins_chars.data() + v.off, pending.data(),
                                size_t(plen)) == 0) {
                    ++v.count;
                    pending.clear();
                    return;
                }
                slot = &v.next;
            }
            *slot = int32_t(ins_pool.size());
            ins_pool.push_back({-1, 1, int32_t(ins_chars.size()), plen});
            ins_chars.insert(ins_chars.end(), pending.begin(), pending.end());
            pending.clear();
        };
        for (int64_t o = ops_len - 1; o >= 0; --o) {
            const int8_t op = ops_buf[o];
            if (op == M_DIAG) {
                if (!pending.empty()) flush(j);
                ++sub_votes[j * 4 + (read[i] & 3)];
                ++cov[j];
                ++i; ++j;
            } else if (op == M_LEFT) {  // D: template consumed, no read base
                if (!pending.empty()) flush(j);
                ++del_votes[j];
                ++cov[j];
                ++j;
            } else {                    // I: extra read base
                pending.push_back(int8_t(read[i] & 3));
                ++i;
            }
        }
        if (!pending.empty()) flush(j);
    }
    if (n_mapped == 0) { *out_len = 0; *out_weak = 1.0; return 0; }

    // chimera signal for the draft cascade: fraction of template positions
    // whose pileup is weak (majority base fails to clear half the local
    // coverage, or no coverage at all) — a chimeric backbone scatters every
    // read's votes across its junk half
    {
        int64_t weak = 0;
        for (int64_t j = 0; j < T; ++j) {
            int32_t bc = 0;
            for (int64_t b = 0; b < 4; ++b)
                if (sub_votes[j * 4 + b] > bc) bc = sub_votes[j * 4 + b];
            if (cov[j] <= 0 || 2 * bc <= cov[j]) ++weak;
        }
        *out_weak = T > 0 ? double(weak) / double(T) : 1.0;
    }

    // emit weighted-majority consensus (exact Python semantics). When
    // out_stats != nullptr, also record per EMITTED draft position the
    // pileup evidence the candidate filter (C7, performance.md:90-93)
    // needs: [cov, agree, indel] where agree = votes for the emitted base
    // and indel = deletion votes here + total insertion vote mass at the
    // flanking junctions (evidence of a possibly-missing base nearby).
    auto ins_mass = [&](int64_t j) -> int32_t {
        int32_t m = 0;
        for (int32_t h = ins_head[j]; h >= 0; h = ins_pool[h].next)
            m += ins_pool[h].count;
        return m;
    };
    int64_t n = 0;
    int64_t src_j = 0;  // round-template position the emit loop is at
    auto emit = [&](int8_t b, int32_t cv, int32_t agree,
                    int32_t indel) -> bool {
        if (n >= out_cap) return false;
        if (out_stats != nullptr) {
            out_stats[3 * n + 0] = float(cv);
            out_stats[3 * n + 1] = float(agree);
            out_stats[3 * n + 2] = float(indel);
        }
        if (out_src != nullptr)
            out_src[n] = int32_t(src_j <= T ? src_j : T);
        out_draft[n++] = b;
        return true;
    };
    for (int64_t j = 0; j <= T; ++j) {
        src_j = j;
        if (ins_head[j] >= 0) {
            const InsVar* best = nullptr;
            for (int32_t h = ins_head[j]; h >= 0; h = ins_pool[h].next)
                if (!best || ins_pool[h].count > best->count)
                    best = &ins_pool[h];
            const int32_t covj = (j < T) ? cov[j] : (T ? cov[T - 1] : 1);
            // cnt > max(covj, 1)/2.0 with integer counts == 2*cnt > max(..)
            if (2 * best->count > (covj > 1 ? covj : 1))
                for (int32_t c = 0; c < best->len; ++c)
                    if (!emit(ins_chars[best->off + c], covj, best->count,
                              covj - best->count))
                        return -2;
        }
        if (j == T) break;
        // best base: argmax over 4 (first max wins, like np.argmax)
        int64_t bb = 0;
        int32_t bc = sub_votes[j * 4];
        for (int64_t b = 1; b < 4; ++b)
            if (sub_votes[j * 4 + b] > bc) { bc = sub_votes[j * 4 + b]; bb = b; }
        if (del_votes[j] > bc) continue;
        const int32_t indel = del_votes[j] + ins_mass(j) + ins_mass(j + 1);
        if (cov[j] > 0) {
            if (!emit(int8_t(bb), cov[j], bc, indel)) return -2;
        } else {
            if (!emit(tpl[j], 0, 0, indel)) return -2;
        }
    }
    *out_len = n;
    return n_mapped;
}

// Sliding DUST triplet score profile (component C13): score[s] =
// sum_t C(c_t, 2) / (w_trip - 1) over the w_trip triplets starting at s.
// Incremental window update (exact integer pair counts) — the NumPy
// difference-array formulation runs one vectorized pass per lag (~60
// passes over the draft) and was ~1.4 ms per 2 kb ZMW of host prepare.
// seq: int8 codes (negatives clipped to 0, matching the oracle).
int64_t ccs_dust_profile(const int8_t* seq, int64_t n_seq, int64_t window,
                         double* out_scores) {
    const int64_t n = n_seq - 2;           // triplet count
    if (n <= 0) return 0;
    thread_local std::vector<int32_t> trip_s;
    trip_s.resize(size_t(n));
    int32_t* trip = trip_s.data();
    auto code = [&](int64_t i) -> int32_t {
        int32_t b = seq[i];
        return b < 0 ? 0 : (b > 3 ? 3 : b);
    };
    for (int64_t i = 0; i < n; ++i)
        trip[i] = code(i) * 16 + code(i + 1) * 4 + code(i + 2);
    const int64_t w = window - 2 < n ? window - 2 : n;  // triplets/window
    int32_t cnt[64] = {0};
    int64_t pairs = 0;
    for (int64_t i = 0; i < w; ++i) pairs += cnt[trip[i]]++;
    const int64_t n_out = n - w + 1;
    const double denom = double(w - 1 > 1 ? w - 1 : 1);
    out_scores[0] = double(pairs) / denom;
    for (int64_t s = 1; s < n_out; ++s) {
        pairs -= --cnt[trip[s - 1]];
        pairs += cnt[trip[s + w - 1]]++;
        out_scores[s] = double(pairs) / denom;
    }
    return n_out;
}

// Anchor-guided affine alignment identity (the draft-acceptance check for
// reads beyond the vote set). Returns n_match/ops_len, or -1.0 if the read
// does not align within any band.
// Batched orientation + anchor chaining for one ZMW: the template k-mer
// index is built ONCE and shared by every read (per-call index rebuilds
// dominated the host anchor profile). For each read, chain both
// orientations; the longer chain wins (fwd on ties — same rule as
// ops.align.infer_orientation). out_strand[r] in {0 fwd, 1 rev};
// out_chain rows (rpos, tpos) are in the WINNING orientation's read
// coordinates, packed back-to-back per read at offs[r]*2 with per-read
// capacity R_r rows; out_nchain[r] = rows written.
int64_t ccs_orient_chain_batch(const int8_t* tpl, int64_t T,
                               const int8_t* reads_flat, const int64_t* offs,
                               int64_t n_reads, int64_t k,
                               uint8_t* out_strand,
                               int64_t* out_chain, int64_t* out_nchain) {
    FlatKmerIndex pos;
    build_kmer_index(tpl, T, k, &pos);
    std::vector<std::pair<int64_t, int64_t>> cf, cr;
    std::vector<int8_t> rc;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int8_t* read = reads_flat + offs[r];
        const int64_t R = offs[r + 1] - offs[r];
        chain_with_index(read, R, pos, k, &cf);
        rc.resize(size_t(R));
        for (int64_t i = 0; i < R; ++i) {
            const int8_t b = read[R - 1 - i];
            rc[i] = b < 0 ? b : int8_t(3 - b);
        }
        chain_with_index(rc.data(), R, pos, k, &cr);
        const bool rev = int64_t(cr.size()) > int64_t(cf.size());
        out_strand[r] = rev ? 1 : 0;
        const auto& chain = rev ? cr : cf;
        int64_t* out = out_chain + offs[r] * 2;
        const int64_t n = int64_t(chain.size()) < R ? int64_t(chain.size())
                                                    : R;
        for (int64_t a = 0; a < n; ++a) {
            out[2 * a] = chain[a].first;
            out[2 * a + 1] = chain[a].second;
        }
        out_nchain[r] = n;
    }
    return n_reads;
}

// Batched chaining of already-oriented reads against one template (the
// stage-3 subread->draft mapping); same packing as ccs_orient_chain_batch.
int64_t ccs_chain_batch(const int8_t* tpl, int64_t T,
                        const int8_t* reads_flat, const int64_t* offs,
                        int64_t n_reads, int64_t k,
                        int64_t* out_chain, int64_t* out_nchain) {
    FlatKmerIndex pos;
    build_kmer_index(tpl, T, k, &pos);
    std::vector<std::pair<int64_t, int64_t>> chain;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int8_t* read = reads_flat + offs[r];
        const int64_t R = offs[r + 1] - offs[r];
        chain_with_index(read, R, pos, k, &chain);
        int64_t* out = out_chain + offs[r] * 2;
        const int64_t n = int64_t(chain.size()) < R ? int64_t(chain.size())
                                                    : R;
        for (int64_t a = 0; a < n; ++a) {
            out[2 * a] = chain[a].first;
            out[2 * a + 1] = chain[a].second;
        }
        out_nchain[r] = n;
    }
    return n_reads;
}

double ccs_guided_identity(const int8_t* read, int64_t R,
                           const int8_t* tpl, int64_t T,
                           int64_t k, int64_t band,
                           int64_t sub_cost, int64_t gap_open,
                           int64_t gap_ext) {
    std::vector<int8_t> ops_buf;
    int64_t ops_len = 0, n_match = 0, score = 0;
    if (!guided_affine(read, R, tpl, T, k, band, sub_cost, gap_open, gap_ext,
                       &ops_buf, &ops_len, &n_match, &score))
        return -1.0;
    return double(n_match) / double(ops_len > 0 ? ops_len : 1);
}

}  // extern "C"
