"""The port's banded edit distance (ccs_tpu_torch.ops.align_banded) against
the JAX package's (ccs_tpu.ops.align_pallas): the plain version on CPU
tensors against the Pallas kernel in interpret mode on the same arrays,
both oracles against each other, a numpy emulation of the CUDA kernel's
bit-vector row step (its 32-bit words, carry chain, funnel shifts, bit planes
and loads, as csrc/edit_banded.cu writes them) against the plain version
and, on the emulation's pair sets, against the Pallas kernel as well, and
(on a machine with a CUDA device) the CUDA kernel against the plain version.

Bar: exact equality. Every in-band distance is an integer both sides hold
exactly; values >= BIG/2 all mean "left the band" and are mapped to BIG on
both sides before comparing."""

import numpy as np
import pytest
import torch

from ccs_tpu.ops import align_pallas as aj
from ccs_tpu_torch.ops import align_banded as at

# The suite runs several pytest workers on a few cores; torch's intra-op
# threads on these small tensors only contend with them.
torch.set_num_threads(1)


def _pairs(rng, n, tmax, rmax, err=0.12, tmin=8):
    """(read, template) pairs with SMRT-like errors, -1 padded (the recipe
    of the JAX package's own test of its kernel)."""
    tpl = np.full((n, tmax), -1, np.int8)
    tlen = np.zeros(n, np.int32)
    reads = np.full((n, rmax), -1, np.int8)
    rlens = np.zeros(n, np.int32)
    for b in range(n):
        T = int(rng.integers(tmin, tmax + 1))
        t = rng.integers(0, 4, T).astype(np.int8)
        r = []
        for j in range(T):
            u = rng.random()
            if u < err / 3:
                continue                       # deletion
            r.append(int(t[j]) if u > err else int(rng.integers(0, 4)))
            if rng.random() < err / 3:
                r.append(int(rng.integers(0, 4)))
        r = np.asarray(r[:rmax], np.int8)
        tpl[b, :T] = t
        tlen[b] = T
        reads[b, :len(r)] = r
        rlens[b] = len(r)
    return tpl, tlen, reads, rlens


def _clip(d):
    d = np.asarray(d, np.float32)
    return np.where(d >= at.BIG / 2, np.float32(at.BIG), d)


def _torch(arrs, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrs)


def _long_reads(rng):
    """Reads longer than their templates: templates cut after the reads
    were drawn, one of them by more than the band."""
    tpl, tlen, reads, rlens = _pairs(rng, 6, 40, 52)
    cut = np.minimum(tlen - 1, np.array([3, 7, 10, 30, 0, 12]))
    tlen = (tlen - cut).astype(np.int32)
    for b in range(6):
        tpl[b, tlen[b]:] = -1
    tmax = int(tlen.max())          # RMAX > TMAX as well
    return np.ascontiguousarray(tpl[:, :tmax]), tlen, reads, rlens


def _band_exceeded(_rng):
    return (np.zeros((1, 40), np.int8), np.asarray([40], np.int32),
            np.zeros((1, 8), np.int8), np.asarray([4], np.int32))


def _empty_read(_rng):
    return (np.zeros((1, 12), np.int8), np.asarray([12], np.int32),
            np.full((1, 4), -1, np.int8), np.asarray([0], np.int32))


CASES = {
    # name: (seed, pairs, band, all in band and equal to the dense oracle)
    "full_band": (0, lambda rng: _pairs(rng, 10, 40, 52), 56, True),
    "moderate_band": (1, lambda rng: _pairs(rng, 8, 60, 80), 24, True),
    "band_exceeded": (2, _band_exceeded, 16, False),
    "empty_read": (3, _empty_read, 16, True),
    "reads_longer_than_template": (4, _long_reads, 16, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name):
    seed, build, band, exact = CASES[name]
    arrs = build(np.random.default_rng(seed))
    tpl, tlen, reads, rlens = arrs
    ref = _clip(aj.edit_distance_banded(*arrs, band=band, interpret=True))
    got = at.edit_distance_banded(*_torch(arrs), band=band)
    assert got.dtype == torch.float32 and got.shape == (len(tlen),)
    np.testing.assert_array_equal(_clip(got.numpy()), ref)
    if exact:
        want = [at.edit_distance_dense_oracle(reads[b, :rlens[b]],
                                              tpl[b, :tlen[b]])
                for b in range(len(tlen))]
        np.testing.assert_array_equal(got.numpy(), np.float32(want))
    if name == "band_exceeded":
        assert got[0] >= at.BIG / 2
    if name == "empty_read":
        assert got[0] == 12.0
    if name == "reads_longer_than_template":
        big = np.abs(tlen - rlens) > band
        assert big.any() and not big.all()
        np.testing.assert_array_equal(_clip(got.numpy()) == at.BIG, big)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracles_agree(seed):
    """The port's row-vectorised oracle against the JAX package's scalar
    one, and the plain version at a band that covers every cell."""
    rng = np.random.default_rng(seed)
    arrs = _pairs(rng, 6, 30, 40, err=0.3, tmin=1)
    tpl, tlen, reads, rlens = arrs
    got = at.edit_distance_banded_plain(*_torch(arrs), band=40).numpy()
    for b in range(6):
        r, t = reads[b, :rlens[b]], tpl[b, :tlen[b]]
        want = aj.edit_distance_dense_oracle(r, t)
        assert at.edit_distance_dense_oracle(r, t) == want
        assert got[b] == want
    assert at.edit_distance_dense_oracle(reads[0, :0], tpl[0, :5]) == 5
    assert at.edit_distance_dense_oracle(reads[0, :3], tpl[0, :0]) == 3


def test_band_64_at_2kb_matches_dense_oracle():
    """The production case: 2 kb pairs at SMRT-like error rates stay inside
    band 64, so the banded distance is the dense one."""
    rng = np.random.default_rng(5)
    arrs = _pairs(rng, 3, 2000, 2300, tmin=1900)
    tpl, tlen, reads, rlens = arrs
    got = at.edit_distance_banded(*_torch(arrs), band=64).numpy()
    for b in range(3):
        want = at.edit_distance_dense_oracle(reads[b, :rlens[b]],
                                             tpl[b, :tlen[b]])
        assert got[b] == want and want < at.BIG / 2


def test_plain_accepts_empty_batch():
    arrs = (np.zeros((0, 5), np.int8), np.zeros(0, np.int32),
            np.zeros((0, 4), np.int8), np.zeros(0, np.int32))
    assert at.edit_distance_banded(*_torch(arrs)).shape == (0,)


def test_wrapper_never_falls_back_off_cpu():
    """Only CPU tensors take the plain version: any other device goes to
    the kernel launcher, which raises where it cannot launch."""
    arrs = _pairs(np.random.default_rng(6), 2, 12, 16)
    meta = tuple(torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                             device="meta") for a in arrs)
    launches = at.edit_distance_banded.launches
    with pytest.raises(RuntimeError, match="cannot run on meta"):
        at.edit_distance_banded(*meta)
    with pytest.raises(RuntimeError, match="cannot run on cpu"):
        at._launch(*_torch(arrs), 64)
    at.edit_distance_banded(*_torch(arrs))
    assert at.edit_distance_banded.launches == launches


# --- the CUDA kernel's arithmetic, emulated ---------------------------------
# One numpy lane per pair stands for one thread of csrc/edit_banded.cu; every
# helper below is the device function of the same name.

_U = np.uint32
_M32 = np.uint64(0xFFFFFFFF)


def _wide(lo, hi):
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _funnelshift_r(lo, hi, s):
    """Low word of (hi:lo) >> (s & 31); s a number or one per lane."""
    s = np.asarray(s).astype(np.uint64) & np.uint64(31)
    return ((_wide(lo, hi) >> s) & _M32).astype(np.uint32)


def _funnelshift_l(lo, hi, s):
    """High word of (hi:lo) << (s & 31)."""
    s = np.uint64(s & 31)
    return (((_wide(lo, hi) << s) >> np.uint64(32)) & _M32).astype(np.uint32)


def _low_mask(c):
    c = np.clip(np.asarray(c, np.int64), 0, 32).astype(np.uint64)
    return ((np.uint64(1) << c) - np.uint64(1)).astype(np.uint32)


def _range_mask(base, n):
    return _low_mask(np.asarray(n, np.int64) - base) & ~_low_mask(-base)


def _fetch(rows, n, off, addr0):
    """Nine aligned 32-bit words that cover bytes off..off+31 of each lane's
    row, bytes outside [0, n) read as 0, and the bit offset of the first
    wanted byte. ``addr0`` is the address of the array's first byte."""
    B, width = rows.shape
    lane = np.arange(B)
    mis = (addr0 + lane.astype(np.int64) * width + off) & 3
    raw = []
    for k in range(9):
        w = np.zeros(B, np.uint32)
        for b in range(4):
            idx = off - mis + 4 * k + b
            byte = rows[lane, np.clip(idx, 0, width - 1)].astype(np.uint8)
            ok = (idx >= 0) & (idx < n)
            w |= np.where(ok, byte, 0).astype(np.uint32) << _U(8 * b)
        raw.append(w)
    return raw, 8 * mis


def _planes(fetched):
    raw, shift = fetched
    lo = np.zeros_like(raw[0])
    hi, pad = lo.copy(), lo.copy()
    for g in range(7, -1, -1):
        x = _funnelshift_r(raw[g], raw[g + 1], shift)
        lo = _funnelshift_l((x & _U(0x01010101)) * _U(0x10204080), lo, 4)
        hi = _funnelshift_l((x & _U(0x02020202)) * _U(0x08102040), hi, 4)
        nb = (((x & _U(0x7C7C7C7C)) + _U(0x7C7C7C7C)) | x) & _U(0x80808080)
        pad = _funnelshift_l(nb * _U(0x00204081), pad, 4)
    return lo, hi, pad


def _sign_mask(word):
    """The top bit of each lane's word, spread over the whole word."""
    return (word.astype(np.int32) >> 31).astype(np.uint32)


def _brev(x):
    return np.array([int(f"{int(v):032b}"[::-1], 2) for v in x], np.uint32)


def _popc(x):
    return np.array([bin(int(v)).count("1") for v in x], np.int64)


def _emulate_kernel(tpl, tlen, reads, rlens, band, addr_t=0, addr_r=0):
    """edit_kernel<NW> of csrc/edit_banded.cu on numpy lanes. Lanes whose
    reads have ended keep their state, as threads that left their loop."""
    B, TMAX = tpl.shape
    RMAX = reads.shape[1]
    W = band
    NW = 1 if W == 0 else (2 * W + 31) // 32
    tl, rl = tlen.astype(np.int64), rlens.astype(np.int64)
    tn, rn = np.minimum(tl, TMAX), np.minimum(rl, RMAX)
    k_end = tl - rl + W
    in_band = (k_end >= 0) & (k_end <= 2 * W)
    zero = np.zeros(B, np.uint32)
    L, H, V = [zero] * (NW + 1), [zero] * (NW + 1), [zero] * (NW + 1)
    for w in range(NW + 1):                 # the first words come in one by one
        lo, hi, pad = _planes(_fetch(tpl, tn, 32 * w - W, addr_t))
        L, H = L[1:] + [lo], H[1:] + [hi]
        V = V[1:] + [_range_mask(32 * w - W, tn) & ~pad]
    raw_r = _fetch(reads, rn, 0, addr_r)
    mv = [np.full(B, _low_mask(W - 32 * w)) for w in range(NW)]
    pv = [np.full(B, _low_mask(2 * W - 32 * w)) & ~mv[w] for w in range(NW)]
    m_last = _low_mask(2 * W + 1 - 32 * (NW - 1))
    m_top = _low_mask(2 * W + 1 - 32 * NW)
    d0 = np.zeros(B, np.int64)
    n_rows = int(rn[in_band].max()) if in_band.any() else 0
    for r0 in range(0, n_rows, 32):
        lo, hi, pad = _planes(raw_r)
        RL, RH, RB = _brev(lo), _brev(hi), _brev(~pad)
        dw = zero.copy()
        t_next = r0 + 32 * (NW + 1) - W
        raw_t = _fetch(tpl, tn, t_next, addr_t)
        raw_r = _fetch(reads, rn, r0 + 32, addr_r)
        for s in range(32):
            live = in_band & (r0 + s < rn)
            if not live.any():
                break
            rlo, rhi, rb = _sign_mask(RL), _sign_mask(RH), _sign_mask(RB)
            RL, RH, RB = RL << _U(1), RH << _U(1), RB << _U(1)
            e = [~(L[w] ^ rlo) & V[w] & ~(H[w] ^ rhi) for w in range(NW + 1)]
            eq = [_funnelshift_r(e[w], e[w + 1], s) for w in range(NW)]
            eq[NW - 1] = eq[NW - 1] & m_last
            top = (e[NW] >> _U(s)) & m_top & rb
            xv = [(eq[w] & rb) | mv[w] for w in range(NW)]
            carry = np.zeros(B, np.uint64)      # add.cc / addc.cc / addc
            ph, mh = [], []
            for w in range(NW):
                t = (eq[w] & rb & pv[w]).astype(np.uint64) + pv[w] + carry
                carry = t >> np.uint64(32)
                d = ((t & _M32).astype(np.uint32) ^ pv[w]) | xv[w]
                if w == 0:
                    dw = np.where(live, _funnelshift_r(dw, d, 1), dw)
                ph.append(mv[w] | ~(d | pv[w]))
                mh.append(pv[w] & d)
            for w in range(NW):
                xs = _funnelshift_r(xv[w], xv[w + 1] if w + 1 < NW else top, 1)
                pv[w] = np.where(live, mh[w] | ~(xs | ph[w]), pv[w])
                mv[w] = np.where(live, ph[w] & xs, mv[w])
        d0 += _popc(dw)
        L, H, V = L[1:], H[1:], V[1:]
        lo, hi, pad = _planes(raw_t)
        L.append(lo)
        H.append(hi)
        V.append(_range_mask(t_next, tn) & ~pad)
    d = W + rn - d0
    for w in range(NW):
        m = _low_mask(k_end - 32 * w)
        d = d + _popc(pv[w] & m) - _popc(mv[w] & m)
    return np.where(in_band, d, int(at.BIG)).astype(np.float32)


def _unrelated(rng, n, tmax, rmax):
    """Random reads against random templates, lengths from 1 up."""
    tpl = np.full((n, tmax), -1, np.int8)
    reads = np.full((n, rmax), -1, np.int8)
    tlen = rng.integers(1, tmax + 1, n).astype(np.int32)
    rlens = rng.integers(1, rmax + 1, n).astype(np.int32)
    for b in range(n):
        tpl[b, :tlen[b]] = rng.integers(0, 4, tlen[b])
        reads[b, :rlens[b]] = rng.integers(0, 4, rlens[b])
    return tpl, tlen, reads, rlens


def _length_gaps(rng, band):
    """Related pairs cut so that tlen - rlen is -W-1, -W, W, W+1 in turn
    (the last of each side out of band), then W-1 and 0."""
    want = [-band - 1, -band, band, band + 1, band - 1, 0]
    size = 2 * band + 40
    tpl, tlen, reads, rlens = _pairs(rng, len(want), size, size + 24,
                                     tmin=size)
    for b, gap in enumerate(want):
        if tlen[b] - rlens[b] > gap:            # shorten the template
            tlen[b] = max(rlens[b] + gap, 0)
            tpl[b, tlen[b]:] = -1
        else:                                   # shorten the read
            rlens[b] = max(tlen[b] - gap, 0)
            reads[b, rlens[b]:] = -1
    assert [int(t) - int(r) for t, r in zip(tlen, rlens)] == want or band < 2
    return tpl, tlen, reads, rlens


def _zero_length(rng, which):
    arrs = _pairs(rng, 6, 70, 90)
    arrs[which][::2] = 0
    (arrs[0] if which == 1 else arrs[2])[::2] = -1
    return arrs


def _with_pads(rng):
    """Pad codes inside the lengths, on either side: they match nothing."""
    tpl, tlen, reads, rlens = _pairs(rng, 8, 90, 110, tmin=40)
    for b in range(8):
        if b % 2 and rlens[b]:
            reads[b, rng.integers(0, rlens[b], 3)] = -1
        if b % 3 == 0:
            tpl[b, rng.integers(0, tlen[b], 3)] = -1
    return tpl, tlen, reads, rlens


def _other_codes(rng):
    """Codes that are no base inside the lengths: 4..63 and negative ones in
    templates, 64..127 and negative ones in reads. No two of them are equal
    across the sides, so all three implementations must let them match
    nothing, whatever their two low bits."""
    tpl, tlen, reads, rlens = _pairs(rng, 8, 90, 110, tmin=40)
    for b in range(8):
        at_r = rng.integers(0, rlens[b], 6)
        at_t = rng.integers(0, tlen[b], 6)
        reads[b, at_r[:4]] = rng.integers(64, 128, 4)
        tpl[b, at_t[:4]] = rng.integers(4, 64, 4)
        reads[b, at_r[4:]] = rng.integers(-128, 0, 2)
        tpl[b, at_t[4:]] = rng.integers(-128, 0, 2)
    return tpl, tlen, reads, rlens


def _along_edges(rng, band):
    """Alignments that run along the band's outermost diagonals: the whole
    length difference (W, or W - 1) lies before the first matching base, as
    extra template bases in even pairs and extra read bases in odd ones."""
    n, core = 8, 60
    tpl = np.full((n, core + band), -1, np.int8)
    reads = np.full((n, core + band), -1, np.int8)
    tlen, rlens = np.zeros(n, np.int32), np.zeros(n, np.int32)
    for b in range(n):
        body = rng.integers(0, 4, core).astype(np.int8)
        noisy = body.copy()
        noisy[rng.integers(0, core, 3)] = rng.integers(0, 4, 3)
        extra = rng.integers(0, 4, max(band - (b // 2) % 2, 0)).astype(np.int8)
        long_, short = np.concatenate([extra, body]), noisy
        t, r = (long_, short) if b % 2 == 0 else (short, long_)
        tpl[b, :len(t)], tlen[b] = t, len(t)
        reads[b, :len(r)], rlens[b] = r, len(r)
    return tpl, tlen, reads, rlens


def _aliases_along_edges(rng, band):
    """The pairs of _along_edges with every fourth read base and every
    fifth template base replaced by a code that is no base and keeps the
    base's two low bits (64 + base in reads, 4..60 + base in templates): a
    comparison of the low bits alone would go on matching them, in the
    band's outermost cells too."""
    tpl, tlen, reads, rlens = _along_edges(rng, band)
    for b in range(len(tlen)):
        reads[b, b % 4:rlens[b]:4] += 64
        tpl[b, b % 5:tlen[b]:5] += 4 * rng.integers(1, 16)
    return tpl, tlen, reads, rlens


EMULATION_BANDS = [0, 1, 15, 16, 31, 32, 47, 48, 64, 127]
PAIR_SETS = {
    "related": lambda rng, band: _pairs(rng, 12, 150, 180, tmin=1),
    "unrelated": lambda rng, band: _unrelated(rng, 12, 90, 100),
    "empty_reads": lambda rng, band: _zero_length(rng, 3),
    "empty_templates": lambda rng, band: _zero_length(rng, 1),
    "length_gaps": _length_gaps,
    "along_band_edges": _along_edges,
    "reads_longer_than_template": lambda rng, band: _long_reads(rng),
    "pads_inside": lambda rng, band: _with_pads(rng),
    "codes_outside_bases": lambda rng, band: _other_codes(rng),
    "codes_outside_bases_along_edges": _aliases_along_edges,
}


@pytest.mark.parametrize("pairs", sorted(PAIR_SETS))
@pytest.mark.parametrize("band", EMULATION_BANDS)
def test_kernel_emulation_matches_plain(band, pairs):
    """The kernel's row step, emulated, is the plain version's recurrence:
    bands on both sides of every word boundary, rows at every byte
    alignment."""
    rng = np.random.default_rng(1000 * band + len(pairs))
    arrs = PAIR_SETS[pairs](rng, band)
    ref = _clip(at.edit_distance_banded_plain(*_torch(arrs), band=band))
    for addr_t, addr_r in ((0, 0), (1, 3), (2, 1)):
        got = _emulate_kernel(*arrs, band, addr_t, addr_r)
        np.testing.assert_array_equal(_clip(got), ref)
    if pairs == "length_gaps" and band >= 2:
        np.testing.assert_array_equal(
            ref == at.BIG, [True, False, False, True, False, False])


@pytest.mark.parametrize("pairs", sorted(PAIR_SETS))
@pytest.mark.parametrize("band", [16, 33, 64])
def test_plain_matches_pallas_interpret_on_pair_sets(band, pairs):
    """The emulation's pair sets through the JAX package's Pallas kernel in
    interpret mode: the plain version, which the emulation and the CUDA
    kernel are held to, equals it on pads inside the lengths, alignments
    along the band's edges and length gaps of W and W + 1."""
    arrs = PAIR_SETS[pairs](np.random.default_rng(band), band)
    ref = _clip(aj.edit_distance_banded(*arrs, band=band, interpret=True))
    got = at.edit_distance_banded_plain(*_torch(arrs), band=band).numpy()
    np.testing.assert_array_equal(_clip(got), ref)
    np.testing.assert_array_equal(_clip(_emulate_kernel(*arrs, band)), ref)


def test_equal_codes_outside_bases_do_not_match():
    """The port's one narrowing of its counterpart: two equal codes above 3
    match there and are two pads here, in the plain version and in the
    kernel's arithmetic alike."""
    same = np.full((1, 6), 5, np.int8)
    n = np.asarray([6], np.int32)
    arrs = (same, n, same.copy(), n.copy())
    assert float(aj.edit_distance_banded(*arrs, band=8, interpret=True)[0]) == 0
    assert at.edit_distance_banded_plain(*_torch(arrs), band=8)[0] == 6
    assert _emulate_kernel(*arrs, 8)[0] == 6


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_emulation_on_cases(name):
    seed, build, band, exact = CASES[name]
    arrs = build(np.random.default_rng(seed))
    tpl, tlen, reads, rlens = arrs
    got = _emulate_kernel(*arrs, band)
    ref = at.edit_distance_banded_plain(*_torch(arrs), band=band).numpy()
    np.testing.assert_array_equal(_clip(got), _clip(ref))
    if exact:
        want = [at.edit_distance_dense_oracle(reads[b, :rlens[b]],
                                              tpl[b, :tlen[b]])
                for b in range(len(tlen))]
        np.testing.assert_array_equal(got, np.float32(want))


def test_kernel_emulation_band_64_at_2kb():
    """2 kb pairs at band 64: the emulated kernel, the plain version and the
    dense oracle agree."""
    arrs = _pairs(np.random.default_rng(7), 3, 2000, 2300, tmin=1900)
    tpl, tlen, reads, rlens = arrs
    got = _emulate_kernel(*arrs, 64, addr_t=1, addr_r=2)
    ref = at.edit_distance_banded_plain(*_torch(arrs), band=64).numpy()
    np.testing.assert_array_equal(got, ref)
    for b in range(3):
        assert got[b] == at.edit_distance_dense_oracle(
            reads[b, :rlens[b]], tpl[b, :tlen[b]])


@pytest.mark.cuda
@pytest.mark.parametrize("band", [0, 1, 15, 16, 24, 31, 32, 47, 48, 56, 64,
                                  95, 96, 127])
def test_kernel_matches_plain(band):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(band)
    arrs = _pairs(rng, 70, 300, 340, tmin=1)
    arrs[3][5] = 0                              # an empty read
    arrs[1][6] = 0                              # an empty template
    args = _torch(arrs, "cuda")
    launches = at.edit_distance_banded.launches
    got = at.edit_distance_banded(*args, band=band)
    torch.cuda.synchronize()
    assert at.edit_distance_banded.launches == launches + 1
    ref = at.edit_distance_banded_plain(*args, band=band)
    np.testing.assert_array_equal(_clip(got.cpu().numpy()),
                                  _clip(ref.cpu().numpy()))
    with pytest.raises(ValueError, match="outside the kernel's range"):
        at.edit_distance_banded(*args, band=128)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [1, 37])
@pytest.mark.parametrize("band", [16, 64])
def test_kernel_batch_sizes(band, n_pairs):
    """A single pair, and a batch that does not fill its last warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arrs = _pairs(np.random.default_rng(n_pairs + band), n_pairs, 301, 343,
                  tmin=200)
    args = _torch(arrs, "cuda")
    got = at.edit_distance_banded(*args, band=band)
    ref = at.edit_distance_banded_plain(*args, band=band)
    assert got.shape == (n_pairs,)
    np.testing.assert_array_equal(_clip(got.cpu().numpy()),
                                  _clip(ref.cpu().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", sorted(PAIR_SETS))
@pytest.mark.parametrize("band", [16, 33, 64])
def test_kernel_and_emulation_on_pair_sets(band, pairs):
    """The emulation's pair sets on the card: the kernel gives what the
    plain version and the numpy emulation give."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arrs = PAIR_SETS[pairs](np.random.default_rng(band), band)
    args = _torch(arrs, "cuda")
    got = _clip(at.edit_distance_banded(*args, band=band).cpu().numpy())
    ref = at.edit_distance_banded_plain(*args, band=band).cpu().numpy()
    np.testing.assert_array_equal(got, _clip(ref))
    np.testing.assert_array_equal(got, _clip(_emulate_kernel(*arrs, band)))
