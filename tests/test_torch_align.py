"""The port's banded edit distance (ccs_tpu_torch.ops.align_banded) against
the JAX package's (ccs_tpu.ops.align_pallas): the plain version on CPU
tensors against the Pallas kernel in interpret mode on the same arrays,
both oracles against each other, and (on a machine with a CUDA device) the
CUDA kernel against the plain version.

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


@pytest.mark.cuda
@pytest.mark.parametrize("band", [0, 1, 15, 16, 24, 56, 64, 127])
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
