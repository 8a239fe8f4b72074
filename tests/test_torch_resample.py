"""The inverse-CDF resampling kernel's wrapper of nerf_tpu_torch against the
JAX kernel.

On the CPU ``fused_sample_pdf`` runs its plain version, ``ops.sampling.
sample_pdf``; here it is held against ``nerf_tpu.ops.pallas.resample.
fused_sample_pdf`` in Pallas interpret mode on the same numpy inputs, to the
JAX package's own tolerances for that kernel (tests/test_pallas_resample.py):
atol 2e-4 in det mode, where the JAX kernel's matmul prefix sum reassociates
against a cumsum and can flip a compare at a CDF knot (the interpolation is
continuous there, so the sample moves by O(ulp * bin width / pdf)). The
stochastic case hands the port JAX's own uniforms as ``u``.

The kernel takes the sum of the weights and the CDF's prefix sum in f64,
each rounded once to f32, and ranks by binary search; tests below emulate
that arithmetic and hold it against ``sample_pdf``: on the CPU, whose
``torch.cumsum`` also accumulates in f64, and against a float32 tree-ordered
scan, as a float32 ``torch.cumsum`` on the card rounds, in CDF space where
the comparison is well conditioned. The kernel's sum and prefix sum are a
warp's: lane sums and a shuffle butterfly, and an f64 Kogge-Stone scan over
the lanes' pairs of terms. An emulation of that order, add for add, is held
bitwise to the serial f64 prefix sum: its partial sums are exact in f64.

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops.pallas.resample import fused_sample_pdf as jax_fused_sample_pdf
from nerf_tpu_torch.kernels.resample import fused_sample_pdf
from nerf_tpu_torch.ops import sample_pdf

torch.set_num_threads(1)


def _inputs(n, m, seed):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2.0, 6.0, (n, m)).astype(np.float32), axis=-1)
    w = rng.uniform(0.0, 1.0, (n, m - 1)).astype(np.float32)
    w[0, :] = 0.0  # an all-zero-weights ray (the floor's path)
    return z, w


@pytest.mark.parametrize("n,m,s", [(64, 32, 64), (100, 63, 128), (7, 16, 8)])
def test_cpu_path_matches_the_jax_kernel_det(n, m, s):
    z, w = _inputs(n, m, seed=n + m + s)
    want = jax_fused_sample_pdf(jnp.asarray(z), jnp.asarray(w), s, det=True, rays_per_tile=32,
                                interpret=True)
    before = fused_sample_pdf.launches
    got = fused_sample_pdf(torch.from_numpy(z), torch.from_numpy(w), s, det=True)
    assert fused_sample_pdf.launches == before   # the CPU never launches the kernel
    assert got.shape == (n, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("n,m,s,seed", [(48, 32, 64, 3), (20, 63, 64, 4)])
def test_cpu_path_matches_the_jax_kernel_stochastic(n, m, s, seed):
    z, w = _inputs(n, m, seed=seed)
    key = jax.random.PRNGKey(seed)
    want = jax_fused_sample_pdf(jnp.asarray(z), jnp.asarray(w), s, key=key, det=False,
                                rays_per_tile=16, interpret=True)
    u = np.array(jax.random.uniform(key, (n, s), dtype=jnp.float32))
    u[1, 0] = 1.0   # the top edge of the CDF
    u[2, 0] = 0.0
    got = fused_sample_pdf(torch.from_numpy(z), torch.from_numpy(w), s, u=torch.from_numpy(u))
    want = np.asarray(want)
    # The two edited uniforms have no JAX counterpart: the top edge gives the
    # last bin edge (up to a guarded last bin), 0 the first.
    np.testing.assert_allclose(got[1, 0].item(), z[1, -1], atol=2e-4)
    assert got[2, 0].item() == z[2, 0]
    keep = np.ones((n, s), bool)
    keep[1, 0] = keep[2, 0] = False
    np.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=1e-5, atol=2e-4)


def test_generator_draws_what_sample_pdf_draws():
    z, w = (torch.from_numpy(a) for a in _inputs(16, 20, seed=5))
    got = fused_sample_pdf(z, w, 33, generator=torch.Generator().manual_seed(7))
    want = sample_pdf(z, w, 33, generator=torch.Generator().manual_seed(7))
    assert torch.equal(got, want)


def _f64_prefix(pdf):
    """The kernel's CDF: prefix sums accumulated in f64, rounded to f32."""
    return torch.cumsum(pdf.double(), -1).float()


def _f64_total(w):
    """The sum of the floored weights (N, K) in f64, rounded to f32: (N, 1)."""
    return w.double().sum(-1, keepdim=True).float()


_LANES = torch.arange(32)


def _lane_pairs(x):
    """(N, K) terms as csrc/resample.cu's lanes hold them: (N, G, 32, 2),
    lane l of 64-term segment g holding terms 64 g + 2 l and 64 g + 2 l + 1,
    0 past the row's end."""
    n, k = x.shape
    segs = -(-k // 64)
    padded = torch.zeros(n, segs * 64, dtype=x.dtype)
    padded[:, :k] = x
    return padded.view(n, segs, 32, 2)


def _shfl_up(x, o, fill):
    """__shfl_up_sync over the last (lane) axis, lanes below o taking fill."""
    return torch.where(_LANES >= o, torch.roll(x, o, -1), fill)


def _warp_total(w):
    """The kernel's sum of the floored weights (N, K), add for add: each lane
    adds its pairs segment by segment in f64, then a shuffle butterfly
    (__shfl_xor_sync, 16 .. 1); rounded once to f32: (N, 1)."""
    pairs = _lane_pairs(w).double()
    s = torch.zeros(w.shape[0], 32, dtype=torch.float64)
    for g in range(pairs.shape[1]):
        s = s + (pairs[:, g, :, 0] + pairs[:, g, :, 1])
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, _LANES ^ o]
    return s[:, :1].float()


def _warp_scan_prefix(pdf, guard=True):
    """The kernel's CDF of (N, K) f32 pdf terms, add for add: per segment the
    lane's pair sum in f64, a 5-step Kogge-Stone scan over the 32 lanes
    (__shfl_up_sync by 1, 2, 4, 8, 16), the carry of the segments before it;
    each entry rounded once to f32 and, with ``guard``, raised by fmaxf to
    the entry before it."""
    n, k = pdf.shape
    pairs = _lane_pairs(pdf).double()
    carry = torch.zeros(n, 1, dtype=torch.float64)
    last = torch.zeros(n, 1, dtype=torch.float32)
    out = []
    for g in range(pairs.shape[1]):
        a = pairs[:, g, :, 0]
        s = a + pairs[:, g, :, 1]
        for o in (1, 2, 4, 8, 16):
            s = torch.where(_LANES >= o, s + torch.roll(s, o, -1), s)
        before = _shfl_up(s, 1, 0.0)
        c0 = (carry + before + a).float()
        c1 = (carry + s).float()
        if guard:
            c0 = torch.maximum(c0, _shfl_up(c1, 1, last))
            c1 = torch.maximum(c1, c0)
        out.append(torch.stack([c0, c1], -1).reshape(n, 64))
        carry = carry + s[:, 31:]
        last = c1[:, 31:]
    return torch.cat(out, -1)[:, :k]


def _tree_prefix(pdf):
    """An inclusive float32 scan in tree order (Hillis-Steele)."""
    x, o = pdf.clone(), 1
    while o < x.shape[-1]:
        x = torch.cat([x[:, :o], x[:, o:] + x[:, :-o]], -1)
        o *= 2
    return x


def _binary_rank(cdf, u):
    """The right-side rank of u (N, S) in cdf (N, M): the first index whose
    cdf > u, by bisection of [lo, hi) as the earlier kernel searched."""
    m = cdf.shape[1]
    lo = torch.zeros(u.shape, dtype=torch.long)
    hi = torch.full(u.shape, m, dtype=torch.long)
    for _ in range(int(np.ceil(np.log2(m + 1)))):
        mid = (lo + hi) // 2
        go_right = (lo < hi) & (torch.gather(cdf, 1, mid.clamp(max=m - 1)) <= u)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where((lo < hi) & ~go_right, mid, hi)
    return lo


def _select_rank(cdf, u):
    """csrc/resample.cu's search, step for step: the range [r, r + len] that
    holds the rank halves by a select, as many steps for every sample, then
    one last compare."""
    r = torch.zeros(u.shape, dtype=torch.long)
    length = cdf.shape[1]
    while length > 1:
        half = length // 2
        r = torch.where(torch.gather(cdf, 1, r + half - 1) <= u, r + half, r)
        length -= half
    return r + (torch.gather(cdf, 1, r) <= u).long()


def _kernel_emulation(bins, weights, u, prefix=_f64_prefix, total=_f64_total, rank=_binary_rank):
    """csrc/resample.cu's arithmetic (with ``prefix`` for its CDF, ``total``
    for the sum of the floored weights and ``rank`` for its search): floor,
    the f64 sum rounded to f32, pdf, the CDF, the rank, the clamps, the
    guard, interpolation."""
    n, m = bins.shape
    w = weights + 1e-5
    pdf = w / total(w)
    cdf = torch.cat([torch.zeros(n, 1), prefix(pdf)], -1)
    lo = rank(cdf, u)
    below, above = (lo - 1).clamp(min=0), lo.clamp(max=m - 1)
    cb, ca = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    denom = torch.where(ca - cb < 1e-5, torch.ones_like(cb), ca - cb)
    e0, e1 = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    return e0 + (u - cb) / denom * (e1 - e0)


def _cdf_at(bins, weights, x):
    """sample_pdf's piecewise-linear CDF evaluated at depths x (the forward
    map its samples invert)."""
    w = weights + 1e-5
    cdf = torch.cat([torch.zeros_like(w[:, :1]), torch.cumsum(w / w.sum(-1, keepdim=True), -1)],
                    -1)
    j = (torch.searchsorted(bins.contiguous(), x.contiguous(), right=True) - 1).clamp(
        0, bins.shape[1] - 2)
    e0, e1 = torch.gather(bins, 1, j), torch.gather(bins, 1, j + 1)
    c0, c1 = torch.gather(cdf, 1, j), torch.gather(cdf, 1, j + 1)
    return c0 + ((x - e0) / (e1 - e0)).clamp(0, 1) * (c1 - c0)


def _peaked_case(seed):
    """Weights with many near-empty bins, uniforms with 1.0 and 0.0."""
    gen = torch.Generator().manual_seed(seed)
    n, m, s = 512, 63, 64
    bins = torch.sort(2 + 4 * torch.rand(n, m, generator=gen), -1)[0]
    w = torch.rand(n, m - 1, generator=gen) ** 4
    w[0] = 0.0
    u = torch.rand(n, s, generator=gen)
    u[:, 0], u[:, 1] = 1.0, 0.0
    return bins, w, u


def _agree_in_depth_or_cdf(bins, w, got, want):
    """In depth two inverse CDFs differ where a bin's pdf is small: a cdf
    difference e moves a sample by e * width / pdf. Mapped back through
    sample_pdf's CDF they differ where a bin is narrow: a depth ulp moves the
    CDF by ulp * pdf / width. So each sample must agree in one of the two:
    within 1e-5 in depth, or within 1.1e-5 in the CDF, the 1e-5 guard's own
    width (a bin whose denominator the two put on opposite sides of it) plus
    their rounding. chip_smoke.py holds the kernel to this on the card.
    Returns the number of samples over 1e-5 in depth."""
    assert bool(((got >= bins[:, :1]) & (got <= bins[:, -1:])).all())
    dx = (got - want).abs()
    du = (_cdf_at(bins, w, got) - _cdf_at(bins, w, want)).abs()
    assert bool(((dx <= 1e-5) | (du <= 1.1e-5)).all())
    return int((dx > 1e-5).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_arithmetic_follows_sample_pdf(seed):
    """The kernel's arithmetic against sample_pdf on the CPU, on weights with
    many near-empty bins. Their prefix sums agree (both accumulate in f64);
    their sums of the weights may not (torch's float32 sum against the
    kernel's rounded f64 one), which scales a ray's pdf by an ulp."""
    bins, w, u = _peaked_case(seed)
    got, want = _kernel_emulation(bins, w, u), sample_pdf(bins, w, u.shape[1], u=u)
    assert _agree_in_depth_or_cdf(bins, w, got, want) > 0   # why depth alone is not the measure


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_prefix_sums_differ_in_depth_not_in_the_cdf(seed):
    """A float32 tree-ordered scan (as a float32 torch.cumsum rounds on the
    card) against the kernel's f64-accumulated prefix sums."""
    bins, w, u = _peaked_case(seed)
    got = _kernel_emulation(bins, w, u)
    want = _kernel_emulation(bins, w, u, prefix=_tree_prefix)
    assert _agree_in_depth_or_cdf(bins, w, got, want) > 0


def test_wrapper_raises_instead_of_falling_back():
    z, w = (torch.from_numpy(a) for a in _inputs(2, 8, seed=6))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_sample_pdf(z.to("meta"), w.to("meta"), 4, det=True)


def _scan_case(m, power, seed):
    """Floored weights (N, M - 1) = rand**power + 1e-5 (one all-zero ray) and
    their pdf, as the kernel forms it."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.rand(96, m - 1, generator=gen) ** power
    w[0] = 0.0
    w = w + 1e-5
    return w, w / _warp_total(w)


@pytest.mark.parametrize("power", [1, 4, 8])
@pytest.mark.parametrize("m", [2, 3, 63, 64, 65, 129, 768])
def test_warp_scan_is_the_serial_f64_prefix_sum(m, power):
    """The kernel's warp sum and warp scan against the serial f64 ones,
    bitwise, with the fmaxf guard never acting: their partial sums are exact
    in f64 (csrc/resample.cu's note)."""
    w, pdf = _scan_case(m, power, seed=m * power)
    assert torch.equal(_warp_total(w), _f64_total(w))
    got = _warp_scan_prefix(pdf)
    assert torch.equal(got, _warp_scan_prefix(pdf, guard=False))
    assert torch.equal(got, _f64_prefix(pdf))
    assert bool((got[:, 1:] >= got[:, :-1]).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_scan_gives_the_kernel_emulation_bitwise(seed):
    """On weights with many near-empty bins and u holding 1.0 and 0.0, the
    whole chain through the warp sum, the warp scan and the select search
    equals the chain through the serial f64 sums and the bisection, sample
    for sample."""
    bins, w, u = _peaked_case(seed)
    floored = w + 1e-5
    pdf = floored / _warp_total(floored)
    assert torch.equal(_warp_scan_prefix(pdf), _f64_prefix(pdf))
    got = _kernel_emulation(bins, w, u, prefix=_warp_scan_prefix, total=_warp_total,
                            rank=_select_rank)
    assert torch.equal(got, _kernel_emulation(bins, w, u))


def test_warp_scan_stays_non_decreasing_past_exactness():
    """Weights over 12 decades, past the range where every f64 partial sum is
    exact: the warp scan stays within an f32 ulp of the serial one, and the
    guard keeps it non-decreasing."""
    gen = torch.Generator().manual_seed(5)
    w = 10.0 ** (8 * torch.rand(64, 767, generator=gen) - 4) + 1e-5
    pdf = w / _warp_total(w)
    got, want = _warp_scan_prefix(pdf), _f64_prefix(pdf)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    ulp = torch.nextafter(want, torch.full_like(want, 2.0)) - want
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("m", [2, 3, 63, 64, 65, 129, 768])
def test_select_search_is_the_right_side_rank(m):
    """The kernel's search against the bisection and torch.searchsorted
    (right=True) on CDFs with runs of equal entries, at u on the knots, at 0
    and 1, past both ends and NaN."""
    w, pdf = _scan_case(m, 8, seed=m)
    cdf = torch.cat([torch.zeros(pdf.shape[0], 1), _f64_prefix(pdf)], -1)
    cdf[1, 1:m // 2 + 1] = cdf[1, 1]           # a run of equal entries
    cdf[2] = torch.cummax(cdf[2].bfloat16().float(), 0)[0]
    gen = torch.Generator().manual_seed(m)
    u = torch.rand(cdf.shape[0], 40, generator=gen)
    u[:, :8] = torch.gather(cdf, 1, torch.randint(m, (cdf.shape[0], 8), generator=gen))
    u[:, 8], u[:, 9], u[:, 10], u[:, 11], u[:, 12] = 0.0, 1.0, -0.5, 1.5, float("nan")
    got = _select_rank(cdf, u)
    assert torch.equal(got, _binary_rank(cdf, u))
    assert torch.equal(got[:, :12], torch.searchsorted(cdf, u[:, :12].contiguous(), right=True))
