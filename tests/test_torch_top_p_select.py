"""A numpy model of the top-p kernels' selection (csrc/top_p.cu), on the CPU.

The kernels find c* = min{v in values U {0} : sum(p[p > v]) <= top_p}
exactly, by a radix select over the bit patterns of the positive values
(`tp.RADIX_LEVELS`), with each bin's mass an exact integer sum of
mantissas (level 0 in 128-bit fixed point, exact within each exponent;
levels 1 and 2, which share one exponent, in mantissa units); then they
replay the 32 bisection steps of
`top_p_threshold_plain` from c* (the step's test `mass(p > mid) > top_p` is
`mid < c*`) and resolve the boundary token. `select_model` does the same in
numpy and Python integers. It is held

- bit for bit against `top_p_threshold_plain` (the port's bisection, f64
  masses), on random, tied, one-hot, uniform and half-zero rows at
  V in {130, 1000, 32000, 128256} and top_p in {0.5, 0.9, 0.99, 0.999};
- to the same nucleus, with |dt| <= 1e-6, against JAX's Pallas kernels in
  interpret mode (`top_p_threshold_fused`, `top_p_threshold_from_logits`)
  and `sequoia_tpu/ops/sampling.py::top_p_threshold`, but for a boundary
  token whose mass above is within 1e-6 of top_p, where JAX's f32 masses
  decide otherwise (`boundary_disagreements`).

The `cuda`-marked tests run the same rows, and rows whose boundary token
lies below c* or whose whole mass fits in top_p, through both kernels on
both routes of the card and hold them to the plain versions (they skip
here).
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from sequoia_torch.kernels import build
from sequoia_torch.kernels import top_p as tp

T = 0.6
BIG = np.float32(np.finfo(np.float32).max)
KINDS = ("random", "tied", "one_hot", "uniform", "half_zero")
VOCABS = (130, 1000, 32000, 128256)
TOP_PS = (0.5, 0.9, 0.99, 0.999)


# The model ------------------------------------------------------------------------

def fixed_point_scale(hi: np.float32, V: int) -> int:
    """S of the kernel's fixed point (a mass M is floor(M * 2**S) in 128
    bits): every row's total, at most V * hi < 2**(bitlen(V) + e), stays
    under 2**126."""
    e = max(int(np.float32(hi).view(np.uint32) >> 23) - 126, 0)
    return 126 - V.bit_length() - e


def scale(x: int, sh: int) -> int:
    """floor(x * 2**sh)."""
    return x << sh if sh >= 0 else x >> -sh


def units(left: int, sh: int) -> int:
    """min(floor(left * 2**-sh), 2**64 - 1): a fixed-point mass in units of
    2**sh (the kernel's u64)."""
    return min(scale(left, -sh), 2 ** 64 - 1)


def pick(sums, counts, room, bins, unit_of):
    """The lowest non-empty bin whose mass above fits in `room`, with that
    mass, and the level's whole mass. Bins come in groups that share a unit
    2**sh (level 0: the 8 bins of one exponent; levels 1 and 2: all): a
    group's mass is floor(its mantissa sum * 2**sh), and within the group
    the comparison is exact in its unit."""
    total, chosen = 0, None
    for top in range(len(sums) - bins, -1, -bins):      # groups, the highest first
        sh = unit_of(top)
        group = [int(v) for v in sums[top:top + bins]]
        if sum(group) and total <= room:
            room_u, above = units(room - total, sh), 0
            for k in range(bins - 1, -1, -1):
                if counts[top + k] and above <= room_u:
                    chosen = (top + k, total + scale(above, sh))
                above += group[k]
        total += scale(sum(group), sh)
    return chosen, total


def radix_select(p: np.ndarray, top_p: float, hi: np.float32,
                 total_lb: np.float32) -> np.float32:
    """c*, found level by level: at each level the lowest non-empty bin
    whose mass above (the higher bins, and the higher bins of every
    earlier level) fits in top_p holds c*. 0 when the whole positive mass
    fits. Values at or below the floor L (f(L) >= total_lb - V * L >
    top_p) take no part."""
    V = p.size
    S = fixed_point_scale(hi, V)
    limit = int(math.ldexp(top_p, S))           # floor(top_p * 2**S)
    floor = (np.float32(0.5 * (float(total_lb) - top_p) / V) if total_lb > top_p
             else np.float32(0))
    keys = p[p > floor].view(np.uint32).astype(np.int64)
    mant = (keys & 0x7FFFFF) | np.where(keys >> 23 > 0, 0x800000, 0)
    above, prefix = 0, 0
    for level, (shift, bits) in enumerate(tp.RADIX_LEVELS):
        b = (keys >> shift) & ((1 << bits) - 1)
        sums = np.bincount(b, weights=mant, minlength=1 << bits)   # exact: < 2**53
        counts = np.bincount(b, minlength=1 << bits)
        if level == 0:   # 128-bit fixed point; a bin's exponent is its top 8 bits
            (chosen, above), total = pick(sums, counts, limit, 8,
                                          lambda top: max(top >> 3, 1) - 150 + S)
            if floor == 0 and total <= limit:
                return np.float32(0)
        else:            # one exponent
            sh = max(int(keys[0] >> 23), 1) - 150 + S
            (chosen, gt), _ = pick(sums, counts, units(limit - above, sh), 1 << bits,
                                   lambda top: 0)
            above += scale(gt, sh)
        prefix = (prefix << bits) | chosen
        keys, mant = keys[b == chosen], mant[b == chosen]
    return np.array([prefix], np.uint32).view(np.float32)[0]


def select_model(p: np.ndarray, top_p: float, hi=None):
    """The kernel's threshold for one row of probabilities `p` (f32),
    and the case it met ("common": c* itself is the boundary token; "rare":
    a value lies in (lo, c*), or c* = 0). `hi` is the row's max, which the
    from-logits kernel knows as 1 / s; its sum is then at least 1 - 2**-20,
    the fused kernel's sum within 2**-12 of its f32 sum."""
    p = np.asarray(p, np.float32)
    if hi is None:
        hi = p.max()
        total_lb = np.float32(p.astype(np.float64).sum()) * np.float32(1 - 2.0 ** -12)
    else:
        hi, total_lb = np.float32(hi), np.float32(1 - 2.0 ** -20)
    cstar = radix_select(p, top_p, hi, total_lb)
    half = np.float32(0.5)
    lo = np.float32(0)
    for _ in range(tp.ITERS):                    # the bisection, replayed
        mid = half * (lo + hi)
        if mid < cstar:
            lo = mid
        else:
            hi = mid
    # one reduction: cand = min{p > lo}, the next distinct value above it,
    # and max{p <= lo} (the value below cand: none lies in (lo, cand))
    above_lo = np.unique(p[p > lo])
    cand, above = (list(above_lo[:2]) + [BIG, BIG])[:2]
    below = p[p <= lo].max() if (p <= lo).any() else -BIG
    case = "common" if cand == cstar else "rare"
    if cand >= cstar:                            # f(cand) <= top_p: kept
        below = below if below > -BIG else np.float32(0)
        t = half * (cand + below)
        return (t if t > below else cand), case
    above = above if above < BIG else cand * np.float32(2)
    t = half * (cand + above)
    return (t if t > cand else above), case


def softmax_model(logits: np.ndarray, temperature: float):
    """The from-logits kernel's softmax: a true division by T, exp, the
    normalizer summed in f64 and rounded once; its max is 1 / s."""
    x = logits.astype(np.float32) / np.float32(temperature)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    s = e.astype(np.float64).sum(axis=-1, keepdims=True).astype(np.float32)
    return e / s, np.float32(1) / s[..., 0]


# Rows ------------------------------------------------------------------------------

def make_logits(kind: str, V: int, rng) -> np.ndarray:
    if kind == "random":
        x = rng.normal(size=V) * 3
    elif kind == "tied":                 # a few distinct values, many ties
        x = np.round(rng.normal(size=V) * 2)
    elif kind == "one_hot":              # p = [.., 1, ..], the rest exactly 0
        x = np.full(V, -1e4)
        x[rng.integers(V)] = 0
    elif kind == "uniform":
        x = np.zeros(V)
    else:                                # half the row exactly 0
        x = rng.normal(size=V) * 3
        x[rng.permutation(V)[:V // 2]] = -1e30
    return x.astype(np.float32)


def rows(V: int, seed: int):
    """One row of each kind: logits [5, V], and probabilities (torch's
    softmax at T, half-zero rows with some -0.0 entries)."""
    rng = np.random.default_rng(seed)
    logits = np.stack([make_logits(k, V, rng) for k in KINDS])
    probs = torch.softmax(torch.from_numpy(logits) / T, dim=-1).numpy().copy()
    half = KINDS.index("half_zero")
    zeros = np.flatnonzero(probs[half] == 0)
    probs[half, zeros[::2]] = -0.0
    return logits, probs


def jax_modules():
    jax = pytest.importorskip("jax")
    from sequoia_tpu.kernels import top_p as jax_top_p
    from sequoia_tpu.ops import sampling
    return jax, jax.numpy, jax_top_p, sampling


def same_nucleus(probs, got, want, top_p):
    """The same nucleus but for a boundary token whose mass above lies
    within 1e-6 of top_p (JAX sums its masses in f32: at V = 32000 and
    top_p = 0.999 one random row has 0.99900004 above its boundary token),
    and |dt| <= 1e-6 on every row whose nucleus agrees."""
    probs, got, want = (torch.from_numpy(np.asarray(a, np.float32)) for a in (probs, got, want))
    tp.boundary_disagreements(probs, got, want, top_p)
    same = ((probs >= got[:, None]) == (probs >= want[:, None])).all(dim=1)
    assert torch.where(same, (got - want).abs(), 0.0).max().item() <= 1e-6


# Tests -----------------------------------------------------------------------------

@pytest.mark.parametrize("top_p", TOP_PS)
@pytest.mark.parametrize("V", VOCABS)
def test_model_equals_plain_bit_for_bit(V, top_p):
    logits, probs = rows(V, seed=V)
    want = tp.top_p_threshold_plain(torch.from_numpy(probs), top_p).numpy()
    got = np.array([select_model(r, top_p)[0] for r in probs])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the from-logits kernel's own softmax, through the same selection
    p, hi = softmax_model(logits, T)
    want = tp.top_p_threshold_plain(torch.from_numpy(p), top_p).numpy()
    got = np.array([select_model(r, top_p, h)[0] for r, h in zip(p, hi)])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("top_p", TOP_PS)
@pytest.mark.parametrize("V", VOCABS)
def test_model_matches_jax(V, top_p):
    """Fused: the model against JAX's Pallas kernel (interpret mode) and
    ops/sampling.py::top_p_threshold on the same probabilities. From
    logits: the model on its own softmax against JAX's from-logits kernel,
    the nuclei read on JAX's softmax."""
    jax, jnp, jtp, sampling = jax_modules()
    logits, probs = rows(V, seed=V + 1)
    got = np.array([select_model(r, top_p)[0] for r in probs])
    want = jtp.top_p_threshold_fused(jnp.asarray(probs), top_p, interpret=True)
    same_nucleus(probs, got, want, top_p)
    same_nucleus(probs, got, sampling.top_p_threshold(jnp.asarray(probs), top_p), top_p)
    p, hi = softmax_model(logits, T)
    got = np.array([select_model(r, top_p, h)[0] for r, h in zip(p, hi)])
    want = np.asarray(jtp.top_p_threshold_from_logits(jnp.asarray(logits), top_p, T,
                                                      interpret=True))
    jprobs = np.asarray(jax.nn.softmax(jnp.asarray(logits) / T, axis=-1))
    same_nucleus(jprobs, got, want, top_p)


def rare_rows():
    """(row, top_p) pairs: a value b lies within max * 2**-32 below c* = a,
    so that often b is in (lo, c*) and the boundary token is b, below c*;
    every fourth row's whole mass fits in top_p (c* = 0)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(40):
        a = np.float32(rng.uniform(1e-10, 4e-10))
        b = np.float32(a * (1 - rng.uniform(1e-4, 0.3)))
        p = np.array([0.6, 0.4, a, b, 0, b * 0.5], np.float32)
        f_a = float(p[p > a].astype(np.float64).sum())
        f_b = float(p[p > b].astype(np.float64).sum())
        out.append((p, (f_a + f_b) / 2 if i % 4 else f_a + 1.0))
    return out


def test_model_takes_the_rare_resolution():
    """Rows where a value lies in (lo, c*) (c* within max * 2**-32 of the
    value below it), and rows whose whole mass fits in top_p (c* = 0): the
    model's boundary token is not c*, and it still equals the plain
    version."""
    cases = []
    for p, top_p in rare_rows():
        t, case = select_model(p, top_p)
        want = tp.top_p_threshold_plain(torch.from_numpy(p[None]), top_p).numpy()[0]
        assert np.float32(t).view(np.uint32) == want.view(np.uint32)
        cases.append(case)
    assert cases.count("rare") >= 10 and "common" in cases


def rn32(x: Fraction) -> np.float32:
    """The f32 nearest the rational x (ties to even; normal or subnormal)."""
    if x == 0:
        return np.float32(0)
    mag = abs(x)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    if Fraction(2) ** e > mag:
        e -= 1
    e = max(e, -126)
    scaled = mag * Fraction(2) ** (23 - e)
    m = scaled.numerator // scaled.denominator
    rem = scaled - m
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and m % 2):
        m += 1
    return np.float32(math.copysign(math.ldexp(m, e - 23), x))


def test_markstein_division_is_correctly_rounded():
    """csrc/top_p.cu's div_rn (q = RN(a y), then RN(q + RN(a - b q) y) with
    y = RN(1 / b), each FMA rounded once) equals IEEE division where the
    quotient is normal: logits over temperatures, and exponentials over
    softmax normalizers (Markstein's theorem)."""
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=1500) * 8).astype(np.float32)
    temps = rng.choice(np.float32([0.6, 0.7, 0.9, 1.3, 2.5, 0.333]), size=1500)
    exps = np.exp(-rng.uniform(0, 60, size=1500)).astype(np.float32)
    sums = rng.uniform(1, 2 ** 17, size=1500).astype(np.float32)
    F = lambda v: Fraction(float(v))  # noqa: E731
    for a, b in [*zip(logits, temps), *zip(exps, sums)]:
        y = np.float32(1) / b
        q = np.float32(a * y)
        r = rn32(F(a) - F(q) * F(b))
        got = rn32(F(r) * F(y) + F(q))
        assert got == np.float32(a / b) == rn32(F(a) / F(b)), (a, b, got, a / b)


def test_radix_levels_cover_the_bits():
    """Three levels over bits 30..0 (the sign of a positive value is 0);
    the first level holds the whole exponent, so a bin's values share it."""
    spans = [(s, s + b) for s, b in tp.RADIX_LEVELS]
    assert spans[0][1] == 31 and spans[-1][0] == 0
    assert all(hi == lo for (lo, _), (_, hi) in zip(spans, spans[1:]))
    assert tp.RADIX_LEVELS[0][0] <= 23


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("top_p", TOP_PS)
@pytest.mark.parametrize("V", VOCABS)
def test_kernels_on_adversarial_rows(V, top_p):
    """The same rows through both kernels on the card (V = 128256 on the
    cluster route): fused bit for bit against the plain version and equal
    on two launches; from logits within `boundary_disagreements` and
    |dt| <= 1e-6 on every row whose nucleus agrees."""
    _need_cuda()
    logits, probs = rows(V, seed=V)
    suffix = "_cluster" if V > tp.REGISTER_VOCAB else ""
    before = dict(build.launches)
    x = torch.from_numpy(probs).cuda()
    got = tp.top_p_threshold_fused(x, top_p)
    torch.testing.assert_close(got, tp.top_p_threshold_plain(x, top_p), rtol=0, atol=0)
    assert torch.equal(got, tp.top_p_threshold_fused(x, top_p))
    lg = torch.from_numpy(logits).cuda()
    got = tp.top_p_threshold_from_logits(lg, top_p, T)
    want = tp.top_p_threshold_from_logits_plain(lg, top_p, T)
    assert torch.equal(got, tp.top_p_threshold_from_logits(lg, top_p, T))
    p = torch.softmax(lg / T, dim=-1)
    tp.boundary_disagreements(p, got, want, top_p)
    same = ((p >= got[:, None]) == (p >= want[:, None])).all(dim=1)
    assert torch.where(same, (got - want).abs(), 0.0).max().item() <= 1e-6
    for name in ("top_p_threshold_fused", "top_p_threshold_from_logits"):
        assert build.launches[name + suffix] == before[name + suffix] + 2


def check_kernels(probs, logits, top_p, temperature):
    """Both kernels on rows `probs` and `logits` (on the card): fused bit for
    bit against the plain version and equal on two launches; from logits
    equal on two launches, the nuclei of the plain version's but for an
    ill-conditioned boundary token, and |dt| <= 1e-6 where they agree."""
    got = tp.top_p_threshold_fused(probs, top_p)
    torch.testing.assert_close(got, tp.top_p_threshold_plain(probs, top_p), rtol=0, atol=0)
    assert torch.equal(got, tp.top_p_threshold_fused(probs, top_p))
    got = tp.top_p_threshold_from_logits(logits, top_p, temperature)
    want = tp.top_p_threshold_from_logits_plain(logits, top_p, temperature)
    assert torch.equal(got, tp.top_p_threshold_from_logits(logits, top_p, temperature))
    p = torch.softmax(logits / temperature, dim=-1)
    tp.boundary_disagreements(p, got, want, top_p)
    same = ((p >= got[:, None]) == (p >= want[:, None])).all(dim=1)
    assert torch.where(same, (got - want).abs(), 0.0).max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("V", (1000, 128256))
def test_kernels_on_rare_rows(V):
    """The rows of `rare_rows` spread over a row of V zeros (V = 128256 on
    the cluster route), and random rows at a top_p their whole mass fits
    in (c* = 0), through both kernels as `check_kernels` holds them; the
    from-logits kernel gets the rows' logs (zeros at -1e30) at T = 1."""
    _need_cuda()
    rng = np.random.default_rng(V)
    for p6, top_p in rare_rows():
        p = np.zeros((1, V), np.float32)
        p[0, rng.permutation(V)[:6]] = p6
        logits = np.where(p > 0, np.log(np.maximum(p, 1e-38)), -1e30).astype(np.float32)
        check_kernels(torch.from_numpy(p).cuda(), torch.from_numpy(logits).cuda(), top_p, 1.0)
    logits, probs = rows(V, seed=V + 2)
    for top_p in (float(probs.astype(np.float64).sum(axis=1).max()), 1.5):
        check_kernels(torch.from_numpy(probs).cuda(), torch.from_numpy(logits).cuda(), top_p, T)
