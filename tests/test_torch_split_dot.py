"""The identities behind K6's split tensor-core cells (csrc/prefill_split.cuh).

K6's fp forms must keep the JAX package's f32 dots (attention.py:1613-1640)
while running on tensor cores, whose inputs keep 8 (bf16) or 11 (TF32)
significant bits.  These tests emulate the cells' splits in numpy and show,
for f32 values outside the subnormal range:

the bf16 cell (a bf16 cache):
* x = hi + mid + lo exactly, hi = bf16(x), mid = bf16(x - hi), lo =
  bf16(x - hi - mid) (round to nearest even at each step);
* each bf16 x bf16 partial product is exact in f32, so three passes of an f32
  query against a bf16 key sum to q * k within one f32 rounding per addition;
* a plain bf16 pass misses the f32 dot by three orders of magnitude more;

the TF32 cell (an f32 cache):
* big = x with its low 13 bits cleared and small = x - big are exact, and
  small read as TF32 (truncated, as the mma reads it) leaves below 2^-20 |x|;
* a bf16 value is exact in TF32 (its passes drop);
* every TF32 x TF32 product is exact in f32;
* big.big + small.big + big.small, summed in f32 in any order, is within
  (3.01 * 2^-20 + n_terms * 2^-24) * sum |x_i y_i| of the exact dot -- far
  inside FP_TOL (1e-5 of the peak output, chip_smoke.py).
"""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

F32_NORMAL = float(np.finfo(np.float32).tiny)

finite_f32 = st.floats(min_value=-2.0 ** 100, max_value=2.0 ** 100, allow_nan=False,
                       allow_infinity=False, width=32).filter(
    lambda v: v == 0.0 or abs(v) >= 2.0 ** -100)
moderate_f32 = finite_f32.filter(lambda v: abs(v) < 2.0 ** 50)


def bf16(x):
    """float32 -> bfloat16 (round to nearest even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) & ~np.uint64(0xFFFF)).astype(np.uint32)
    return b.view(np.float32)


def tf32_trunc(x):
    """x with its low 13 bits cleared: the TF32 value an mma reads."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def split3(x):
    """The bf16 cell's terms of an f32 value (csrc/prefill_split.cuh split3)."""
    x = np.asarray(x, np.float32)
    hi = bf16(x)
    r = (x - hi).astype(np.float32)
    mid = bf16(r)
    lo = bf16((r - mid).astype(np.float32))
    return hi, mid, lo


def split2(x):
    """The TF32 cell's terms (split2): big truncated, small as the mma reads it."""
    x = np.asarray(x, np.float32)
    big = tf32_trunc(x)
    return big, tf32_trunc((x - big).astype(np.float32))


def is_tf32(v):
    return np.all((np.asarray(v, np.float32).view(np.uint32) & 0x1FFF) == 0)


# ------------------------------------------------------------------ bf16 cell


@settings(max_examples=400, deadline=None)
@given(finite_f32)
def test_bf16_three_terms_reconstruct_f32_exactly(v):
    x = np.float32(v)
    hi, mid, lo = split3(x)
    assert all(bf16(t) == t for t in (hi, mid, lo))
    assert float(hi) + float(mid) + float(lo) == float(x)


@settings(max_examples=300, deadline=None)
@given(moderate_f32, moderate_f32)
def test_bf16_partial_products_exact_and_their_sum_one_rounding(a, b):
    q, k = np.float32(a), bf16(np.float32(b))  # an f32 query, a bf16 key
    exact = float(q) * float(k)
    acc = np.float32(0.0)
    for t in split3(q):
        prod = float(t) * float(k)  # 8 + 8 significant bits: exact in f32
        if prod != 0 and abs(prod) < F32_NORMAL:
            return
        assert float(np.float32(t * k)) == prod
        acc = np.float32(acc + np.float32(prod))
    # three partial products, two f32 additions: each rounds once
    assert abs(float(acc) - exact) <= 2.0 ** -23 * (1 + 2.0 ** -10) * abs(exact)


def test_plain_bf16_dot_misses_by_far_more():
    """Why the split: one bf16 pass (the INT8 form's arithmetic) misses the
    f32 dot by ~5e-5 of sum |x_i y_i| at hd 128 (each query value rounded by
    up to 2^-9), three orders of magnitude past the split's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(128).astype(np.float32)
    y = bf16(rng.standard_normal(128).astype(np.float32))
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    mag = float(np.abs(x.astype(np.float64) * y.astype(np.float64)).sum())
    one_pass = float(np.dot(bf16(x).astype(np.float64), y.astype(np.float64)))
    acc = np.float32(0.0)
    for t in split3(x):
        acc = np.float32(acc + np.float32(np.dot(t.astype(np.float64), y.astype(np.float64))))
    assert abs(one_pass - exact) > 1e-5 * mag > 1000 * abs(float(acc) - exact)


# ------------------------------------------------------------------ TF32 cell


@settings(max_examples=400, deadline=None)
@given(finite_f32)
def test_tf32_split_terms_and_remainder(v):
    x = np.float32(v)
    big, small = split2(x)
    assert is_tf32(big) and is_tf32(small)
    # x - big is exact in f32 (big is x with low bits cleared)
    assert float(x) - float(big) == float(np.float32(x - big))
    # what the two terms miss is below 2^-20 |x|
    assert abs(float(x) - float(big) - float(small)) <= 2.0 ** -20 * abs(float(x))


@settings(max_examples=400, deadline=None)
@given(finite_f32)
def test_bf16_values_are_exact_in_tf32(v):
    kb = bf16(np.float32(v))
    big, small = split2(kb)
    assert big == kb and small == 0


@settings(max_examples=300, deadline=None)
@given(moderate_f32, moderate_f32)
def test_tf32_products_are_exact_in_f32(a, b):
    for x in split2(np.float32(a)):
        for y in split2(np.float32(b)):
            exact = float(x) * float(y)  # 11 + 11 significant bits
            if exact == 0 or abs(exact) >= F32_NORMAL:
                assert float(np.float32(x * y)) == exact


def split_dot(x, y, order):
    """The TF32 cell's dot: small.big, big.small, then big.big terms, summed
    in f32 in ``order`` (the tensor cores' order is their own)."""
    xb, xs = split2(x)
    yb, ys = split2(y)
    terms = np.concatenate([xs * yb, xb * ys, xb * yb]).astype(np.float32)
    acc = np.float32(0.0)
    for t in terms[order]:
        acc = np.float32(acc + t)
    return float(acc), len(terms)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 128), st.integers(0, 2 ** 31 - 1), st.sampled_from(["f32", "bf16"]))
def test_split_dot_within_its_bound(n, seed, xdt):
    rng = np.random.default_rng(seed)
    scale = np.float32(2.0) ** rng.integers(-20, 20, size=2)
    x = (rng.standard_normal(n) * scale[0]).astype(np.float32)
    y = (rng.standard_normal(n) * scale[1]).astype(np.float32)
    if xdt == "bf16":  # a bf16 query: its small terms are 0
        x = bf16(x)
        assert np.all(split2(x)[1] == 0)
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    mag = float(np.abs(x.astype(np.float64) * y.astype(np.float64)).sum())
    got, nterms = split_dot(x, y, rng.permutation(3 * n))
    assert abs(got - exact) <= (3.01 * 2.0 ** -20 + nterms * 2.0 ** -24) * mag
