"""The bit tricks of the bf16 forms of K1b and K14, proved by enumeration.

Both kernels keep every bit of the formulas they replaced (the card test
``test_bf16_bit_formulas_equal_on_every_pattern`` in
``tests/test_torch_cuda.py`` applies old and new device formulas to all
65,536 bf16 patterns); these numpy-only checks say why, in seconds:

* ``exp2_fast_bf16x2`` (``ops/cuda/atrous_common.cuh``) builds 2^i, i =
  floor(y + 1/2) <= 0, from the bf16 bits of t = max(i, -126) + 255 (exact
  in bf16), ``(bits(t) & 0x7F) << 7``, where it converted i to an integer,
  clipped it to [-126, 127] and shifted ``i + 127`` into the exponent
  field.  Every bf16 y in [-1e4, 0] (the exponent's argument is <= 0 and
  clamped at bf16(-1e4) first) gives the same bits both ways, in either
  lane of a packed pair.
* K14-bf16 rounds ``rcp.approx.f32(dz2)`` to bf16 where it rounded the
  correctly rounded reciprocal.  The PTX ISA bounds rcp.approx.f32's error
  by 1 ulp; for every positive finite bf16 m whose reciprocal is finite in
  float32, the exact 1/m lies more than 1 float32 ulp from every bf16
  rounding midpoint, so both reciprocals round to the same bf16.
"""

import math

import numpy as np

# bf16(-1e4), the exponent's clamp (ops.atrous.bf16_constants' "floor")
FLOOR = -9984.0


def _bf16_bits(x):
    """float32 values rounded to bf16 (ties to even), as uint16 bits."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return u.astype(np.uint16)


def _bf16_value(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _bf16(x):
    """float32 values rounded to bf16, as float32."""
    return _bf16_value(_bf16_bits(x))


def _exponent_inputs():
    """i = floor(bf16(max(y, FLOOR) + 1/2)) of every bf16 y <= 0 (every
    negative pattern and +0), as the kernel forms it: each bf16 operation
    rounded once (the sum of two bf16 values is exact in float32)."""
    bits = np.concatenate([np.arange(0x8000, 0x10000), [0]]).astype(np.uint16)
    y = _bf16_value(bits)
    finite = ~np.isnan(y)
    y = np.maximum(y[finite], np.float32(FLOOR))
    return np.floor(_bf16(y + np.float32(0.5)))


def _old_two_i(yi):
    """The replaced assembly: the integer i clipped, ``(i + 127) << 7``."""
    i = np.clip(yi.astype(np.int64), -126, 127)
    return ((i + 127) << 7).astype(np.uint32)


def _new_two_i(yi):
    """``(bits(bf16(max(i, -126) + 255)) & 0x7F) << 7``."""
    t = _bf16_bits(np.maximum(yi, np.float32(-126.0)) + np.float32(255.0))
    return ((t.astype(np.uint32) & 0x7F) << 7).astype(np.uint32)


def test_exponent_bits_equal_the_clamp_and_shift():
    """Every bf16 argument <= 0 (and every integer bf16 in [-1e4, 0]):
    the same 2^i bits; t is exact in bf16 (an integer in [129, 255])."""
    yi = _exponent_inputs()
    ints = _bf16_value(np.arange(0x8000, 0xFF80, dtype=np.uint16))
    ints = ints[(ints >= -1e4) & (ints == np.floor(ints))]
    for i in (yi, np.concatenate([ints, [np.float32(0.0)]])):
        assert i.size and i.max() <= 0.0 and i.min() >= FLOOR
        np.testing.assert_array_equal(_new_two_i(i), _old_two_i(i))
        t = np.maximum(i, np.float32(-126.0)) + np.float32(255.0)
        np.testing.assert_array_equal(_bf16(t), t)
        assert t.min() >= 129.0 and t.max() <= 255.0


def test_exponent_bits_stay_in_their_lane():
    """The packed form masks both lanes with 0x007F007F and shifts the
    word by 7: no bit crosses from the low lane into the high one, for
    every pair of the exponents' distinct values."""
    yi = np.unique(_exponent_inputs())
    lo, hi = (a.ravel() for a in np.meshgrid(yi, yi))
    t = (_bf16_bits(np.maximum(lo, -126.0) + 255.0).astype(np.uint32)
         | (_bf16_bits(np.maximum(hi, -126.0) + 255.0).astype(np.uint32)
            << 16))
    packed = (t & 0x007F007F) << 7
    np.testing.assert_array_equal(packed & 0xFFFF, _old_two_i(lo))
    np.testing.assert_array_equal(packed >> 16, _old_two_i(hi))


def test_reciprocal_is_far_from_every_bf16_midpoint():
    """Exact integer arithmetic over every positive finite bf16 m with a
    finite float32 reciprocal: in units of the float32 ulp of q = 1/m, the
    bf16 rounding midpoints are the odd multiples of 2^15 (bf16 keeps 16
    fewer mantissa bits, in the normal and the subnormal range alike), and
    q's distance to the nearest is > 1 ulp (the PTX ISA's bound on
    rcp.approx.f32), so rcp.approx and rcp.rn round alike.  The least
    distance is ~128 ulps."""
    least = None
    values = _bf16_value(np.arange(0x0001, 0x7F80, dtype=np.uint16))
    for m in values.tolist():
        mant, e = math.frexp(m)                # m = mant * 2^e, mant in [.5, 1)
        M = int(mant * 2 ** 24)                # m = M * 2^(e - 24), M integer
        E = e - 24
        while M % 2 == 0:
            M, E = M // 2, E + 1
        assert 1 <= M < 256
        # q = 2^-E / M; its binade 2^b <= q < 2^(b + 1)
        b = -E - M.bit_length() + (1 if M & (M - 1) == 0 else 0)
        if b >= 128:
            continue                           # q overflows float32
        u = max(b, -126) - 23                  # log2 of q's float32 ulp
        assert -E - u >= 0
        N = 2 ** (-E - u)
        # q in ulps is N / M; midpoints at odd multiples of H = 2^15
        H = 2 ** 15
        d = abs(N % (2 * H * M) - H * M)       # M * distance in ulps
        assert d > M, m
        least = d / M if least is None else min(least, d / M)
    assert 100.0 < least < 200.0, least
