"""XLA:CPU's float32 ``log``, ``log1p``, ``erf_inv`` and ``exp``, bit for bit.

``jax.random`` turns its uniform bits into normal, exponential, Gumbel and
Pareto draws through these four functions, and XLA does not call a libm for
them: it expands each into a polynomial (Cephes' ``logf``/``expf``, XLA's
``EmitLog1p`` and Giles' single-precision ``erfinv``), and the CPU backend
contracts each multiply whose product has one use into a fused multiply-add.
PyTorch's ``log``, ``erfinv`` and ``exp`` are other approximations, an ulp
or more away on many inputs, so the port writes XLA's out, step by step:

  * each fused multiply-add is computed exactly in f64 and rounded once to
    f32 (:func:`_fma`);
  * every other step is one f32 torch operation, as in the IR (a square
    root is taken in f64 and rounded: torch's f32 ``sqrt`` on the CPU is
    not correctly rounded);
  * XLA:CPU runs with denormals flushed to zero, inputs and results alike:
    a denormal input counts as a zero of its sign (``log`` of one is -inf)
    and a result below the smallest normal becomes a zero of its sign.

Each function names the IR it follows: the ``*.ir-with-opt.ll`` file that
``XLA_FLAGS=--xla_dump_to=DIR`` writes for ``jax.jit(jnp.log)`` (and
``jnp.log1p``, ``jax.scipy.special.erfinv``, ``jnp.exp``) on float32.
The functions run on any device; the f64 steps make them slower than
torch's own, which does not matter for the draws they serve.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
_TINY = float(np.finfo(np.float32).tiny)          # 2**-126, the smallest normal
_EXP_MASK = 0x7F800000
_NAN_BITS = -1                                    # 0xFFFFFFFF: XLA's NaN
_NEG_INF_BITS = -8388608                          # 0xFF800000
_INF_BITS = 0x7F800000


def _c(v: float) -> float:
    """A constant as XLA holds it: rounded to f32."""
    return float(np.float32(v))


# Cephes logf: log(1 + x) = x - x²/2 + x³·P(x) for x in [√½ - 1, √2 - 1)
_SQRTHF = _c(0.707106781186547524)
_LOG_P = tuple(_c(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LN2_HI, _LN2_LO = _c(0.693359375), _c(-2.12194440e-4)
# EmitLog1p's rational for |x| < √2 - 1: log1p(x) = x - x²/2 + x³·N(x)/D(x)
_LOG1P_SMALL = _c(0.41421356237309504880)
_LOG1P_N = tuple(_c(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_D = tuple(_c(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
# Giles' erfinv, single precision: w = -log1p(-x²); w < 5 and w >= 5
_ERFINV_SMALL = tuple(_c(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_LARGE = tuple(_c(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
# Cephes expf: exp(x) = 2**n · exp(r), r = x - n·ln 2 in two parts; XLA
# clamps x to [-87.8, 88.8] and ends the polynomial at exactly 0.5
_EXP_HI, _EXP_LO = _c(88.8), _c(-87.8)
_LOG2E = _c(1.44269504088896341)
_EXP_P = tuple(_c(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 0.5))


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to f32 (operands f32 tensors or f32-exact
    Python floats; at least one a tensor).

    The f64 product of two f32 values is exact; the f64 sum is rounded to
    odd (TwoSum gives its error; an inexact even result steps one f64 ulp
    toward the exact value), and an f64 rounded to odd rounds to the
    nearest f32 as the exact value would (53 >= 24 + 2 bits). A plain f64
    sum would round twice and miss about 1 in 10^4 of erf_inv's tails."""
    a64 = a.double() if isinstance(a, torch.Tensor) else a
    b64 = b.double() if isinstance(b, torch.Tensor) else b
    c64 = c.double() if isinstance(c, torch.Tensor) else c
    s = a64 * b64
    r = s + c64
    bb = r - s
    err = (s - (r - bb)) + (c64 - bb)
    even = (r.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(r)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(r)
    return torch.where(fix, torch.nextafter(r, toward), r).to(_F32)


def _daz(x: torch.Tensor) -> torch.Tensor:
    """Denormals to a zero of their sign (``x·0`` keeps the sign)."""
    x = x.to(_F32)
    return torch.where((x.view(torch.int32) & _EXP_MASK) == 0, x * 0.0, x)


_ftz = _daz  # a result below the smallest normal is flushed the same way


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _from_bits(b) -> torch.Tensor:
    return b.to(torch.int32).view(_F32)


def _log_core(v: torch.Tensor) -> torch.Tensor:
    """Cephes logf on v (DAZ already applied), special values included."""
    c = torch.where(v > _TINY, v, _TINY)            # select(uge(tiny, v), tiny, v)
    cb = _bits(c)
    m = _from_bits((cb & ~_EXP_MASK) | 0x3F000000)  # mantissa in [0.5, 1)
    e = ((cb >> 23) - 127).to(_F32) + 1.0
    lt = m < _SQRTHF
    x = (m - 1.0) + torch.where(lt, m, 0.0)
    e = e - torch.where(lt, 1.0, 0.0)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y0 = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y0, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LN2_LO)
    r = ((x - x2 * 0.5) + y) + e * _LN2_HI
    out = torch.where(v > 0, _bits(r), _NAN_BITS)   # ule(v, 0): NaN
    out = torch.where(v == float("inf"), _INF_BITS, out)
    out = torch.where(v == 0, _NEG_INF_BITS, out)
    return _from_bits(out)


def log(v: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` on float32: Cephes ``logf`` as XLA:CPU expands it
    (``jit_log``'s ``wrapped_log`` kernel): split v into m in [0.5, 1) and
    its exponent e, fold m below √½ into x = 2m - 1, evaluate the degree-8
    polynomial in three fma chains, ``y = fma(y0, x³, q1·e)``, then
    ``((x - x²/2) + y) + 0.693359375·e`` without an fma. A denormal input
    is a zero (-inf); v < 0 and NaN give NaN."""
    return _log_core(_daz(v))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` on float32, XLA's ``EmitLog1p`` (``jit_log1p``'s
    ``wrapped_log-plus-one`` kernel): for |x| < √2 - 1,
    ``x + fma(x², -0.5, x·x²·N(x)/D(x))`` with N and D by fma Horner from
    their highest coefficient; otherwise :func:`log` of ``1 + x``."""
    x = _daz(x)
    big = _log_core(_daz(x + 1.0))
    x2 = _ftz(x * x)
    x0 = x * 0.0                 # Horner's first step, x·0 + c, unfused
    num, den = x0 + _LOG1P_N[0], x0 + _LOG1P_D[0]
    for cn, cd in zip(_LOG1P_N[1:], _LOG1P_D[1:], strict=True):
        num, den = _fma(num, x, cn), _fma(den, x, cd)
    small = x + _fma(x2, -0.5, _ftz(_ftz(x * x2) * (num / den)))
    return _ftz(torch.where(x.abs() < _LOG1P_SMALL, small, big))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` on float32, Giles' single-precision polynomial as
    XLA:CPU expands it (``jit_erfinv``'s ``multiply_select`` fusion):
    ``w = -log1p(-x²)`` (the product x·(-x) rounded first); for w < 5,
    ``t = w - 2.5`` and the first coefficient set, else ``t = sqrt(w) - 3``
    and the second; fma Horner over the nine coefficients; ``x · p``, with
    p = inf at |x| = 1."""
    x = _daz(x)
    w = -log1p(_ftz(x * -x))
    small = w < 5.0
    root = torch.sqrt(w.double()).to(_F32)      # correctly rounded, as vsqrtps
    t = torch.where(small, w - 2.5, root - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:], strict=True):
        p = _fma(p, t, torch.where(small, a, b))
    p = torch.where(x.abs() == 1.0, float("inf"), p)
    return _ftz(x * p)


def exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` on float32: Cephes ``expf`` as XLA:CPU expands it
    (``jit_exp``'s ``wrapped_exponential`` kernel): x clamped to
    [-87.8, 88.8], ``n = floor(fma(x, log2 e, 0.5))`` clamped to
    [-127, 127], ``r = fma(-q2, n, x - q1·n)`` (q1·n exact), the degree-5
    polynomial by fma Horner, ``fma(p, r², r) + 1``, times 2**n."""
    x = _daz(x).to(_F32)
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(_fma(xc, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = _fma(n, -_LN2_LO, xc - n * _LN2_HI)
    p = _fma(r, _EXP_P[0], _EXP_P[1])
    for cf in _EXP_P[2:]:
        p = _fma(p, r, cf)
    y = _fma(p, r * r, r) + 1.0
    scale = _from_bits((n.to(torch.int32) + 127) << 23)
    return _ftz(y * scale)
