"""2D dyadic discrete wavelet transform (port of vcf_tpu/ops/dwt.py).

Multilevel per-channel dyadic decomposition with `levels` levels and a
named wavelet (default db5), per-subband quantization, and the DWT flow
of `pipeline.Codec` (src/2D-DWT.py): on the host path each subband is
its own entropy stream, LL stored as uint16 and the detail subbands as
uint8, both +128 (src/2D-DWT.py:162-200), with its trained quantizer
side info as `<band>.q_<name>` arrays; with the deadzone quantizer
and a device entropy codec (`rans`, `grans`, `cgrans`) every subband is
one group of one grouped-rANS grid (`entropy.dwt_device`).

The filter banks are designed in numpy, copied verbatim from vcf_tpu
(Daubechies, symlets, coiflets, the spline biorthogonal family, CDF 9/7,
the periodization-phase search `_calibrate`), so `get_bank(name)` gives
vcf_tpu's arrays, shifts and phases for every name it accepts.

Boundary handling is periodization: subband sizes halve exactly at every
level.  Analysis is a[k] = sum_j f[j] * x[(2k + j + shift) mod n];
synthesis the circular convolution of the zero-upsampled bands with the
synthesis filters at the phase that gives perfect reconstruction.

Float order (ROADMAP C8): vcf_tpu's jitted bank evaluates each of these
sums on the CPU as a chain of float32 fused multiply-adds (XLA contracts
`z + roll(x) * f`).  `fma32` evaluates such a chain exactly on any
device, and `_fma_chain` follows the order that XLA gives one jitted
axis pass, so the card's subbands equal the CPU's bit for bit and stay
within a few float32 ulp of vcf_tpu's (equal for several families); in
its fused multi-level jit XLA's order for the first pair of a chain also
depends on how it fuses, which the port does not model.  The colour
transform around the bank is `ops.color.fma_rows`, the FMA chain of
vcf_tpu's colour dot.

On the card each level is one kernel a direction (`analyze_level` /
`synthesize_level` through `ops.cuda.dwt_kernel`, csrc/dwt.cu): the same
chains in float32 intrinsics, bit for bit.  The torch chains are their
plain version, which the CPU runs, one chain a filter and band.
`DWT.clip_to_lanes` /
`lanes_to_clip` run the device path on a clip of N frames, each frame's
planes and pixels equal to the one-frame path's bit for bit; the still
codec's device path is the clip path with N = 1.  On the card their two
ends are kernels too (`ops.cuda.dwt_ends`, csrc/dwt_ends.cu): colour in,
quantizer and byte planes into the lane grid, the dequantizer read from
the grid and colour out, bit for bit with the torch chains here.

`analyze_level_rows_sharded` is one analysis level with the frame's
rows sharded over a mesh (`parallel.Mesh`): each shard's slab takes its
`halo_sizes` rows from its ring neighbours (`parallel.dist`: a copy
within a process, point-to-point across processes) and runs the same
torch FMA chains on them, so its subbands equal `analyze_level`'s bit for
bit.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from vcf_tpu_torch.codestream import CodeStream, PAYLOAD
from vcf_tpu_torch.entropy import dwt_device as dd
from vcf_tpu_torch.ops import color as color_ops
from vcf_tpu_torch.ops import dct as dct_ops
from vcf_tpu_torch.ops.cuda import _build, dwt_ends, dwt_kernel
from vcf_tpu_torch.utils import profiling
from vcf_tpu_torch.utils.timing import timed_stage


# ---------------------------------------------------------------------------
# Filter construction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def daubechies_lowpass(p: int) -> np.ndarray:
    """Orthonormal Daubechies lowpass filter of order p (length 2p).

    Spectral factorization: roots of the Daubechies half-band
    polynomial P(y) = sum_{k<p} C(p-1+k, k) y^k are mapped to z-roots
    of z + 1/z = 2 - 4y keeping |z| < 1 (minimum phase), then
    h(z) ~ (1+z)^p * prod(z - z_k), normalized to sum = sqrt(2).
    """
    if p == 1:
        return np.array([1.0, 1.0]) / math.sqrt(2.0)
    coeffs = [math.comb(p - 1 + k, k) for k in range(p)]
    yroots = np.roots(coeffs[::-1])
    zroots = []
    for y in yroots:
        bq = 2.0 - 4.0 * y
        disc = np.sqrt(bq * bq - 4.0 + 0j)
        z1, z2 = (bq + disc) / 2.0, (bq - disc) / 2.0
        zroots.append(z1 if abs(z1) < 1.0 else z2)
    poly = np.array([1.0 + 0j])
    for _ in range(p):
        poly = np.convolve(poly, [1.0, 1.0])
    for zk in zroots:
        poly = np.convolve(poly, [1.0, -zk])
    h = np.real(poly)
    h *= math.sqrt(2.0) / h.sum()
    return h


class Bank:
    """Analysis/synthesis filters + periodization phases (see
    tests/test_dwt.py for the perfect-reconstruction check)."""

    def __init__(self, dec_lo, dec_hi, rec_lo, rec_hi,
                 shift_lo=0, shift_hi=0, phase_lo=0, phase_hi=0):
        self.dec_lo = np.asarray(dec_lo, np.float32)
        self.dec_hi = np.asarray(dec_hi, np.float32)
        self.rec_lo = np.asarray(rec_lo, np.float32)
        self.rec_hi = np.asarray(rec_hi, np.float32)
        self.shift_lo, self.shift_hi = shift_lo, shift_hi
        self.phase_lo, self.phase_hi = phase_lo, phase_hi


@functools.lru_cache(maxsize=None)
def symlet_lowpass(p: int) -> np.ndarray:
    """Near-linear-phase orthonormal lowpass (Symlet) of order p.

    Same Daubechies half-band polynomial as `daubechies_lowpass`, but
    the spectral factor is chosen per conjugate-root-pair group (root
    inside vs outside the unit circle) to minimize the filter's
    deviation from linear phase — the Symlet selection rule.
    """
    if p < 2:
        return daubechies_lowpass(max(p, 1))
    import itertools

    coeffs = [math.comb(p - 1 + k, k) for k in range(p)]
    yroots = np.roots(coeffs[::-1])
    zin = []
    for y in yroots:
        bq = 2.0 - 4.0 * y
        disc = np.sqrt(bq * bq - 4.0 + 0j)
        z1, z2 = (bq + disc) / 2.0, (bq - disc) / 2.0
        zin.append(z1 if abs(z1) < 1.0 else z2)
    # group real roots singly, complex conjugate pairs jointly (a real
    # filter needs both members flipped together)
    groups, used = [], [False] * len(zin)
    for i, z in enumerate(zin):
        if used[i]:
            continue
        if abs(z.imag) < 1e-9:
            groups.append([i])
            used[i] = True
        else:
            for j in range(i + 1, len(zin)):
                if not used[j] and abs(zin[j] - np.conj(z)) < 1e-7:
                    groups.append([i, j])
                    used[i] = used[j] = True
                    break
            else:  # pragma: no cover - defensive
                groups.append([i])
                used[i] = True

    def build(zsel):
        poly = np.array([1.0 + 0j])
        for _ in range(p):
            poly = np.convolve(poly, [1.0, 1.0])
        for zk in zsel:
            poly = np.convolve(poly, [1.0, -zk])
        h = np.real(poly)
        h *= math.sqrt(2.0) / h.sum()
        return h

    w = np.linspace(0.01, np.pi * 0.8, 256)
    ns = np.arange(2 * p)

    def phase_dev(h):
        resp = np.exp(-1j * np.outer(w, ns)) @ h
        ph = np.unwrap(np.angle(resp))
        a = np.vstack([w, np.ones_like(w)]).T
        sol, *_ = np.linalg.lstsq(a, ph, rcond=None)
        return float(np.sum((ph - a @ sol) ** 2))

    best = None
    for sel in itertools.product([0, 1], repeat=len(groups)):
        zs = []
        for grp, s in zip(groups, sel):
            for i in grp:
                z = zin[i]
                zs.append(z if s == 0 else 1.0 / np.conj(z))
        h = build(zs)
        d = phase_dev(h)
        if best is None or d < best[0]:
            best = (d, h)
    return best[1]


@functools.lru_cache(maxsize=None)
def coiflet_lowpass(n: int) -> np.ndarray:
    """Coiflet-n lowpass, length 6n, support indices [-2n, 4n-1].

    coif1 is the closed form √2/32·(1-√7, 5+√7, 14+2√7, 14-2√7, 1-√7,
    -3+√7); higher orders solve the defining system (orthonormality,
    2n vanishing wavelet moments, 2n-1 vanishing scaling-function
    moments, Σh=√2) by damped least-squares continuation from
    coif(n-1).  coif2 matches the published table to ~1e-15.
    """
    s7 = math.sqrt(7.0)
    h = np.array([1 - s7, 5 + s7, 14 + 2 * s7, 14 - 2 * s7, 1 - s7, -3 + s7])
    h = h * (math.sqrt(2.0) / 32.0)
    if n == 1:
        return h
    if not 1 < n <= 5:
        raise ValueError(f"coiflet order {n} not supported (1..5)")
    from scipy.optimize import least_squares

    for order in range(2, n + 1):
        length = 6 * order
        idx = np.arange(-2 * order, 4 * order).astype(float)

        def resid(hh, length=length, idx=idx, order=order):
            r = []
            for k in range(3 * order):
                r.append(np.sum(hh[: length - 2 * k] * hh[2 * k:])
                         - (1.0 if k == 0 else 0.0))
            sgn = (-1.0) ** np.arange(length)
            for j in range(2 * order):
                r.append(np.sum(sgn * idx ** j * hh))
            r.append(np.sum(hh) - math.sqrt(2.0))
            for j in range(1, 2 * order):
                r.append(np.sum(idx ** j * hh))
            return np.array(r)

        seed = np.zeros(length)
        seed[2: 2 + len(h)] = h
        sol = least_squares(resid, seed, xtol=3e-16, ftol=3e-16,
                            gtol=3e-16, method="lm")
        if np.abs(resid(sol.x)).max() > 1e-9:  # pragma: no cover
            raise RuntimeError(f"coif{order} solve did not converge")
        h = sol.x
    return h


# -- biorthogonal spline family --------------------------------------------

def _bezout_poly(q: int) -> list:
    """Coefficients C(q-1+k, k), k = 0..q-1, of the Bezout half-band
    polynomial P(y) = Σ C(q-1+k,k) y^k (Daubechies construction)."""
    return [float(math.comb(q - 1 + k, k)) for k in range(q)]


def _poly_in_sin2(coeffs: Sequence[float]) -> np.ndarray:
    """Expand Σ c_k sin^{2k}(ω/2) into a centered Laurent filter."""
    s = np.array([-1.0, 2.0, -1.0]) / 4.0  # sin²(ω/2) as (z^-1, 1, z)
    deg = len(coeffs) - 1
    out = np.zeros(2 * deg + 1)
    for k, ck in enumerate(coeffs):
        term = np.array([ck])
        for _ in range(k):
            term = np.convolve(term, s)
        off = (len(out) - len(term)) // 2
        out[off: off + len(term)] += term
    return out


def spline_bior_filters(nr: int, nd: int):
    """CDF spline biorthogonal pair biorNr.Nd: rec_lo = B-spline(nr),
    dec_lo = complementary factor with nd vanishing moments (closed
    form; reference capability src/2D-DWT.py:22-32 via pywt)."""
    if (nr + nd) % 2:
        raise ValueError("bior orders must have equal parity")
    s2 = math.sqrt(2.0)
    rec_lo = np.array([math.comb(nr, k) for k in range(nr + 1)], float)
    rec_lo *= s2 / 2.0 ** nr
    c = np.array([1.0, 2.0, 1.0]) / 4.0  # cos²(ω/2)
    if nr % 2 == 0:
        a, b = nr // 2, nd // 2
        dec_lo = _poly_in_sin2(_bezout_poly(a + b))
    else:
        a, b = (nr - 1) // 2, (nd - 1) // 2
        dec_lo = np.convolve(
            _poly_in_sin2(_bezout_poly(a + b + 1)), np.array([1.0, 1.0]) / 2.0
        )
    for _ in range(b):
        dec_lo = np.convolve(dec_lo, c)
    dec_lo = dec_lo * s2
    alt = lambda f: np.array([(-1.0) ** k for k in range(len(f))]) * f[::-1]
    return dec_lo, alt(rec_lo), rec_lo, alt(dec_lo)


def cdf97_filters():
    """CDF 9/7 (JPEG2000 irrational) pair — pywt's `bior4.4`.

    Same q=4 Bezout polynomial as the spline 4.4, but factored: the
    real root goes to synthesis, the complex pair to analysis; both
    sides keep a (cos²)² spline factor.
    """
    p = _bezout_poly(4)  # 1 + 4y + 10y² + 20y³
    roots = np.roots(p[::-1])
    real = [r for r in roots if abs(r.imag) < 1e-9]
    cplx = [r for r in roots if abs(r.imag) >= 1e-9]
    # B(y) = 1 - y/r₁ (real root → synthesis); A(y) = Π(1 - y/rᵢ) over
    # the complex pair (→ analysis).  A(0)=B(0)=1 ⇒ A·B = P exactly.
    b_coeffs = [1.0, -1.0 / real[0].real]  # ascending powers of y
    a_coeffs = np.real(
        np.convolve([1.0, -1.0 / cplx[0]], [1.0, -1.0 / cplx[1]])
    )
    s2 = math.sqrt(2.0)
    c = np.array([1.0, 2.0, 1.0]) / 4.0
    dec_lo = _poly_in_sin2(a_coeffs)
    rec_lo = _poly_in_sin2(b_coeffs)
    for _ in range(2):
        dec_lo = np.convolve(dec_lo, c)
        rec_lo = np.convolve(rec_lo, c)
    dec_lo, rec_lo = dec_lo * s2, rec_lo * s2
    alt = lambda f: np.array([(-1.0) ** k for k in range(len(f))]) * f[::-1]
    return dec_lo, alt(rec_lo), rec_lo, alt(dec_lo)


# -- periodization-phase auto-calibration ----------------------------------

def _np_down(x, f, shift):
    z = np.zeros_like(x)
    for j, fj in enumerate(f):
        z = z + np.roll(x, -(j + shift)) * fj
    return z[::2]


def _np_up(a, f, phase, n):
    up = np.zeros(n)
    up[::2] = a
    y = np.zeros(n)
    for j, fj in enumerate(f):
        y = y + np.roll(up, j + phase) * fj
    return y


def _calibrate(dec_lo, dec_hi, rec_lo, rec_hi, name: str) -> Bank:
    """Find periodization shifts/phases giving exact PR (≤1e-8 on a
    random signal); the highpass synthesis sign is folded into rec_hi."""
    rng = np.random.default_rng(42)
    n = 64
    x = rng.normal(size=n)
    lmax = max(len(dec_lo), len(dec_hi), len(rec_lo), len(rec_hi))
    r = range(-(lmax + 2), lmax + 3)
    cl, ch = -(len(dec_lo) // 2), -(len(dec_hi) // 2)
    for sl in (cl, cl + 1):
        lo = _np_down(x, dec_lo, sl)
        for sh in (ch, ch + 1):
            hi = _np_down(x, dec_hi, sh)
            for pl in r:
                ylo = _np_up(lo, rec_lo, pl, n)
                for sgn in (1.0, -1.0):
                    for ph in r:
                        y = ylo + sgn * _np_up(hi, rec_hi, ph, n)
                        if np.abs(y - x).max() < 1e-8:
                            return Bank(dec_lo, dec_hi, rec_lo,
                                        sgn * np.asarray(rec_hi),
                                        shift_lo=sl, shift_hi=sh,
                                        phase_lo=pl, phase_hi=ph)
    raise ValueError(f"no PR phase alignment found for {name!r}")


#: the biorthogonal grid pywt ships (reference -w accepts any of these,
#: src/2D-DWT.py:22-32)
BIOR_ORDERS = {
    (1, 1), (1, 3), (1, 5),
    (2, 2), (2, 4), (2, 6), (2, 8),
    (3, 1), (3, 3), (3, 5), (3, 7), (3, 9),
    (4, 4), (5, 5), (6, 8),
}


@functools.lru_cache(maxsize=None)
def get_bank(name: str) -> Bank:
    if name == "haar":
        name = "db1"
    if name.startswith("db"):
        p = int(name[2:])
        h = daubechies_lowpass(p)
        g = np.array([(-1) ** k for k in range(len(h))]) * h[::-1]
        # orthonormal: synthesis = adjoint of analysis (same filters,
        # zero phases)
        return Bank(h, g, h, g)
    if name.startswith("sym"):
        h = symlet_lowpass(int(name[3:]))
        g = np.array([(-1) ** k for k in range(len(h))]) * h[::-1]
        return Bank(h, g, h, g)
    if name.startswith("coif"):
        h = coiflet_lowpass(int(name[4:]))
        g = np.array([(-1) ** k for k in range(len(h))]) * h[::-1]
        return Bank(h, g, h, g)
    if name in ("bior2.2", "legall53"):
        s2 = math.sqrt(2.0)
        dec_lo = np.array([-1, 2, 6, 2, -1], np.float64) / 8.0 * s2
        dec_hi = np.array([-1, 2, -1], np.float64) / 2.0 / s2
        rec_lo = np.array([1, 2, 1], np.float64) / 2.0 / s2
        rec_hi = np.array([-1, -2, 6, -2, -1], np.float64) / 8.0 * s2
        # PR phases found analytically/numerically (tests/test_dwt.py)
        return Bank(dec_lo, dec_hi, rec_lo, rec_hi,
                    shift_lo=-2, shift_hi=0, phase_lo=-1, phase_hi=-1)
    if name in ("cdf97", "jpeg2000"):
        return _calibrate(*cdf97_filters(), name=name)
    if name.startswith(("bior", "rbio")):
        try:
            nr, nd = (int(t) for t in name[4:].split("."))
        except ValueError:
            raise ValueError(f"unknown wavelet {name!r}") from None
        if (nr, nd) not in BIOR_ORDERS:
            raise ValueError(f"unsupported bior orders {name!r}")
        if (nr, nd) == (4, 4):
            filters = cdf97_filters()  # pywt bior4.4 IS the CDF 9/7
        else:
            filters = spline_bior_filters(nr, nd)
        if name.startswith("rbio"):
            dl, dh, rl, rh = filters
            filters = (rl, rh, dl, dh)
        return _calibrate(*filters, name=name)
    raise ValueError(f"unknown wavelet {name!r}")


# ---------------------------------------------------------------------------
# Periodized single-axis filter bank (torch)
# ---------------------------------------------------------------------------

def fma32(a: torch.Tensor, w: float, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add: a * w + c rounded once to float32, for
    float32 `a` and `c` and a float32-valued `w`, from float64 ops on any
    device.  The product is exact in float64; the sum s rounds there, and
    its error e (s + e = a * w + c exactly, by TwoSum) decides the one case
    in which rounding s to float32 again is wrong: s on a float32 midpoint
    that the exact sum is not on."""
    p = a.to(torch.float64) * w
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    up = s > r64
    nb = torch.nextafter(r, torch.where(up, torch.full_like(r, math.inf),
                                        torch.full_like(r, -math.inf)))
    fix = (err != 0) & (s == (r64 + nb.to(torch.float64)) * 0.5) \
        & ((err > 0) == up)
    return torch.where(fix, nb, r)


def _fuses_first(f0: float, f1: float, plain0: bool) -> bool:
    """Which product of the first pair x0 * f0 + x1 * f1 XLA fuses in one
    jitted axis pass: True for fma(x0, f0, x1 * f1), False for
    fma(x1, f1, x0 * f0).  Found by testing both against XLA's CPU output
    for every filter family (ROADMAP C8): with mixed signs the sum becomes
    a subtraction, which fuses its positive product; with equal signs the
    first product is fused unless its input is the un-rolled x itself
    (`plain0`, a roll by 0)."""
    if (f0 < 0) != (f1 < 0):
        return f0 >= 0
    return not plain0


def _fma_chain(gather, filt: np.ndarray, plain0: bool) -> torch.Tensor:
    """sum_j filt[j] * gather(j) as vcf_tpu's jitted bank evaluates it on
    the CPU: one float32 product, fused with the other product of the
    first pair as `_fuses_first` says, then one fused multiply-add per
    later tap."""
    f = filt.tolist()
    if len(f) == 1:
        return gather(0) * f[0]
    if _fuses_first(f[0], f[1], plain0):
        z = fma32(gather(0), f[0], gather(1) * f[1])
    else:
        z = fma32(gather(1), f[1], gather(0) * f[0])
    for j in range(2, len(f)):
        z = fma32(gather(j), f[j], z)
    return z


def _down_axis(x: torch.Tensor, filt: np.ndarray, shift: int,
               axis: int) -> torch.Tensor:
    """a[k] = sum_j f[j] * x[(2k + j + shift) mod n] along `axis`."""
    n = x.shape[axis]
    even = torch.arange(0, n, 2, device=x.device)
    return _fma_chain(
        lambda j: x.index_select(axis, (even + j + shift) % n), filt,
        plain0=shift % n == 0)


def _down_pair(x: torch.Tensor, bank: Bank, axis: int) -> torch.Tensor:
    """`_down_axis` of the lowpass and the highpass along `axis`, stacked
    on a new leading axis."""
    return torch.stack([_down_axis(x, bank.dec_lo, bank.shift_lo, axis),
                        _down_axis(x, bank.dec_hi, bank.shift_hi, axis)])


def _upsampled(a: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """a_up of length n along `axis`: a_up[2k] = a[k], 0 at odd places."""
    am = a.movedim(axis, 0)
    up = am.new_zeros((n,) + tuple(am.shape[1:]))
    up[::2] = am
    return up.movedim(0, axis)


def _up_axis(a: torch.Tensor, filt: np.ndarray, phase: int, axis: int,
             n: int) -> torch.Tensor:
    """y[m] = sum_j f[j] * a_up[(m - j - phase) mod n], a_up[2k] = a[k]
    and 0 at odd positions (the zero terms are kept: the chain is
    vcf_tpu's, term for term; one product of the first pair is always 0,
    so its fusing order does not matter)."""
    up = _upsampled(a, axis, n)
    m = torch.arange(n, device=a.device)
    return _fma_chain(
        lambda j: up.index_select(axis, (m - j - phase) % n), filt,
        plain0=phase % n == 0)


def _up_pairs(a: torch.Tensor, bank: Bank, axis: int,
              n: int) -> torch.Tensor:
    """`_up_axis` of stacked bands (leading axis) that alternate between
    the lowpass and the highpass band of a pair, each through its own
    synthesis filter and phase."""
    pairs = a.shape[0] // 2
    filts = (bank.rec_lo, bank.rec_hi) * pairs
    phases = (bank.phase_lo, bank.phase_hi) * pairs
    return torch.stack([_up_axis(b, f, p, axis - 1, n)
                        for b, f, p in zip(a, filts, phases)])


def kernel_args(bank: Bank, n_rows: int, n_cols: int,
                synthesis: bool = False) -> tuple:
    """(taps, ints) of one level of `bank` as the level kernels take them
    (`ops.cuda.dwt_kernel`), its passes along n_rows and n_cols
    (analysis: the input's H and W): the float32 taps, lowpass then
    highpass, each in chain order; for analysis (len_lo, len_hi,
    shift_lo, shift_hi, then `_fuses_first` of the lowpass and the
    highpass along the rows and along the columns, which depends on each
    pass's length), for synthesis (len_lo, len_hi, phase_lo, phase_hi),
    whose chains fuse no first pair (one of its terms is a zero of the
    upsampled band)."""
    lo, hi = ((bank.rec_lo, bank.rec_hi) if synthesis
              else (bank.dec_lo, bank.dec_hi))
    taps = tuple(lo.tolist()) + tuple(hi.tolist())
    if synthesis:
        return taps, (len(lo), len(hi), bank.phase_lo, bank.phase_hi)
    shifts = (bank.shift_lo, bank.shift_hi)

    def fuses(f, shift, n):
        return int(len(f) > 1 and _fuses_first(float(f[0]), float(f[1]),
                                               shift % n == 0))

    return taps, (len(lo), len(hi), *shifts,
                  *(fuses(f, s, n) for n in (n_rows, n_cols)
                    for f, s in ((lo, shifts[0]), (hi, shifts[1]))))


def _check_float32(what: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: float32 input, got {t.dtype}")


def analyze_level(x: torch.Tensor, bank: Bank, axis: int = 0):
    """One level of float32 `x` over the rows at `axis` and the columns at
    `axis + 1`, both even (leading axes: frames, each transformed alone by
    the same chains; trailing axes: channels) -> (LL, (LH, HL, HH)): on
    the card one kernel (`ops.cuda.dwt_kernel`), on the CPU its plain
    version `analyze_level_ref`, bit for bit alike, in a `vcf.dwt.bank`
    span."""
    _check_float32("analyze_level", x)
    _, h, w, _ = dwt_kernel.level_dims(x.shape, axis, "analyze_level")
    if h % 2 or w % 2:
        raise ValueError(f"analyze_level: odd length {h} x {w} at axes "
                         f"{axis}, {axis + 1} of {tuple(x.shape)}")
    with profiling.span("vcf.dwt.bank"):
        if _build.runs_plain(x):
            return analyze_level_ref(x, bank, axis)
        return dwt_kernel.analyze_level(x, *kernel_args(bank, h, w), axis)


def analyze_level_ref(x: torch.Tensor, bank: Bank, axis: int = 0):
    """Plain version of `analyze_level`: the torch FMA chains."""
    return _column_bands(_down_pair(x, bank, axis), bank, axis + 1)


def _column_bands(rows: torch.Tensor, bank: Bank, col: int):
    """The column passes (columns at `col` of each row pass) of the
    stacked (lowpass, highpass) row passes, each row pass through both
    column filters -> (LL, (LH, HL, HH))."""
    cols = _down_pair(rows, bank, col + 1)     # [column filter, row filter]
    return cols[0, 0], (cols[1, 0], cols[0, 1], cols[1, 1])


def synthesize_level(ll: torch.Tensor, details, bank: Bank, out_hw,
                     axis: int = 0):
    """Inverse of analyze_level: LL and (LH, HL, HH), float32 (..., h, w,
    ...) on one device, `out_hw` = (2h, 2w) -> (..., 2h, 2w, ...): along
    the columns LL + LH -> the lowpass rows and HL + HH -> the highpass
    rows, then along the rows their sum; the kernel or its plain version
    `synthesize_level_ref`, as `analyze_level`."""
    bands = (ll,) + tuple(details)
    _check_float32("synthesize_level", *bands)
    _, h, w, _ = dwt_kernel.level_dims(ll.shape, axis, "synthesize_level")
    if len(bands) != 4 or any(x.shape != ll.shape or x.device != ll.device
                              for x in bands):
        raise ValueError("synthesize_level: LL and three detail bands of "
                         f"one shape and device, got "
                         f"{[tuple(x.shape) for x in bands]}")
    if tuple(out_hw) != (2 * h, 2 * w):
        raise ValueError(f"synthesize_level: output {tuple(out_hw)} from "
                         f"{h} x {w} bands (odd length or not twice the "
                         "bands)")
    with profiling.span("vcf.dwt.bank"):
        if _build.runs_plain(ll):
            return synthesize_level_ref(ll, details, bank, out_hw, axis)
        return dwt_kernel.synthesize_level(
            bands, *kernel_args(bank, 2 * h, 2 * w, synthesis=True), axis)


def synthesize_level_ref(ll: torch.Tensor, details, bank: Bank, out_hw,
                         axis: int = 0):
    """Plain version of `synthesize_level`: the torch FMA chains."""
    h_out, w_out = out_hw
    cols = _up_pairs(torch.stack((ll,) + tuple(details)), bank, axis + 2,
                     w_out)
    rows = _up_pairs(cols[0::2] + cols[1::2], bank, axis + 1, h_out)
    return rows[0] + rows[1]


def halo_sizes(bank: Bank) -> Tuple[int, int]:
    """(before, after) halo rows a shard needs for one analyze level:
    output a[k] reads input rows 2k + j + shift for j in [0, len) and
    both filters, so `before` covers the most negative j + shift and
    `after` the largest."""
    lo_min = min(bank.shift_lo, bank.shift_hi)
    hi_max = max(len(bank.dec_lo) - 1 + bank.shift_lo,
                 len(bank.dec_hi) - 1 + bank.shift_hi)
    return max(0, -lo_min), max(0, hi_max)


def _down_rows_from_ext(ext: torch.Tensor, filt: np.ndarray, shift: int,
                        before: int, h_local: int, n_rows: int
                        ) -> torch.Tensor:
    """Row-direction analysis on a halo-extended slab: out[k] = sum_j
    f[j] * ext[before + 2k + j + shift] for 2k in [0, h_local), the chain
    `_down_axis` runs on the whole frame of `n_rows` rows."""
    return _fma_chain(
        lambda j: ext[before + j + shift:before + j + shift + h_local:2],
        filt, plain0=shift % n_rows == 0)


def analyze_level_rows_sharded(slabs: Sequence[torch.Tensor], bank: Bank,
                               mesh):
    """One analysis level with the frame's rows sharded over `mesh`, by
    the torch FMA chains on every device (its slabs are halo-extended,
    with no periodic wrap along the rows, which the level kernel does not
    take; no benchmark cell runs it):
    `slabs` holds each shard's (h_local, w, ...) row slab on its device
    (h_local even and >= both halos; across the mesh's processes, every
    slab the same height), in frame order.  The halos wrap around the
    ring as `_down_axis`'s periodic rows do (shard 0 receives the last
    shard's rows, vcf_tpu's ppermute).  Returns (ll, (lh, hl, hh)), each
    a list of the shards' h_local // 2 row slabs."""
    from vcf_tpu_torch.parallel import dist

    before, after = halo_sizes(bank)
    h_local = slabs[0].shape[0]
    if h_local % 2 or h_local < max(before, after):
        raise ValueError(f"slabs of {h_local} rows: need an even height "
                         f">= {max(before, after)}")
    n_rows = h_local * len(slabs) * dist._group_size(mesh)
    heads = (dist._ring_shift([x[h_local - before:] for x in slabs], mesh, 1)
             if before else [None] * len(slabs))
    tails = (dist._ring_shift([x[:after] for x in slabs], mesh, -1)
             if after else [None] * len(slabs))
    bands = []
    for x, head, tail in zip(slabs, heads, tails):
        ext = torch.cat([p for p in (head, x, tail) if p is not None])
        lo = _down_rows_from_ext(ext, bank.dec_lo, bank.shift_lo, before,
                                 h_local, n_rows)
        hi = _down_rows_from_ext(ext, bank.dec_hi, bank.shift_hi, before,
                                 h_local, n_rows)
        ll, details = _column_bands(torch.stack([lo, hi]), bank, 1)
        bands.append((ll,) + details)
    ll, lh, hl, hh = (list(b) for b in zip(*bands))
    return ll, (lh, hl, hh)


def analyze(x: torch.Tensor, wavelet: str, levels: int,
            axis: int = 0) -> list:
    """[LL_L, (LH,HL,HH)_L, ..., (LH,HL,HH)_1] like pywt.wavedec2 /
    the reference's list layout (src/2D-DWT.py:113-136); the rows at
    `axis`, the columns at `axis + 1`."""
    bank = get_bank(wavelet)
    details = []
    cur = x
    for _ in range(levels):
        cur, d = analyze_level(cur, bank, axis)
        details.append(d)
    return [cur] + details[::-1]


def synthesize(decomp: list, wavelet: str, axis: int = 0) -> torch.Tensor:
    bank = get_bank(wavelet)
    cur = decomp[0]
    for details in decomp[1:]:
        out_hw = (details[0].shape[axis] * 2, details[0].shape[axis + 1] * 2)
        cur = synthesize_level(cur, details, bank, out_hw, axis)
    return cur


# ---------------------------------------------------------------------------
# Pipeline flow (invoked from vcf_tpu_torch.pipeline.Codec)
# ---------------------------------------------------------------------------

#: below this many symbols the context tables sidecar (n_ctx x larger)
#: outweighs the order-1 stream saving; cgrans stays order-0
CTX_MIN_SYMBOLS = 2_000_000

#: entropy codecs whose DWT flow with the deadzone quantizer is the
#: one-grid device path (every other quantizer takes the host path)
DEVICE_ENTROPY = ("grans", "rans", "cgrans")


class DWT:
    def __init__(self, wavelet: str, levels: int):
        get_bank(wavelet)           # an unknown name raises here
        self.wavelet = wavelet
        self.levels = levels

    def subband_names(self) -> List[str]:
        """Coarsest-first, matching the reference's stream naming
        `{fn}_LL_{L}`, `{fn}_{LH|HL|HH}_{r}` (src/2D-DWT.py:162-200)."""
        names = [f"LL_{self.levels}"]
        for lvl in range(self.levels, 0, -1):
            names += [f"LH_{lvl}", f"HL_{lvl}", f"HH_{lvl}"]
        return names

    def flatten(self, decomp) -> list:
        flat = [decomp[0]]
        for d in decomp[1:]:
            flat.extend(d)
        return flat

    def unflatten(self, flat) -> list:
        decomp = [flat[0]]
        for i in range(self.levels):
            decomp.append(tuple(flat[1 + 3 * i: 4 + 3 * i]))
        return decomp

    # ------------------------------------------------------------------
    # Device math shared by both paths
    # ------------------------------------------------------------------
    @staticmethod
    def _matrix(codec, inverse: bool):
        """The configured colour matrix (forward or inverse), None for
        color="none"."""
        name = codec.config.color
        name = "ycocg" if name == "ycocg_r" else name
        if name == "none":
            return None
        return color_ops.MATRICES[name][int(inverse)]

    @staticmethod
    def _color(codec, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        m = DWT._matrix(codec, inverse)
        return x.to(torch.float32) if m is None else color_ops.fma_rows(x, m)

    def _analysis(self, codec, img: np.ndarray) -> list:
        """u8 image -> the flat float32 subbands, coarsest first."""
        return self._bands(codec, codec._upload(img), axis=0)

    def _bands(self, codec, x: torch.Tensor, axis: int) -> list:
        """u8 pixels with the rows at `axis` -> the flat float32 subbands,
        coarsest first."""
        padded = dct_ops.pad_centered(x.to(torch.float32), 1 << self.levels,
                                      axis)
        ct = self._color(codec, padded - codec.spatial_offset, inverse=False)
        return self.flatten(analyze(ct, self.wavelet, self.levels, axis))

    def _synthesis(self, codec, flat: list, shape) -> np.ndarray:
        """Flat dequantized subbands -> the u8 image of `shape`."""
        return self._pixels(codec, flat, shape, axis=0).cpu().numpy()

    def _pixels(self, codec, flat: list, shape, axis: int) -> torch.Tensor:
        """Flat dequantized subbands with the rows at `axis` -> u8 pixels
        of (H, W) `shape[:2]`, on their device."""
        ct = synthesize(self.unflatten(flat), self.wavelet, axis)
        y = self._color(codec, ct, inverse=True) + codec.spatial_offset
        y = dct_ops.unpad_centered(y, shape, axis)
        return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)

    def _band_shapes(self, img_shape) -> list:
        """Padded subband shapes, coarsest-first, matching flatten()."""
        m = 1 << self.levels
        hp = -(-img_shape[0] // m) * m
        wp = -(-img_shape[1] // m) * m
        c = img_shape[2] if len(img_shape) == 3 else 1
        shapes = [(hp >> self.levels, wp >> self.levels, c)]
        for lvl in range(self.levels, 0, -1):
            s = (hp >> lvl, wp >> lvl, c)
            shapes += [s, s, s]
        return shapes

    def _grid_sizes(self, img_shape) -> list:
        """Symbols per grid group: LL's two byte planes, then each band."""
        shapes = self._band_shapes(img_shape)
        return [int(np.prod(shapes[0]))] * 2 + [int(np.prod(s))
                                                for s in shapes[1:]]

    # ------------------------------------------------------------------
    # Host path: one entropy stream per subband
    # ------------------------------------------------------------------
    def encode(self, codec, img: np.ndarray) -> CodeStream:
        cfg = codec.config
        if cfg.entropy in DEVICE_ENTROPY and cfg.quantizer == "deadzone":
            return self.encode_device(codec, img)
        t = codec.last_timings
        with timed_stage(t, "device:analyze+quantize"):
            stored, qsides = [], []
            for i, band in enumerate(self._analysis(codec, img)):
                k, qside = codec._quantize(band)
                # LL as uint16, details as uint8, both +128, wrapping as
                # the reference's casts (src/2D-DWT.py:162-200)
                stored.append((k.cpu().numpy() + 128).astype(
                    np.uint16 if i == 0 else np.uint8))
                qsides.append(qside)
        names = self.subband_names()
        cs = CodeStream()
        cs.put_shape(img.shape)
        with timed_stage(t, "entropy"):
            for name, arr, qside in zip(names, stored, qsides):
                payload, side = codec.entropy_codec.encode(arr)
                cs[name] = payload
                for sname, blob in side.items():
                    cs[f"{name}.{sname}"] = blob
                for sname, arr_q in qside.items():
                    cs.put_array(f"{name}.q_{sname}", arr_q)
        cs.put_json(PAYLOAD, {
            "subbands": names, "levels": self.levels, "wavelet": self.wavelet,
        })
        return cs

    def decode(self, codec, cs: CodeStream) -> np.ndarray:
        meta = cs.get_json(PAYLOAD)
        if meta.get("device"):
            return self.decode_device(codec, cs)
        shape = cs.get_shape()
        t = codec.last_timings
        ks, qsides = [], []
        with timed_stage(t, "entropy"):
            for name in meta["subbands"]:
                side = {
                    sname.split(".", 1)[1]: cs[sname]
                    for sname in cs
                    if sname.startswith(f"{name}.")
                    and not sname.split(".", 1)[1].startswith("q_")
                }
                stored = codec.entropy_codec.decode(cs[name], side)
                qsides.append({
                    sname.split(".q_", 1)[1]: cs.get_array(sname)
                    for sname in cs if sname.startswith(f"{name}.q_")})
                k = stored.astype(np.int32)
                if stored.dtype == np.uint16:
                    # undo the uint16 wrap of negative LL indexes
                    k = np.where(k >= 32768, k - 65536, k)
                k = k - 128
                if codec.config.quantizer == "vq" and stored.dtype == np.uint8:
                    # a detail band's labels wrapped through uint8 (+128):
                    # recover them, where vcf_tpu's decode raises on the
                    # label map's 2-D shape (ROADMAP C11)
                    k = k % 256
                ks.append(k)
        with timed_stage(t, "device:dequantize+synthesize"):
            flat = [codec._dequantize(torch.from_numpy(k).to(codec.device),
                                      qside, band_shape)
                    for k, qside, band_shape in zip(
                        ks, qsides, self._band_shapes(shape))]
            return self._synthesis(codec, flat, shape)

    # ------------------------------------------------------------------
    # Device path: every subband one group of one grouped-rANS grid
    # (per-band tables keep the reference's per-band statistics,
    # src/2D-DWT.py:162-200, without its per-band streams)
    # ------------------------------------------------------------------
    @staticmethod
    def _byte_planes(codec, bands: list) -> list:
        """The grid's u8 byte planes of flat subbands (any leading frame
        axis): LL's index + 128 as two bytes (high, low), each detail
        band's index + 128 wrapped to a byte."""
        planes = []
        for i, band in enumerate(bands):
            k = codec._quantize(band)[0] + 128
            if i == 0:
                v = k & 0xFFFF
                planes.append(((v >> 8) & 0xFF).to(torch.uint8))
                planes.append((v & 0xFF).to(torch.uint8))
            else:
                planes.append((k & 0xFF).to(torch.uint8))
        return planes

    def _grid_bands(self, codec, img: np.ndarray) -> list:
        """One image's byte planes, from its subbands alone."""
        return self._byte_planes(codec, self._analysis(codec, img))

    def _grid_flat(self, codec, bands: list, shapes: list) -> list:
        """Inverse of _byte_planes, dequantized: byte planes -> the flat
        float32 subbands."""
        qss = codec.config.qss
        hi, lo = bands[0].to(torch.int32), bands[1].to(torch.int32)
        v = (hi << 8) | lo
        ks = [torch.where(v >= 32768, v - 65536, v) - 128]
        # u8-wrapped stored index: v - 128 lands in [-128, 127]
        ks += [b.to(torch.int32) - 128 for b in bands[2:]]
        return [(k.to(torch.float32) * qss).reshape(s)
                for k, s in zip(ks, shapes)]

    def clip_to_lanes(self, codec, frames: torch.Tensor) -> torch.Tensor:
        """A clip's lane grid: u8 frames (N, H, W, 3) on the device ->
        colour -> the bank -> the deadzone quantizer -> byte planes -> the
        (G * sg * N, L) u8 lanes of `entropy.dwt_device.bands_to_grid`,
        (sg, L) from one frame's subband sizes, all in a `vcf.dwt.analyze`
        span.  Each frame's planes equal `_grid_bands`' of that frame
        alone, bit for bit: the chains are elementwise over the frame axis.
        On the card the two ends are kernels (`ops.cuda.dwt_ends`: the
        colour with the cast, pad and offset; the quantizer and byte
        planes written straight into the grid), so `bands_to_grid`'s copy
        is not made; a CPU clip takes their plain versions, the torch
        chains and `bands_to_grid`."""
        if codec.config.quantizer != "deadzone":
            raise ValueError("the DWT lane grid takes the deadzone "
                             f"quantizer, not {codec.config.quantizer!r}")
        sg, l = dd.grid_dims(self._grid_sizes(frames.shape[1:]))
        with profiling.span("vcf.dwt.analyze"):
            if not _build.runs_plain(frames):
                x = dwt_ends.color_in(frames, self._matrix(codec, False),
                                      codec.spatial_offset, 1 << self.levels)
                bands = self.flatten(analyze(x, self.wavelet, self.levels,
                                             axis=1))
                del x
                return dwt_ends.bands_to_lanes(bands, codec.config.qss, sg, l)
            planes = self._byte_planes(codec,
                                       self._bands(codec, frames, axis=1))
        return dd.bands_to_grid(planes, sg, l, frames=frames.shape[0])

    def lanes_to_clip(self, codec, lanes: torch.Tensor, shape
                      ) -> torch.Tensor:
        """Inverse of clip_to_lanes: (G * sg * N, L) u8 lanes -> the u8
        frames (N, H, W, C) of one frame's `shape` (H, W, C), on the
        lanes' device; dequantizer, bank and colour in a
        `vcf.dwt.synthesize` span.  On the card the dequantizer reads the
        grid where it lies (K3's transposed view included) and the inverse
        colour writes the u8 frames (`ops.cuda.dwt_ends`), so
        `grid_to_bands`' copy is not made; a CPU grid takes the plain
        versions."""
        sizes = self._grid_sizes(shape)
        sg, _ = dd.grid_dims(sizes)
        n = lanes.shape[0] // (len(sizes) * sg)
        shapes = [(n,) + s for s in self._band_shapes(shape)]
        if not _build.runs_plain(lanes):
            with profiling.span("vcf.dwt.synthesize"):
                flat = dwt_ends.lanes_to_bands(lanes, codec.config.qss,
                                               shapes)
                ct = synthesize(self.unflatten(flat), self.wavelet, axis=1)
                del flat
                return dwt_ends.color_out(ct, self._matrix(codec, True),
                                          codec.spatial_offset, shape[:2])
        bands = dd.grid_to_bands(lanes, sizes, sg, frames=n)
        with profiling.span("vcf.dwt.synthesize"):
            flat = self._grid_flat(codec, bands, shapes)
            return self._pixels(codec, flat, shape, axis=1)

    def encode_device(self, codec, img: np.ndarray) -> CodeStream:
        cfg = codec.config
        t = codec.last_timings
        sizes = self._grid_sizes(img.shape)
        sg, l = dd.grid_dims(sizes)
        g = len(sizes)
        with timed_stage(t, "device:analyze+quantize"):
            lanes = self.clip_to_lanes(codec, codec._upload(img)[None])
        # cgrans: per-(band, prev-class) tables over the lane-major raster
        # layout; small inputs stay order 0, where the n_ctx-times tables
        # sidecar would outweigh the gain
        n_ctx = 0
        if cfg.entropy == "cgrans" and sum(sizes) >= CTX_MIN_SYMBOLS:
            n_ctx = cfg.context_classes
        with timed_stage(t, "entropy"):
            if n_ctx:
                fg, cg = dd.train_ctx_tables(lanes, g, n_ctx)
            else:
                fg, cg = dd.train_tables(lanes, g)
            words, n_words, states, counts = dd.encode_grid(lanes, fg, cg)
        cs = CodeStream()
        cs.put_shape(img.shape)
        # the DWT schema keeps its meta JSON under the "payload" segment
        # name (the host path's layout), so the words get their own
        cs["gdwt_words"] = words.astype("<u2").tobytes()
        cs["gdwt_model"] = dd.pack_model(
            g, sg, l, n_words, cfg.qss, states, counts, fg, n_ctx=n_ctx)
        cs.put_json(PAYLOAD, {
            "subbands": self.subband_names(), "levels": self.levels,
            "wavelet": self.wavelet, "device": True,
        })
        return cs

    def decode_device(self, codec, cs: CodeStream) -> np.ndarray:
        shape = cs.get_shape()
        t = codec.last_timings
        with timed_stage(t, "entropy"):
            (g, sg, l, n_words, _, states, counts, fg, cg,
             _) = dd.unpack_model(cs["gdwt_model"])
            words = np.frombuffer(cs["gdwt_words"], "<u2")[:n_words]
            lanes = dd.decode_grid(words, states, counts, fg, cg, l,
                                   codec.device)
        with timed_stage(t, "device:dequantize+synthesize"):
            return self.lanes_to_clip(codec, lanes, shape)[0].cpu().numpy()
