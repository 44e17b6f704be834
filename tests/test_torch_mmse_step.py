"""The recurrence step of the CUDA kernels (`csrc/mmse.cuh`: mmse_frame,
mmse_step), emulated in numpy float32 in the step's own evaluation order,
with exact 1/x, 1/sqrt(x) and 2^x in place of the MUFU instructions: held
against the plain version (`torch.special.i0e`/`i1e`) on a grid of
(xi, gamma) that spans both Bessel branches and every clip point, and over
an 860-frame recurrence, within half of the MMSE kernel's tolerance (rtol
1e-4, atol 2e-5), which leaves the other half for the MUFU's ulps. Also
against the JAX package's Pallas kernel in interpret mode; the tests that
need JAX import it themselves, so the others run without it."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.mmse_stsa import ref as MR

CUH = (Path(MR.__file__).resolve().parents[1] / "csrc" / "mmse.cuh")
RTOL, ATOL = 0.5e-4, 1e-5          # half of the kernel's rtol 1e-4, 2e-5
f32 = np.float32
XI_MIN = f32(0.0031622776601683794)
GAMMA_MAX = f32(10000.0)
SQRTPI_2 = f32(0.886226925452758)
SQRT2 = f32(1.4142135623730951)
LOG2E = f32(1.4426950408889634)


def written_out(fn):
    """The coefficients mmse.cuh passes to `fn`: [((c, ...), i), ...]."""
    return [(tuple(float(a) for a in m.group(1).split(",")[:-1]),
             int(m.group(1).split(",")[-1]))
            for m in re.finditer(rf"{fn}\(([-0-9., ]+)\)", CUH.read_text())]


# the step's tables, rounded once to f32 from double as mmse.cuh does
_SMALL = written_out("mmse_small")
S0 = [f32(c / (3.75 * 3.75) ** i) for (c,), i in _SMALL[:7]]
S1 = [f32(c / (3.75 * 3.75) ** i) for (c,), i in _SMALL[7:]]
L0 = [f32(c * 3.75 ** i) for (c,), i in written_out("mmse_large")]
L01 = [f32((a + b) * 3.75 ** i)
       for (a, b), i in written_out("mmse_large_sum")]


def rcp(x):
    return (1.0 / np.float64(x)).astype(f32)


def rsqrt(x):
    return (1.0 / np.sqrt(np.float64(x))).astype(f32)


def ex2(x):
    return np.exp2(np.float64(x)).astype(f32)


def fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def split_horner(c, x, x2):
    """Even and odd coefficients as Horner chains in x^2, joined by one
    FMA (mmse_split7 / mmse_split9)."""
    ev, od = c[::2], c[1::2]
    e, o = ev[-1], od[-1]
    for ci in reversed(ev[:-1]):
        e = fma(e, x2, ci)
    for ci in reversed(od[:-1]):
        o = fma(o, x2, ci)
    return fma(x, o, e)


def frame(p, inv_lam, alpha):
    """mmse_frame: (hg, prior, ag, c) from the power alone."""
    alpha = f32(alpha)
    gamma = np.minimum(np.maximum(p * inv_lam, f32(1e-8)), GAMMA_MAX)
    return (f32(0.5) * gamma,
            (f32(1) - alpha) * np.maximum(gamma - f32(1), f32(0)),
            alpha * gamma, SQRTPI_2 * rcp(gamma))


def step(fr, g2, ag):
    """mmse_step: (gain clipped to 10, next g2, next ag)."""
    hg, prior, ag_next, c = fr
    xi = np.maximum(fma(g2, ag, prior), XI_MIN)
    h = np.maximum(xi * hg * rcp(f32(1) + xi), f32(0.5) * f32(1e-8))
    r = rsqrt(h)
    e = ex2(h * -LOG2E)
    with np.errstate(over="ignore", invalid="ignore"):
        x = h * h
        x2 = x * x
        p0, p1 = split_horner(S0, x, x2), split_horner(S1, x, x2)
        w = r * r
        w2 = w * w
        q0, q01 = split_horner(L0, w, w2), split_horner(L01, w, w2)
        small = h <= f32(3.75)
        a0 = np.where(small, p0, q0)
        a01 = np.where(small, fma(h, p1, p0), q01)
        m = np.where(small, e * (SQRT2 * h) * r, SQRT2)
    g = (c * m) * fma(h + h, a01, a0)
    return np.minimum(g, f32(10)), np.minimum(g * g, f32(100)), ag_next


def emulate_gain(power, noise, alpha=0.98, gain_floor=0.1):
    """The kernel's recurrence over (B, F, K), frame by frame."""
    power = np.asarray(power, f32)
    inv_lam = f32(1) / np.maximum(np.asarray(noise, f32), f32(1e-10))
    g2 = np.ones(power[:, 0].shape, f32)
    ag = np.full(power[:, 0].shape, f32(alpha))
    out = np.empty_like(power)
    for t in range(power.shape[1]):
        g, g2, ag = step(frame(power[:, t], inv_lam, alpha), g2, ag)
        out[:, t] = np.maximum(g, f32(gain_floor))
    return out


def test_tables_are_the_reference_coefficients():
    """Every coefficient that mmse.cuh writes out is the TPU kernel's, at
    the power of 3.75 its scaling names."""
    pytest.importorskip("jax")
    from repro.kernels.mmse_stsa import kernel as JMK

    assert written_out("mmse_small") == (
        [((c,), i) for i, c in enumerate(JMK._I0_SMALL)]
        + [((c,), i) for i, c in enumerate(JMK._I1_SMALL)])
    assert written_out("mmse_large") == [
        ((c,), i) for i, c in enumerate(JMK._I0_LARGE)]
    assert written_out("mmse_large_sum") == [
        ((a, b), i)
        for i, (a, b) in enumerate(zip(JMK._I0_LARGE, JMK._I1_LARGE))]


def _grid():
    xi = np.concatenate([[XI_MIN, XI_MIN * f32(1.001)],
                         np.logspace(-2.5, 4, 40)]).astype(f32)
    gamma = np.concatenate([[1e-8, 1e-6, 0.01, 0.5, 1.0, 2.0, 7.5],
                            np.logspace(1, 4, 12), [GAMMA_MAX]]).astype(f32)
    xi, gamma = [a.ravel() for a in np.meshgrid(xi, gamma)]
    # h = xi gamma / (2 (1 + xi)) just below and just above 3.75
    hx = np.float32(1e3)
    g375 = f32(2 * 3.75 * (1 + hx) / hx)
    edge = np.array([np.nextafter(g375, f32(0)), g375,
                     np.nextafter(g375, f32(np.inf)), g375 * f32(0.999),
                     g375 * f32(1.001)], f32)
    return (np.concatenate([xi, np.full(5, hx, f32)]),
            np.concatenate([gamma, edge]))


def test_step_matches_the_plain_gain_on_a_grid():
    """Both branches and the clip points: xi at XI_MIN, gamma at 1e-8 and
    GAMMA_MAX, gains clipped at 10, h on both sides of 3.75."""
    xi, gamma = _grid()
    # xi arrives as fma(g2, ag, prior): g2 = xi, ag = 1, prior = 0
    fr = (f32(0.5) * gamma, np.zeros_like(gamma), gamma,
          SQRTPI_2 * rcp(gamma))
    got, g2, _ = step(fr, xi, np.ones_like(xi))
    v = torch.from_numpy(xi * gamma / (1 + xi))
    want = MR.gain_fn(v, torch.from_numpy(gamma)).numpy()
    h = xi * gamma / (2 * (1 + xi))
    assert (h <= 3.75).any() and (h > 3.75).any()
    assert (got == 10).any() and (want == 10).any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(g2, np.minimum(got * got, f32(100)))


@pytest.mark.parametrize("seed", [0, 1])
def test_recurrence_matches_the_plain_version(seed):
    """860 frames at K = 129 with a loud region, as chip_smoke's input."""
    rng = np.random.RandomState(seed)
    p = rng.exponential(1.0, (2, 860, 129)).astype(f32)
    p[:, 215:430, :43] += 40.0
    power = torch.from_numpy(p)
    noise = MR.estimate_noise_psd(power, 16)
    want = MR.mmse_stsa_gain_ref(power, noise).numpy()
    got = emulate_gain(p, noise.numpy())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_recurrence_matches_the_pallas_kernel_in_interpret_mode():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import backend
    from repro.kernels.mmse_stsa import ops as JMO

    rng = np.random.RandomState(4)
    p = rng.exponential(1.0, (1, 48, 129)).astype(f32)
    p[:, 12:24, :43] += 40.0
    noise = MR.estimate_noise_psd(torch.from_numpy(p), 8).numpy()
    with backend.use("interpret"):
        want = np.asarray(JMO.mmse_gain(jnp.asarray(p), jnp.asarray(noise)))
    np.testing.assert_allclose(emulate_gain(p, noise), want, rtol=RTOL,
                               atol=ATOL)
