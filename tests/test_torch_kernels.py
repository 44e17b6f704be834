"""The port's kernel modules against the JAX package, on the CPU: the same
seeded numpy inputs go through the JAX function (its plain jnp reference,
backend mode "ref") and the port's wrapper on a CPU tensor (its plain
PyTorch version), at the tolerances the reference holds its own kernels
to (tests/test_kernels.py). The hand CUDA kernels are compared with these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.kernels import backend  # noqa: E402
from repro.kernels.fir_hpf import ref as JFR  # noqa: E402
from repro.kernels.fused_tail import ref as JTR  # noqa: E402
from repro.kernels.mmse_stsa import ops as JMO  # noqa: E402
from repro.kernels.mmse_stsa import ref as JMR  # noqa: E402
from repro.kernels.stft_dft import kernel as JSK  # noqa: E402
from repro.kernels.stft_dft import ops as JSO  # noqa: E402
from repro.kernels.stft_dft import ref as JSR  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.kernels.fir_hpf import ops as FO  # noqa: E402
from repro_torch.kernels.fir_hpf import ref as FR  # noqa: E402
from repro_torch.kernels.fused_tail import ops as TO  # noqa: E402
from repro_torch.kernels.mmse_stsa import ops as MO  # noqa: E402
from repro_torch.kernels.mmse_stsa import ref as MR  # noqa: E402
from repro_torch.kernels.stft_dft import fft_tables as FT  # noqa: E402
from repro_torch.kernels.stft_dft import ops as SO  # noqa: E402
from repro_torch.kernels.stft_dft import ref as SR  # noqa: E402


# -------------------------------------------------------------------- FIR
@pytest.mark.parametrize("stride,S,taps", [(1, 5000, 129), (2, 10_000, 129),
                                           (2, 8193, 65), (3, 9001, 33)])
def test_fir_matches_reference(stride, S, taps):
    rng = np.random.RandomState(stride * S % 97)
    x = rng.randn(2, S).astype(np.float32)
    h = FR.bandpass_decimate_taps(1000.0, 11_025.0, 44_100, taps)
    np.testing.assert_array_equal(
        h, JFR.bandpass_decimate_taps(1000.0, 11_025.0, 44_100, taps))
    want = np.asarray(JFR.fir_ref(jnp.asarray(x), h, stride))
    got = FR.fir_ref(torch.from_numpy(x), h, stride).numpy()
    assert got.shape == want.shape == (2, S // stride)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------- STFT
@pytest.mark.parametrize("n_tiles", [1, 2])
def test_stft_matches_reference(n_tiles):
    rng = np.random.RandomState(7 + n_tiles)
    S = n_tiles * JSK.FRAME_TILE * 128 + 128
    x = rng.randn(2, S).astype(np.float32)
    with backend.use("ref"):
        want = np.asarray(JSO.stft(jnp.asarray(x)))
        want_p = np.asarray(JSO.stft_power(jnp.asarray(x)))
    got = SO.stft(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, n_tiles * 128, 129)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(SO.stft_power(torch.from_numpy(x)).numpy(),
                               want_p, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_tiles", [1, 2])
def test_istft_matches_reference(n_tiles):
    rng = np.random.RandomState(17 + n_tiles)
    S = n_tiles * JSK.FRAME_TILE * 128 + 128
    x = rng.randn(2, S).astype(np.float32)
    z = np.array(JSR.stft_ref(jnp.asarray(x)))
    want = np.asarray(JSO.istft(jnp.asarray(z), S))
    got = SO.istft(torch.from_numpy(z), S).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------- MMSE
@pytest.mark.parametrize("B,F,K", [(1, 32, 128), (2, 64, 129), (1, 16, 256)])
def test_mmse_gain_matches_reference(B, F, K):
    rng = np.random.RandomState(B + F + K)
    power = rng.exponential(1.0, (B, F, K)).astype(np.float32)
    power[:, F // 4:F // 2, :K // 3] += 40.0
    noise = np.array(JMR.estimate_noise_psd(jnp.asarray(power), 8))
    np.testing.assert_allclose(
        MR.estimate_noise_psd(torch.from_numpy(power), 8).numpy(), noise,
        rtol=1e-6)
    with backend.use("ref"):
        want = np.asarray(JMO.mmse_gain(jnp.asarray(power),
                                        jnp.asarray(noise)))
    got = MO.mmse_gain(torch.from_numpy(power), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)
    spec = (np.sqrt(power) * np.exp(1j * rng.uniform(0, 6.3, power.shape))
            ).astype(np.complex64)
    with backend.use("ref"):
        want_d = np.asarray(JMO.denoise_spectrum(jnp.asarray(spec)))
    got_d = MO.denoise_spectrum(torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- fused tail
@pytest.mark.parametrize("hpf", [False, True])
@pytest.mark.parametrize("n_tiles", [1, 2])
def test_fused_tail_matches_reference(hpf, n_tiles):
    """The port's fused tail (plain version) against the reference's
    composed per-stage oracle, with one pad slot (index 7 of 5 rows)."""
    rng = np.random.RandomState(10 * n_tiles + hpf)
    S = n_tiles * 16_384 + 256
    wave = (rng.randn(5, S) * 0.3).astype(np.float32)
    idx = np.asarray([3, 0, 4, 7], np.int32)
    want = np.asarray(JTR.fused_tail_ref(jnp.asarray(wave), jnp.asarray(idx),
                                         JCFG, hpf=hpf))
    got = TO.fused_tail(torch.from_numpy(wave), torch.from_numpy(idx), cfg,
                        hpf=hpf).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert not got[3].any()                        # pad row exactly zero


@pytest.mark.parametrize("hpf", [False, True])
def test_fused_tail_many_noise_frames_matches_reference(hpf):
    """noise_est_frames = 100, more than one chunk of the CUDA kernel's
    frames: the port's fused tail (plain version) against the reference's
    oracle."""
    import dataclasses
    rng = np.random.RandomState(40 + hpf)
    S = 2 * 16_384 + 256                     # Fv = 257 frames
    wave = (rng.randn(4, S) * 0.3).astype(np.float32)
    idx = np.asarray([2, 0, 4], np.int32)
    jcfg = dataclasses.replace(JCFG, noise_est_frames=100)
    tcfg = dataclasses.replace(cfg, noise_est_frames=100)
    want = np.asarray(JTR.fused_tail_ref(jnp.asarray(wave), jnp.asarray(idx),
                                         jcfg, hpf=hpf))
    got = TO.fused_tail(torch.from_numpy(wave), torch.from_numpy(idx), tcfg,
                        hpf=hpf).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert not got[2].any()                        # pad row exactly zero


# -------------------------------------------------------------- constants
def test_constants_equal_reference():
    """Taps and window are the reference's numpy constants, bit for bit;
    the FFT kernels' host-built table holds exp(-2 pi i k / N) and the
    reference's window to f32 precision."""
    for n_taps in (33, 65, 129):
        np.testing.assert_array_equal(
            FR.highpass_taps(1000.0, 22_050, n_taps),
            JFR.highpass_taps(1000.0, 22_050, n_taps))
    np.testing.assert_array_equal(SR.hamming(256), JSR.hamming(256))
    tab = FT.tables(256)
    tw = tab[0:512:2] + 1j * tab[1:512:2]
    np.testing.assert_allclose(tw, np.exp(-2j * np.pi * np.arange(256) / 256),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tab[512:], JSR.hamming(256), rtol=0,
                               atol=1e-7)


def test_fir_ops_match_reference_stages():
    """The wrappers the stages call (compress's band-pass + decimate, the
    tail's high-pass) against the reference's, at the config's widths."""
    from repro.kernels.fir_hpf import ops as JFO
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12_000).astype(np.float32)
    with backend.use("ref"):
        want_bp = np.asarray(JFO.bandpass_decimate(jnp.asarray(x)))
        want_hp = np.asarray(JFO.highpass(jnp.asarray(x)))
    np.testing.assert_allclose(FO.bandpass_decimate(torch.from_numpy(x))
                               .numpy(), want_bp, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(FO.highpass(torch.from_numpy(x)).numpy(),
                               want_hp, rtol=1e-4, atol=1e-5)
