"""The port's backend mode "matmul" on the CPU against the JAX package: the
three tests of tests/test_matmul_dft.py (the f32 matmul STFT within 1e-4
of the FFT, the matmul iSTFT's round trip, the detection masks equal under
the mode), `stft_matmul`, `istft_matmul` and `fused_tail_matmul` at bf16
against the reference's own matmul forms on the same inputs (rtol = atol
= 2e-4), the content key under each mode, `Preprocessor.phase_fn`, and
the wrappers on meta tensors.

Inputs come from numpy seeds. The reference runs in backend mode "ref",
and in "matmul" where its matmul forms are the reference."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.core.plans import Preprocessor as JPreprocessor  # noqa: E402
from repro.kernels import backend as jbackend  # noqa: E402
from repro.kernels.fused_tail import ref as JFR  # noqa: E402
from repro.kernels.stft_dft import ops as JO  # noqa: E402
from repro.kernels.stft_dft import ref as JR  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.core.plans import Preprocessor  # noqa: E402
from repro_torch.data.loader import audio_batch_maker  # noqa: E402
from repro_torch.data.synthetic import generate_labelled  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.fir_hpf import ops as fir_ops  # noqa: E402
from repro_torch.kernels.fused_tail import ops as FO  # noqa: E402
from repro_torch.kernels.fused_tail import ref as FR  # noqa: E402
from repro_torch.kernels.mmse_stsa import ops as mmse_ops  # noqa: E402
from repro_torch.kernels.stft_dft import ops as O  # noqa: E402
from repro_torch.kernels.stft_dft import ref as R  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def f32_matmul(monkeypatch):
    """Both frameworks' matmul forms with f32 operands."""
    monkeypatch.setattr(R, "MATMUL_DTYPE", torch.float32)
    monkeypatch.setattr(JR, "MATMUL_DTYPE", jnp.float32)


def test_stft_matmul_matches_fft(f32_matmul):
    x = np.random.RandomState(0).randn(2, 40_000).astype(np.float32)
    xp = R.pad_for_stft(torch.from_numpy(x))
    jxp = np.asarray(JO.pad_for_stft(jnp.asarray(x)))
    np.testing.assert_array_equal(xp.numpy(), jxp)
    zm = R.stft_matmul(xp).numpy()
    for zr in (np.asarray(JR.stft_ref(jnp.asarray(jxp))),
               R.stft_ref(xp).numpy()):
        err = float(np.abs(zm - zr).max()) / float(np.abs(zr).max())
        assert err < 1e-4, err


def test_istft_matmul_roundtrip(f32_matmul):
    x = np.random.RandomState(1).randn(1, 33_000).astype(np.float32)
    xp = R.pad_for_stft(torch.from_numpy(x))
    # the spectrum the reference's FFT gives, inverted by the port
    z = torch.from_numpy(np.array(JR.stft_ref(jnp.asarray(xp.numpy()))))
    xr = R.istft_matmul(z, xp.shape[1]).numpy()
    cov = R.num_frames(xp.shape[1], 256, 128) * 128 + 128
    np.testing.assert_allclose(xr[:, :cov], xp.numpy()[:, :cov], atol=2e-4)


def _detect_chunks():
    audio, _ = generate_labelled(4, 4 * 12, segment_s=5.0)
    s5 = audio.shape[-1]
    return (audio.reshape(4, 12, 2, s5).transpose(0, 2, 1, 3)
            .reshape(4, 2, 12 * s5))


def test_pipeline_masks_identical_under_matmul_backend():
    """The port's detection reaches the same decisions under "matmul" as
    under auto, and as the reference under "matmul"."""
    chunks = _detect_chunks()
    pre = Preprocessor(cfg, device="cpu")
    det_fft = pre.detect(chunks)
    with backend.use("matmul"):
        det_mm = pre.detect(chunks)
    assert backend.get_mode() == "auto"
    with jbackend.use("matmul"):
        det_ref = JPreprocessor(JCFG).detect(jnp.asarray(chunks))
    for m in ("keep", "rain", "silence", "cicada15"):
        want = np.asarray(getattr(det_ref, m))
        np.testing.assert_array_equal(getattr(det_fft, m).numpy(), want, m)
        np.testing.assert_array_equal(getattr(det_mm, m).numpy(), want, m)
    # the mode really ran: bf16 streams change the waveform
    assert not np.array_equal(det_fft.wave5.numpy(), det_mm.wave5.numpy())


@pytest.mark.parametrize("n", [40_000, 110_250])
def test_stft_matmul_bf16_matches_reference(n):
    x = np.random.RandomState(2).randn(3, n).astype(np.float32)
    xp = R.pad_for_stft(torch.from_numpy(x))
    got = R.stft_matmul(xp).numpy()
    want = np.asarray(JR.stft_matmul(jnp.asarray(xp.numpy())))
    np.testing.assert_allclose(got, want, **TOL)
    # the dispatching wrapper under the mode: the valid frames of it
    with backend.use("matmul"):
        z = O.stft(torch.from_numpy(x)).numpy()
    assert z.shape == (3, R.num_frames(n, 256, 128), 129)
    np.testing.assert_array_equal(z, got[:, :z.shape[1]])


def test_istft_matmul_bf16_matches_reference():
    rng = np.random.RandomState(3)
    z = (rng.randn(2, 860, 129) + 1j * rng.randn(2, 860, 129)).astype(
        np.complex64)
    got = R.istft_matmul(torch.from_numpy(z), 110_250).numpy()
    want = np.asarray(JR.istft_matmul(jnp.asarray(z), 110_250))
    np.testing.assert_allclose(got, want, **TOL)
    with backend.use("matmul"):
        np.testing.assert_array_equal(
            O.istft(torch.from_numpy(z), 110_250).numpy(), got)


@pytest.mark.parametrize("hpf", [False, True])
def test_fused_tail_matmul_f32_matches_reference(f32_matmul, hpf):
    """The composition (gather with 2 pad slots, high-pass, tile pad,
    valid frames, noise PSD, gain, overlap-add) with f32 operands on
    white noise (6, 110,250), 4 survivors."""
    wave = np.random.RandomState(4).randn(6, 110_250).astype(np.float32)
    idx = np.array([5, 0, 3, 2, 6, 6], np.int32)
    got = FR.fused_tail_matmul(torch.from_numpy(wave), torch.from_numpy(idx),
                               cfg, hpf).numpy()
    want = np.asarray(JFR.fused_tail_matmul(jnp.asarray(wave),
                                            jnp.asarray(idx), JCFG, hpf))
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[4:].any()


@pytest.fixture(scope="module")
def tail_rows():
    """The rows the tail takes on the main path: wave5 of batch 1 of the
    seed-25 stream through the port's detection (12 rows, 7 kept)."""
    x = np.asarray(audio_batch_maker(seed=25, batch_long_chunks=1)(1)[0],
                   np.float32)
    return Preprocessor(cfg, device="cpu").detect(x).wave5.numpy()


@pytest.mark.parametrize("hpf", [False, True])
def test_fused_tail_matmul_bf16_matches_reference(tail_rows, hpf):
    """bf16 operands on the tail's own rows, 6 of them and 2 pad slots.
    A bf16 rounding amplifies a one-ulp f32 difference in its input to a
    whole bf16 step, so with the high-pass both frameworks round the same
    high-passed rows (the reference's FIR through the `highpass` hook);
    the FIR itself is held to the reference in the FIR tests."""
    from repro.kernels.fir_hpf import ref as JFIR
    idx = np.array([11, 0, 3, 7, 5, 1, 12, 12], np.int32)

    def ref_highpass(rows):
        taps = JFIR.highpass_taps(JCFG.hpf_cutoff_hz, JCFG.target_rate_hz,
                                  JCFG.hpf_taps)
        return torch.from_numpy(np.array(
            JFIR.fir_ref(jnp.asarray(rows.numpy()), taps, 1)))

    wave, tidx = torch.from_numpy(tail_rows), torch.from_numpy(idx)
    got = FR.fused_tail_matmul(wave, tidx, cfg, hpf,
                               highpass=ref_highpass if hpf else None)
    want = np.asarray(JFR.fused_tail_matmul(jnp.asarray(tail_rows),
                                            jnp.asarray(idx), JCFG, hpf))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the dispatching wrapper under the mode, with the wrappers' FIR and
    # gain: on the CPU those are the plain versions
    with backend.use("matmul"):
        out = FO.fused_tail(wave, tidx, cfg, hpf)
    np.testing.assert_array_equal(
        out.numpy(), FR.fused_tail_matmul(wave, tidx, cfg, hpf).numpy())
    assert not out[6:].numpy().any()


def test_content_key_differs_between_modes(tmp_path):
    pre = Preprocessor(cfg, plan="cached", store=str(tmp_path / "st"),
                       device="cpu")
    x = audio_batch_maker(seed=25, batch_long_chunks=1)(0)[0]
    x = np.asarray(x, np.float32)
    auto = pre.plan._key(x)
    with backend.use("matmul"):
        mm = pre.plan._key(x)
        assert backend.framework_tag(torch.device("cpu")) == \
            "torch-cpu-matmul"
    assert auto != mm and auto == pre.plan._key(x)
    assert backend.framework_tag(torch.device("cpu")) == "torch-cpu"


def test_mode_selector():
    assert backend.get_mode() == "auto" and not backend.matmul_dft()
    with backend.use("matmul"):
        assert backend.matmul_dft()
        with pytest.raises(ValueError):
            backend.set_mode("pallas")      # no counterpart in the port
        assert backend.get_mode() == "matmul"
    assert backend.get_mode() == "auto"
    backend.set_mode("matmul")
    backend.set_mode("auto")
    with pytest.raises(ValueError):
        backend.use("ref").__enter__()


@pytest.mark.parametrize("kind", ["fused", "detect", "tail", "mmse",
                                  "tail_idx", "tail_idx_fused"])
def test_phase_fn_equals_graph_method(kind):
    """phase_fn(kind) is the un-run phase over the facade's rules: the
    same outputs as the graph's method."""
    pre = Preprocessor(cfg, device="cpu")
    g = pre.graph
    x = torch.from_numpy(np.asarray(
        audio_batch_maker(seed=25, batch_long_chunks=1)(1)[0], np.float32))
    fn = pre.phase_fn(kind)
    if kind in ("fused", "detect"):
        got, want = fn(x), (g.fused(x) if kind == "fused" else
                            g.detection(x))
        for f in ("wave5", "keep", "rain", "silence", "cicada15"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(want, f).numpy())
        return
    wave = g.detection(x).wave5[:4]
    if kind in ("tail", "mmse"):
        got, want = fn(wave), g.tail(wave)
    else:
        idx = torch.tensor([3, 1, 4, 4], dtype=torch.int32)
        method = (g.tail_indexed if kind == "tail_idx"
                  else g.tail_indexed_fused)
        got, want = fn(wave, idx), method(wave, idx)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_phase_fn_unknown_kind():
    with pytest.raises(KeyError):
        Preprocessor(cfg, device="cpu").phase_fn("tail_fused")


def test_wrappers_on_meta_tensors():
    """A meta tensor runs the plain versions for their shapes, in both
    modes; a device other than cpu, cuda or meta raises."""
    x = torch.empty(2, 4_000, device="meta")
    for mode in ("auto", "matmul"):
        with backend.use(mode):
            z = O.stft(x)
            assert z.device.type == "meta" and z.shape == (2, 30, 129)
            assert O.istft(z, 4_000).shape == (2, 4_000)
            assert fir_ops.highpass(x).shape == (2, 4_000)
            p = torch.empty(2, 30, 129, device="meta")
            assert mmse_ops.mmse_gain(p, p[:, 0]).shape == (2, 30, 129)
            idx = torch.empty(3, dtype=torch.int32, device="meta")
            out = FO.fused_tail(x, idx, cfg, hpf=True)
            assert out.device.type == "meta" and out.shape == (3, 4_000)
    with pytest.raises(ValueError, match="unsupported device"):
        backend.plain_on(torch.device("xpu"))
