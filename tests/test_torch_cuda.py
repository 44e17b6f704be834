"""The hand CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one (decided inside the `card` fixture, never at import). On a
machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

No JAX: the machine with the card need not have it. Small shapes here;
`chip_smoke.py` repeats the comparison at the main path's shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import SERF_AUDIO as cfg
from repro_torch.core.plans import Preprocessor
from repro_torch.data.loader import audio_batch_maker
from repro_torch.kernels.fir_hpf import ops as FO
from repro_torch.kernels.fir_hpf import ref as FR
from repro_torch.kernels.fused_tail import ops as TO
from repro_torch.kernels.fused_tail import ref as TR
from repro_torch.kernels.mmse_stsa import ops as MO
from repro_torch.kernels.mmse_stsa import ref as MR
from repro_torch.kernels.stft_dft import ops as SO
from repro_torch.kernels.stft_dft import ref as SR


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode "
                    "(run this file on the card)")
    torch.backends.cudnn.allow_tf32 = False    # the plain FIR is a conv1d
    return torch.device("cuda")


def _close(got, want, rtol, atol):
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("B,stride,S,taps", [
    (2, 1, 5000, 129), (2, 2, 10_000, 129), (2, 2, 8193, 65),
    (2, 3, 9001, 33),
    (2, 2, 5001, 1),                 # one tap
    (2, 1, 9001, 600), (3, 2, 20_001, 600),   # taps in shared memory
    (2, 2, 100, 129), (2, 1, 57, 129),        # S < T
    (48, 1, 110_250, 129),           # the staged tail's hpf stage
    (4, 2, 2_646_000, 129)])         # the main path's compress stage
def test_fir_kernel(card, B, stride, S, taps):
    rng = np.random.RandomState(stride * S % 97)
    x = torch.as_tensor(rng.randn(B, S).astype(np.float32), device=card)
    h = (FR.bandpass_decimate_taps(1000.0, 11_025.0, 44_100, taps)
         if taps > 1 else np.array([0.7], np.float32))
    before = FO.KERNEL.launches
    got = FO.fir_cuda(x, h, stride)
    assert FO.KERNEL.launches == before + 1
    assert got.shape == (B, S // stride)
    _close(got, FR.fir_ref(x, h, stride), 1e-4, 1e-5)


@pytest.mark.parametrize("S", [256, 16_511, 40_000])
def test_stft_kernel(card, S):
    x = torch.randn(3, S, device=card)
    got = SO.stft_cuda(x)
    assert got.shape == (3, SR.num_frames(S, 256, 128), 129)
    _close(got, SR.stft_ref(x), 2e-4, 2e-4)


@pytest.mark.parametrize("window", [128, 256, 512])
@pytest.mark.parametrize("B,extra", [(1, -1), (1, 1), (3, -1), (3, 1)])
def test_stft_kernel_tile_edges(card, window, B, extra):
    """Frame counts one below and one above two frame tiles (8192/window
    frames each), one row and three, every window the kernel takes."""
    hop = window // 2
    F = 2 * (8192 // window) + extra
    S = (F - 1) * hop + window + hop // 2    # a part frame left over
    x = torch.randn(B, S, device=card)
    got = SO.stft_cuda(x, window, hop)
    assert got.shape == (B, F, hop + 1)
    _close(got, SR.stft_ref(x, window, hop), 2e-4, 2e-4)


def test_stft_kernel_unaligned_rows(card):
    """Rows whose start is not 16-byte aligned (S odd, a view at offset 1)."""
    base = torch.randn(2 * 9_001 + 1, device=card)
    x = base[1:].view(2, 9_001)
    _close(SO.stft_cuda(x), SR.stft_ref(x), 2e-4, 2e-4)


@pytest.mark.parametrize("B,F,K", [
    (1, 32, 128), (2, 64, 129), (1, 16, 256),
    *[(35, F, K) for F in (1, 3, 861) for K in (1, 129)]])
def test_mmse_kernel(card, B, F, K):
    rng = np.random.RandomState(B + F + K)
    p = rng.exponential(1.0, (B, F, K)).astype(np.float32)
    p[:, F // 4:F // 2, :K // 3] += 40.0
    power = torch.as_tensor(p, device=card)
    noise = MR.estimate_noise_psd(power, 8)
    _close(MO.mmse_gain_cuda(power, noise), MR.mmse_stsa_gain_ref(power, noise),
           1e-4, 2e-5)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_mmse_kernel_unaligned_power(card, offset):
    """A power view at an odd float offset: contiguous, not 16-byte
    aligned; the kernel's 4-byte head copies take the lead-in floats."""
    B, F, K = 3, 70, 129
    rng = np.random.RandomState(offset)
    flat = torch.as_tensor(rng.exponential(1.0, B * F * K + offset)
                           .astype(np.float32), device=card)
    power = flat[offset:].view(B, F, K)
    assert power.data_ptr() % 16 != 0 and power.is_contiguous()
    noise = MR.estimate_noise_psd(power, 8)
    _close(MO.mmse_gain_cuda(power, noise), MR.mmse_stsa_gain_ref(power, noise),
           1e-4, 2e-5)


@pytest.mark.parametrize("hpf", [False, True])
@pytest.mark.parametrize("S", [16_640, 40_000])
def test_fused_tail_kernel(card, hpf, S):
    wave = torch.randn(5, S, device=card) * 0.3
    idx = torch.tensor([3, 0, 4, 7, 5], dtype=torch.int32, device=card)
    got = TO.fused_tail_spectrum_cuda(wave, idx, cfg, hpf)
    _close(got, TR.fused_tail_spectrum_ref(wave, idx, cfg, hpf), 2e-4, 2e-4)
    assert not torch.view_as_real(got[3:]).any()     # pad rows exactly zero
    _close(TO.fused_tail(wave, idx, cfg, hpf), TR.fused_tail_ref(wave, idx, cfg,
                                                                 hpf),
           2e-4, 2e-4)


@pytest.mark.parametrize("hpf", [False, True])
@pytest.mark.parametrize("noise_frames", [1, 100, 400])
def test_fused_tail_kernel_noise_frames(card, hpf, noise_frames):
    """Any noise_est_frames: one frame, more than a chunk, more than Fv."""
    S = 40_000                                   # Fv = 311
    tcfg = dataclasses.replace(cfg, noise_est_frames=noise_frames)
    wave = torch.randn(4, S, device=card) * 0.3
    idx = torch.tensor([3, 0, 4, 1], dtype=torch.int32, device=card)
    got = TO.fused_tail_spectrum_cuda(wave, idx, tcfg, hpf)
    _close(got, TR.fused_tail_spectrum_ref(wave, idx, tcfg, hpf), 2e-4, 2e-4)
    assert not torch.view_as_real(got[2]).any()


@pytest.mark.parametrize("idx", [[2], [5], [5, -1, 9]])
def test_fused_tail_kernel_one_row_and_all_pads(card, idx):
    wave = torch.randn(5, 20_000, device=card) * 0.3
    idx = torch.tensor(idx, dtype=torch.int32, device=card)
    got = TO.fused_tail_spectrum_cuda(wave, idx, cfg)
    _close(got, TR.fused_tail_spectrum_ref(wave, idx, cfg), 2e-4, 2e-4)


@pytest.mark.parametrize("window", [4, 64, 200, 382, 510])
@pytest.mark.parametrize("B,F", [(1, 31), (3, 33), (2, 70), (2, 130)])
def test_stft_dft_kernel(card, window, B, F):
    """The direct-DFT path of the STFT kernel: frame counts below and
    above a 32-frame tile (W = 510) and a 64-frame one, and tiles that a
    block walks in turn, with a part frame left over; it counts on
    `stft_dft_generic`, not `stft_dft`."""
    hop = window // 2
    S = (F - 1) * hop + window + hop // 2
    x = torch.randn(B, S, device=card) * 0.3
    kernels.reset_launches()
    got = SO.stft_cuda(x, window, hop)
    assert got.shape == (B, F, hop + 1)
    _close(got, SR.stft_ref(x, window, hop), 2e-4, 2e-4)
    assert kernels.launches()["stft_dft_generic"] == 1
    assert kernels.launches()["stft_dft"] == 0


@pytest.mark.parametrize("window", [4, 64, 200, 382, 510])
@pytest.mark.parametrize("hpf", [False, True])
@pytest.mark.parametrize("noise_frames", [16, 100])
def test_fused_tail_dft_kernel(card, window, hpf, noise_frames):
    """The direct-DFT fused tail against its plain version at 2e-4, with
    pad rows (one past the end, one negative) exactly zero; 100 noise
    frames reach past the first 32-frame chunk."""
    tcfg = dataclasses.replace(cfg, stft_window=window, stft_hop=window // 2,
                               noise_est_frames=noise_frames)
    wave = torch.randn(5, 30_000, device=card) * 0.3
    idx = torch.tensor([3, 0, 5, 4, -1, 1], dtype=torch.int32, device=card)
    kernels.reset_launches()
    got = TO.fused_tail_spectrum_cuda(wave, idx, tcfg, hpf)
    assert kernels.launches()["fused_tail_generic"] == 1
    assert kernels.launches()["fused_tail"] == 0
    _close(got, TR.fused_tail_spectrum_ref(wave, idx, tcfg, hpf), 2e-4, 2e-4)
    assert not torch.view_as_real(got[2]).any()
    assert not torch.view_as_real(got[4]).any()


@pytest.mark.parametrize("window,hop", [(256, 64), (256, 256), (255, 127),
                                        (514, 257), (1024, 512)])
def test_fft_wrappers_reject_other_framing(card, window, hop):
    x = torch.randn(2, 5_000, device=card)
    with pytest.raises(ValueError):
        SO.stft_cuda(x, window, hop)
    tcfg = dataclasses.replace(cfg, stft_window=window, stft_hop=hop)
    with pytest.raises(ValueError):
        TO.fused_tail_spectrum_cuda(
            x, torch.tensor([0], dtype=torch.int32, device=card), tcfg)


def test_wrappers_dispatch_cuda_tensors_to_kernels(card):
    kernels.reset_launches()
    x = torch.randn(2, 30_000, device=card)
    FO.bandpass_decimate(x)
    p = SO.stft_power(x)
    MO.mmse_gain(p, p[:, :16].mean(1))
    TO.fused_tail(x, torch.tensor([1, 2], dtype=torch.int32, device=card),
                  cfg)
    assert kernels.launches() == {"fir_hpf": 1, "stft_dft": 1,
                                  "mmse_stsa": 1, "fused_tail": 1,
                                  "stft_dft_generic": 0,
                                  "fused_tail_generic": 0}


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    with pytest.raises(ValueError):
        FO.fir_cuda(torch.randn(2, 100, device=card),
                    torch.ones(5, dtype=torch.float64))
    with pytest.raises(ValueError):                     # taps on the card
        FO.fir_cuda(torch.randn(2, 100, device=card),
                    torch.ones(5, device=card))
    with pytest.raises(ValueError):
        SO.stft_cuda(torch.randn(2, 1000))              # a CPU tensor
    with pytest.raises(ValueError):
        TO.fused_tail_spectrum_cuda(
            torch.randn(2, 1000, device=card),
            torch.tensor([0], dtype=torch.int64, device=card), cfg)


# ---------------------------------------------------------- row blocks

ROWS = 70_000                       # more than a grid's y axis takes


@pytest.mark.parametrize("name", ["fir_hpf", "stft_dft", "mmse_stsa",
                                  "fused_tail"])
def test_wrappers_take_more_rows_than_a_grid_axis(card, name):
    """70,000 rows at a short length against the plain version; the STFT
    and MMSE wrappers launch once per block of 65,535 rows."""
    gen = torch.Generator(device=card).manual_seed(3)
    kernels.reset_launches()
    if name == "fir_hpf":
        x = torch.randn(ROWS, 300, generator=gen, device=card) * 0.3
        taps = FR.bandpass_decimate_taps(1000.0, 11_025.0, 44_100, 129)
        _close(FO.fir_cuda(x, taps, 2), FR.fir_ref(x, taps, 2), 1e-4, 1e-5)
        want_launches = 1
    elif name == "stft_dft":
        x = torch.randn(ROWS, 512, generator=gen, device=card) * 0.3
        _close(SO.stft_cuda(x), SR.stft_ref(x), 2e-4, 2e-4)
        want_launches = 2
    elif name == "mmse_stsa":
        power = torch.rand(ROWS, 4, 129, generator=gen, device=card) + 0.1
        noise = MR.estimate_noise_psd(power, 2)
        _close(MO.mmse_gain_cuda(power, noise),
               MR.mmse_stsa_gain_ref(power, noise), 1e-4, 2e-5)
        want_launches = 2
    else:
        wave = torch.randn(8, 1024, generator=gen, device=card) * 0.3
        idx = torch.arange(ROWS, device=card, dtype=torch.int32) % 9
        got = TO.fused_tail_spectrum_cuda(wave, idx, cfg)
        _close(got, TR.fused_tail_spectrum_ref(wave, idx, cfg), 2e-4, 2e-4)
        assert not torch.view_as_real(got[8::9]).any()      # pad rows
        want_launches = 1
    assert kernels.launches()[name] == want_launches


# ------------------------------------------------------------ the plans

def _stream(n_batches, batch_long_chunks=2):
    make = audio_batch_maker(seed=25, batch_long_chunks=batch_long_chunks)
    return [(w, (make(w)[0], None)) for w in range(n_batches)]


def _assert_same(got, want):
    assert [r.wid for r in got] == [r.wid for r in want]
    for r, w in zip(got, want):
        for m in ("keep", "rain", "silence", "cicada15"):
            assert torch.equal(getattr(r.det, m).cpu(),
                               getattr(w.det, m).cpu()), m
        assert r.n_kept == w.n_kept
        np.testing.assert_array_equal(r.cleaned, w.cleaned)


@pytest.mark.parametrize("plan", ["async", "streaming"])
def test_async_plans_bitwise_equal_two_phase_on_card(card, plan):
    """Six batches with every result held until the end: a staging slot or
    a readback buffer written again too early would show here."""
    stream = _stream(6)
    want = list(Preprocessor(cfg, plan="two_phase").run(stream))
    pre = Preprocessor(cfg, plan=plan)
    got = list(pre.run(stream))
    _assert_same(got, want)
    assert any(t["in_flight"] >= 2 for t in pre.plan.last_timings)
    assert sum(r.n_kept for r in got) > 0


def test_async_plan_keeps_an_input_view_out_of_its_ring(card):
    """A mono graph whose wave5 is a view of its input (`split_final`
    reshapes it): the tail of batch k runs after batch k+3 was uploaded
    into k's device slot, so the plan must not let wave5 live there."""
    stages = ("split_final", "removal_point", "mmse")
    stream = [(w, (chunks.mean(axis=1), None))
              for w, (chunks, _) in _stream(6)]
    want = list(Preprocessor(cfg, plan="two_phase", stages=stages,
                             source_channels=1).run(stream))
    pre = Preprocessor(cfg, plan="async", stages=stages, source_channels=1)
    assert pre.plan.donate
    got = list(pre.run(stream))
    _assert_same(got, want)
    for r, w in zip(got, want):
        assert torch.equal(r.det.wave5, w.det.wave5)


def test_async_staging_ring_is_pinned(card):
    pre = Preprocessor(cfg, plan="async", depth=3)
    list(pre.run(_stream(5)))
    st = pre.plan.staging
    assert st.donate and len(st.pinned) == len(st.dev) == 4
    assert all(p.is_pinned() for p in st.pinned)
    times = st.upload_times()
    assert len(times) == 5
    assert all(stage_ms >= 0.0 and dma_ms > 0.0 for stage_ms, dma_ms in times)


@pytest.mark.parametrize("plan", ["two_phase", "async"])
def test_cuda_tensor_batch_enters_without_a_copy(card, plan):
    chunks = _stream(2)[1][1][0]
    pre = Preprocessor(cfg, plan=plan)
    want = pre(chunks)
    x = torch.as_tensor(chunks, device=card)
    assert pre.plan._to_device(x) is x
    staged = len(pre.plan.staging.log) if pre.plan.staging else 0
    got = pre(x)
    _assert_same([got], [want])
    if pre.plan.staging:
        assert len(pre.plan.staging.log) == staged      # no upload


def test_two_phase_staging_ring_is_pinned(card):
    """two_phase on the card: one pinned slot and no device ring (it does
    not donate), one logged upload a host batch and none for a batch
    already on the card, each path counted in `plan_uploads_total`."""
    from repro_torch.obs import metrics as obs_metrics
    stream = _stream(3)
    prev = obs_metrics.get_registry()
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.set_registry(reg)
    try:
        pre = Preprocessor(cfg, plan="two_phase")
        list(pre.run(stream))
        st = pre.plan.staging
        assert (st.slots, st.donate, st.dev) == (1, False, [])
        assert len(st.pinned) == 1 and st.pinned[0].is_pinned()
        assert len(st.log) == 3
        pre(torch.as_tensor(stream[0][1][0], device=card))
        assert len(st.log) == 3
    finally:
        obs_metrics.set_registry(prev)
    assert all(stage_ms >= 0.0 and dma_ms > 0.0
               for stage_ms, dma_ms in st.upload_times())
    counts = {s["labels"]["path"]: s["value"]
              for s in reg.snapshot()["plan_uploads_total"]["series"]}
    assert counts == {"pinned": 3, "resident": 1}


def test_two_phase_results_held_bitwise_equal_resident_batches(card):
    """Six host batches through the pinned ring, every result held until
    the end, against the same batches entered as tensors on the card: a
    pinned slot or a readback buffer written again too early would show
    here."""
    stream = _stream(6)
    got = list(Preprocessor(cfg, plan="two_phase").run(stream))
    resident = [(w, (torch.as_tensor(c, device=card), lab))
                for w, (c, lab) in stream]
    want = list(Preprocessor(cfg, plan="two_phase").run(resident))
    _assert_same(got, want)
    assert sum(r.n_kept for r in got) > 0


def test_two_phase_caller_may_overwrite_its_batch(card):
    """The pinned `copy_` has ended when the call returns: a caller that
    zeroes its numpy batch at once leaves the result as it was."""
    stream = _stream(3)
    pre = Preprocessor(cfg, plan="two_phase")
    want = [pre(torch.as_tensor(c, device=card)) for _, (c, _) in stream]
    got = []
    for _, (chunks, _) in stream:
        batch = chunks.copy()
        got.append(pre(batch))
        batch[...] = 0.0
    _assert_same(got, want)
    assert sum(r.n_kept for r in got) > 0


def test_fused_plan_on_card_matches_staged_two_phase(card):
    """The no-early-exit plan: all its rows through the STFT and MMSE
    kernels; masks equal to two_phase's, kept rows within the reference's
    plan-equivalence tolerance of the staged survivors."""
    stream = _stream(2)
    want = list(Preprocessor(cfg, plan="two_phase", fuse_tail=False)
                .run(stream))
    kernels.reset_launches()
    got = list(Preprocessor(cfg, plan="fused").run(stream))
    counts = kernels.launches()
    assert all(counts[n] > 0 for n in ("fir_hpf", "stft_dft", "mmse_stsa"))
    assert counts["fused_tail"] == 0
    assert [r.wid for r in got] == [r.wid for r in want]
    for r, w in zip(got, want):
        for m in ("keep", "rain", "silence", "cicada15"):
            assert torch.equal(getattr(r.det, m).cpu(),
                               getattr(w.det, m).cpu()), m
        assert r.cleaned.shape == w.cleaned.shape
        np.testing.assert_allclose(r.cleaned, w.cleaned, rtol=1e-4,
                                   atol=1e-5)


def test_cached_plan_on_card_cold_then_warm(card, tmp_path):
    """Cold: every batch misses and runs the fused two_phase path; warm:
    every batch hits and no kernel launches; both bitwise equal to the
    uncached plan. An entry the CPU computed is never served to the card,
    nor the card's to the CPU."""
    stream = _stream(2)
    want = list(Preprocessor(cfg, plan="two_phase").run(stream))
    cold = Preprocessor(cfg, plan="cached", store=tmp_path)
    kernels.reset_launches()
    _assert_same(list(cold.run(stream)), want)
    assert kernels.launches()["fused_tail"] == 2
    assert (cold.plan.stats.misses, cold.plan.stats.hits) == (2, 0)
    warm = Preprocessor(cfg, plan="cached", store=tmp_path)
    kernels.reset_launches()
    got = list(warm.run(stream))
    assert not any(kernels.launches().values())
    assert (warm.plan.stats.misses, warm.plan.stats.hits) == (0, 2)
    _assert_same(got, want)
    assert all(not r.det.wave5.any() for r in got)
    on_cpu = Preprocessor(cfg, plan="cached", store=tmp_path, device="cpu")
    list(on_cpu.run(stream[:1]))
    assert (on_cpu.plan.stats.misses, on_cpu.plan.stats.hits) == (1, 0)


def test_sharded_inproc_on_card_matches_cpu(card):
    """The in-process sharded plan on the card: detection, then the
    survivors gathered, re-sliced and padded on the device for the staged
    tail. Masks equal to its CPU run, cleaned audio within 2e-4, and the
    FIR, STFT and MMSE kernels launched."""
    stream = _stream(3)
    want = list(Preprocessor(cfg, plan="sharded", shards=2,
                             device="cpu").run(stream))
    pre = Preprocessor(cfg, plan="sharded", shards=2)
    kernels.reset_launches()
    got = list(pre.run(stream))
    counts = kernels.launches()
    assert all(counts[n] > 0 for n in ("fir_hpf", "stft_dft", "mmse_stsa"))
    assert [r.wid for r in got] == [r.wid for r in want]
    for r, w in zip(got, want):
        for m in ("keep", "rain", "silence", "cicada15"):
            assert torch.equal(getattr(r.det, m).cpu(), getattr(w.det, m)), m
        assert r.cleaned.shape == w.cleaned.shape
        np.testing.assert_allclose(r.cleaned, w.cleaned, rtol=2e-4,
                                   atol=2e-4)
    assert sum(r.n_kept for r in got) > 0


def test_sharded_cuda_workers_bitwise_equal_two_phase(card):
    """Two worker processes on the card (each its own CUDA context) run
    two_phase there: every batch bitwise equal to two_phase in this
    process, and each worker reports its kernel launches."""
    stream = _stream(4)
    want = list(Preprocessor(cfg, plan="two_phase").run(stream))
    pre = Preprocessor(cfg, plan="sharded", shards=2, transport="proc",
                       stall_timeout_s=300.0)
    kernels.reset_launches()
    got = list(pre.run(stream))
    assert not any(kernels.launches().values())    # the master ran none
    _assert_same(got, want)
    reports = [st.report for st in pre.plan.worker_stats]
    assert len(reports) == 2 and all(r["device"] == "cuda" for r in reports)
    assert all(r["cuda_reserved_bytes"] > 0 for r in reports)
    total = {n: sum(r["launches"][n] for r in reports)
             for n in kernels.KERNELS}
    assert all(total[n] > 0 for n in ("fir_hpf", "stft_dft", "fused_tail"))


# ------------------------------------------------------ the serving tier

def _requests(n):
    make = audio_batch_maker(seed=23, batch_long_chunks=1)
    return [make(w)[0][0] for w in range(n)]


def test_inproc_pool_on_card_bitwise_equal_two_phase(card):
    """Two worker threads on the card (one CUDA context, the default
    stream each) serve batches of 1, 2 and 4 long chunks bitwise equal to
    two_phase on the card, and every launch is counted."""
    from repro_torch.serve import WorkerPool
    reqs = _requests(4)
    batches = [np.stack(reqs[:n]) for n in (1, 2, 4, 4, 2)]
    two_phase = Preprocessor(cfg, plan="two_phase")
    want = [two_phase(b) for b in batches]
    kernels.reset_launches()
    with WorkerPool(cfg, workers=2, transport="inproc", poll_s=0.002) as pool:
        assert pool.device.type == "cuda"
        wids = [pool.submit(b) for b in batches]
        got = pool.wait(wids, timeout_s=300.0)
    assert kernels.launches()["fused_tail"] == sum(
        1 for w in want if w.n_kept)          # one tail per batch, no loss
    assert kernels.launches()["fir_hpf"] > 0
    _assert_same([dataclasses.replace(got[w], wid=None) for w in wids],
                 want)


@pytest.mark.parametrize("rows", [1, 2, 0])
def test_serving_batches_on_card_match_cpu(card, rows):
    """The serving shapes: batches of 1 and 2 long chunks, and a batch
    whose every chunk is removed (rows=0: one near-silent chunk), through
    the batcher over two_phase on the card against the same on the CPU."""
    from repro_torch.serve import ContinuousBatcher
    reqs = _requests(2)[:rows] if rows else [
        (1e-4 * np.random.RandomState(0).randn(*_requests(1)[0].shape))
        .astype(np.float32)]

    def serve(device):
        b = ContinuousBatcher(plan=Preprocessor(cfg, device=device),
                              max_batch=4, linger_s=0.0)
        rids = [b.submit(c) for c in reqs]
        b.flush()
        return [b.result(r) for r in rids]

    got, want = serve(None), serve("cpu")
    for g, w in zip(got, want):
        assert g["ok"] and w["ok"]
        for m in ("keep", "rain", "silence"):
            np.testing.assert_array_equal(g[m], w[m])
        assert g["cleaned"].shape == w["cleaned"].shape
        np.testing.assert_allclose(g["cleaned"], w["cleaned"], rtol=2e-4,
                                   atol=2e-4)
    if not rows:
        assert not got[0]["keep"].any() and got[0]["cleaned"].shape[0] == 0


def test_obs_hooks_on_card_results(card, tmp_path):
    """`_record_batch` and `record_result` on results whose masks lie on
    the card: no exception, the counts right, the output unchanged."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import telemetry as obs_telemetry
    from repro_torch.obs import tracing as obs_tracing
    stream = _stream(2)
    prev = obs_metrics.get_registry()
    obs_metrics.set_registry(obs_metrics.NullRegistry())
    try:
        want = list(Preprocessor(cfg, plan="async").run(stream))
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.set_registry(reg)
        tracer = obs_tracing.Tracer()
        obs_tracing.set_tracer(tracer)
        got = list(Preprocessor(cfg, plan="async").run(stream))
        assert got[0].det.keep.device.type == "cuda"
        with obs_telemetry.TelemetryWriter(tmp_path) as w:
            for r in got:
                obs_telemetry.record_result(w, r.wid, r)
    finally:
        obs_metrics.set_registry(prev)
        obs_tracing.set_tracer(None)
    _assert_same(got, want)
    obs_tracing.validate_chrome_trace(tracer.chrome())
    snap = reg.snapshot()
    (chunks,) = snap["plan_chunks_total"]["series"]
    assert chunks["value"] == sum(r.det.keep.numel() for r in got)
    recs = obs_telemetry.read_records(str(tmp_path))
    assert [r["survivors"] for r in recs] == [r.n_kept for r in got]


# ------------------------------------------------- the chaos harness

def _proc_state(pid):
    """The state letter in /proc/<pid>/stat ("T": stopped), None once the
    pid is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return None


def test_stalled_cuda_worker_resumes_bitwise(card):
    """The one worker process holds a CUDA context when it is SIGSTOPped
    at the grant of wid 1; once it reads stopped it is continued, and
    every later result is bitwise equal to two_phase in this process."""
    import threading
    import time
    stream = _stream(3)
    want = list(Preprocessor(cfg, plan="two_phase").run(stream))
    pre = Preprocessor(cfg, plan="sharded", shards=1, transport="proc",
                       stall_timeout_s=300.0)
    plan = pre.plan
    stalled, got, err = [], [], []

    def on_grant(worker, wid):
        if wid == 1 and not stalled:
            stalled.append(plan.fleet.handles[0].pid)
            plan.fleet.stall(0)

    def consume():
        try:
            got.extend(pre.run(stream))
        except BaseException as e:      # noqa: BLE001 (asserted below)
            err.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    for _ in range(30000):
        if plan.fleet is not None or not t.is_alive():
            break
        time.sleep(0.001)
    plan.fleet.service.on_grant = on_grant
    for _ in range(30000):             # until the worker is stopped
        if stalled and _proc_state(stalled[0]) == "T":
            break
        t.join(0.01)
    assert stalled and _proc_state(stalled[0]) == "T"
    assert len(got) <= 1               # nothing past the stall came back
    plan.fleet.resume_all()
    t.join(300.0)
    assert not t.is_alive() and not err, err
    _assert_same(got, want)
    (st,) = plan.worker_stats
    assert st.report["device"] == "cuda" and st.chunks_done == 3
    assert _proc_state(stalled[0]) is None


def test_chaos_runner_on_card_leaves_no_worker(card):
    """A seeded schedule (kill, join, drain, stall) over 2 worker
    processes on the card: every wid once, bitwise equal to two_phase, and
    afterwards no worker process running or stopped."""
    from repro_torch.data.loader import make_shard_pool
    from repro_torch.ft.chaos import ACTIONS, ChaosRunner, make_schedule
    n = 6
    make = audio_batch_maker(seed=23, batch_long_chunks=1)
    pool = make_shard_pool(make, n, 2, lease_timeout_s=300.0)
    pre = Preprocessor(cfg, plan="sharded", shards=2, transport="proc",
                       stall_timeout_s=300.0)
    schedule = make_schedule(23, n, stall_s=(1.0, 2.0))
    got, fired = ChaosRunner(pre.plan, pool, schedule, seed=23).run()
    assert sorted(r.wid for r in got) == list(range(n))
    assert all(e.fired for e in schedule)
    assert {e.action for e in fired} == set(ACTIONS)
    two_phase = Preprocessor(cfg, plan="two_phase")
    _assert_same(sorted(got, key=lambda r: r.wid),
                 [dataclasses.replace(two_phase(make(w)[0]), wid=w)
                  for w in range(n)])
    handles = pre.plan.fleet.handles
    assert len(handles) >= 3           # the join spawned a third
    for h in handles.values():
        assert h.poll() is not None
        assert _proc_state(h.pid) in (None, "Z")


# ------------------------------------------------ language-model serving

LM_ARCHS = ["arctic-480b", "gemma-7b", "granite-moe-3b-a800m", "llama3.2-3b",
            "minitron-8b", "nemotron-4-15b", "paligemma-3b", "whisper-small",
            "xlstm-125m", "zamba2-1.2b"]


def _lm_inputs(lm_cfg, B=2, S=32, seed=1):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, lm_cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "targets": tokens}
    if lm_cfg.num_prefix_tokens:
        batch["prefix"] = rng.randn(B, lm_cfg.num_prefix_tokens,
                                    lm_cfg.d_model).astype(np.float32)
    if lm_cfg.is_enc_dec:
        batch["enc_frames"] = rng.randn(B, 16, lm_cfg.d_model).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_arch_on_card_matches_cpu(card, arch):
    """The same parameters on the CPU and the card (f32, TF32 off): loss,
    prefill logits and one decode step's logits within 1e-4."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import decode_caches
    torch.backends.cuda.matmul.allow_tf32 = False
    lm_cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    cpu = build_model(lm_cfg, device="cpu")
    gpu = build_model(lm_cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    batch = _lm_inputs(lm_cfg)
    B, S = batch["tokens"].shape
    k, P = S - 1, lm_cfg.num_prefix_tokens or 0
    outs = []
    with torch.inference_mode():
        for m in (cpu, gpu):
            loss, _ = m.loss_fn(batch)
            logits, caches = m.prefill(dict(batch,
                                            tokens=batch["tokens"][:, :k]))
            cache = decode_caches(m, caches, S + P, dtype=torch.float32)
            step, _ = m.decode_step(cache, torch.as_tensor(
                batch["tokens"][:, k], device=m.device), P + k)
            outs.append([loss, logits, step])
    for got, want in zip(outs[1], outs[0]):
        assert got.device.type == "cuda"
        _close(got, want, 1e-4, 1e-4)


def test_lm_full_width_llama_bf16_serving_deterministic(card):
    """llama3.2-3b at its published widths, bf16, random weights from a
    seed: greedy generation twice on the same prompts gives the same
    tokens, each below the vocab size."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import ServeEngine
    lm_cfg = ARCHS["llama3.2-3b"]
    model = build_model(lm_cfg, device=card)
    assert model.emb["tok"].dtype == torch.bfloat16
    eng = ServeEngine(model, max_seq=64)
    prompts = np.random.RandomState(0).randint(0, lm_cfg.vocab_size, (4, 32))
    a, b = eng.generate(prompts, 16), eng.generate(prompts, 16)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 16) and (a >= 0).all()
    assert (a < lm_cfg.vocab_size).all()


def test_lm_full_width_zamba2_bf16_serving_deterministic(card):
    """zamba2-1.2b (38 Mamba2 layers, one shared attention block applied 7
    times) at its published widths, bf16, random weights from a seed:
    greedy generation twice on the same prompts gives the same tokens, each
    below the vocab size."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.zoo import HybridLM, build_model
    from repro_torch.serve.engine import ServeEngine
    lm_cfg = ARCHS["zamba2-1.2b"]
    model = build_model(lm_cfg, device=card)
    assert isinstance(model, HybridLM)
    assert model.emb["tok"].dtype == torch.bfloat16
    assert model.layers[0]["mamba"]["A_log"].dtype == torch.float32
    eng = ServeEngine(model, max_seq=64)
    prompts = np.random.RandomState(0).randint(0, lm_cfg.vocab_size, (4, 32))
    a, b = eng.generate(prompts, 16), eng.generate(prompts, 16)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 16) and (a >= 0).all()
    assert (a < lm_cfg.vocab_size).all()


# ------------------------------------------------ language-model training

@pytest.mark.parametrize("arch,quantize,microbatches,compress", [
    ("llama3.2-3b", False, 1, False),
    ("granite-moe-3b-a800m", True, 1, False),
    ("llama3.2-3b", False, 4, True)])
def test_lm_train_step_on_card_matches_cpu(card, arch, quantize,
                                           microbatches, compress):
    """One `make_train_step` step from the same parameters (f32, TF32 off)
    on the CPU and the card: loss rtol 1e-5, grad norm 1e-4, every
    parameter within 1e-5 except where the gradient Adam saw is below 1e-4
    of its leaf's largest on either side (read from m, (1 - b1) x that
    gradient after one step), where sign(g) may differ: 2 lr apart."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed.sharding import NULL_RULES
    from repro_torch.models.zoo import build_model
    from repro_torch.train import compression as C
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    lm_cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    cpu = build_model(lm_cfg, device="cpu")
    gpu = build_model(lm_cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    opt_cfg = O.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10,
                          quantize_state=quantize)
    batch = _lm_inputs(lm_cfg, B=2 * microbatches)
    outs = []
    for m in (cpu, gpu):
        m.requires_grad_(True)
        params = dict(m.named_parameters())
        state = O.init_opt_state(opt_cfg, params)
        if compress:
            state["ef_residual"] = C.init_residuals(params)
        outs.append(make_train_step(m, NULL_RULES, opt_cfg, microbatches,
                                    compress)(state, batch))
    (cs, cmet), (gs, gmet) = outs
    assert gs["step"].device.type == "cuda"
    np.testing.assert_allclose(float(gmet["loss"]), float(cmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(gmet["grad_norm"]),
                               float(cmet["grad_norm"]), rtol=1e-4)
    lr = float(cmet["lr"])

    def moment(m):
        if isinstance(m, dict):
            m = C.dequantize_rowwise_int8(m["codes"], m["scale"])
        return m.cpu()

    gparams = dict(gpu.named_parameters())
    for name, p in cpu.named_parameters():
        mc, mg = moment(cs["m"][name]), moment(gs["m"][name])
        small = ((mc.abs() < 1e-4 * mc.abs().max())
                 | (mg.abs() < 1e-4 * mg.abs().max()))
        err = (gparams[name].detach().cpu() - p.detach()).abs()
        allowed = 1e-5 * (1 + p.detach().abs()) + 2 * lr * small
        assert bool((err <= allowed).all()), (name, float(err.max()))


def test_two_workers_report_two_cards(card):
    """The sharded plan's process fleet over two cards: each worker is
    pinned to a card of its own and reports it in its `bye`, in this
    process's numbering, with the card's name and a peak of allocated
    memory above 0; the masks equal two_phase's on the card, the cleaned
    rows within 1e-5 of the batch's largest sample."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: one worker process a card")
    make = audio_batch_maker(seed=31, batch_long_chunks=1)
    stream = [(w, (make(w)[0], None)) for w in range(4)]
    pre = Preprocessor(cfg, plan="sharded", shards=2, transport="proc",
                       stall_timeout_s=300.0)
    got = list(pre.run(stream))
    assert [r.wid for r in got] == [0, 1, 2, 3]
    ref = Preprocessor(cfg)
    for r in got:
        want = ref(make(r.wid)[0])
        np.testing.assert_array_equal(np.asarray(r.det.keep),
                                      want.det.keep.cpu().numpy())
        np.testing.assert_allclose(r.cleaned, want.cleaned, rtol=0,
                                   atol=1e-5 * np.abs(want.cleaned).max(initial=0.0))
    cards = {st.worker: st.report["card"] for st in pre.plan.worker_stats}
    assert sorted(c["index"] for c in cards.values()) == [0, 1]
    for c in cards.values():
        assert c["name"] == torch.cuda.get_device_name(c["index"])
        assert c["memory_peak_bytes"] > 0
