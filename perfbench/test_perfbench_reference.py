"""The benchmark's reference and generator against the program on the CPU
at one long chunk: the generator's statistics, the masks equal and the
cleaned audio within the configuration's limits; and the control (the
reference in TF32 in the program's place) judged not correct."""
import numpy as np
import pytest
import torch

from perfbench import check, synthetic
from perfbench.reference import serf as reference
from perfbench.spec import Bench

MIXES = {"mixed": (0.45, 0.2, 0.15, 0.2), "rainy": (0.05, 0.5, 0.05, 0.4),
         "birds": (0.85, 0.05, 0.05, 0.05), "chorus": (1.0, 0.0, 0.0, 0.0),
         "rain": (0.0, 1.0, 0.0, 0.0)}


@pytest.fixture(scope="module")
def config():
    return Bench().config("serf_archive")


def test_generator_draws_from_the_programs_distributions():
    """Per label, the segments' RMS level (mean and spread) within a few
    percent of the port's `generate_labelled` over ~100 segments a label;
    the same seed gives the same arrays."""
    from repro_torch.data import synthetic as program
    probs = (0.25, 0.25, 0.25, 0.25)
    seg, lab = synthetic.segments(6, 400, probs, 0.5)
    ref, ref_lab = program.generate_labelled(6, 400, label_probs=probs,
                                             persistence=0.5)
    for i, name in enumerate(synthetic.LABELS):
        got = seg[lab == i, 0].pow(2).mean(dim=1).sqrt().numpy()
        want = np.sqrt((ref[ref_lab == i, 0] ** 2).mean(axis=1))
        assert len(got) > 50 and len(want) > 50, name
        assert abs(got.mean() / want.mean() - 1) < 0.05, name
        assert abs(np.log(got.std() / want.std())) < 0.5, name
    # the second channel is the first plus faint noise
    d = (seg[:, 1] - seg[:, 0]).pow(2).mean().sqrt().item()
    assert abs(d / synthetic.STEREO_NOISE - 1) < 0.01
    again = synthetic.long_chunks(3, 1, MIXES["mixed"], 0.85)
    assert np.array_equal(again, synthetic.long_chunks(3, 1, MIXES["mixed"],
                                                       0.85))
    assert again.shape == (1, 2, 2_646_000) and again.dtype == np.float32


@pytest.mark.parametrize("mix,seed", [("mixed", 5), ("rainy", 6),
                                      ("chorus", 7), ("rain", 8)])
def test_reference_against_the_programs_cpu_path(config, mix, seed):
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    audio = synthetic.long_chunks(seed, 1, MIXES[mix], 0.85)
    res = Preprocessor(SERF_AUDIO, device="cpu")(audio)
    ref = reference.run(audio, config["pipeline"], "f32", device="cpu")
    tally = check.Tally()
    tally.add(check.program_arrays(res.det, res.cleaned), ref)
    ok, table = check.judge(tally.numbers(), config["limits"])
    assert ok, table
    for m in ("keep", "rain", "silence", "cicada15"):
        assert np.array_equal(res.det.__dict__[m].numpy(), ref[m]), m


def test_control_in_tf32_is_not_correct(config):
    audio = synthetic.long_chunks(5, 1, MIXES["birds"], 0.85)
    want = reference.run(audio, config["pipeline"], "f32", device="cpu")
    got = reference.run(audio, config["pipeline"], "tf32", device="cpu")
    assert want["keep"].any()
    tally = check.Tally()
    tally.add(got, want)
    ok, table = check.judge(tally.numbers(), config["limits"])
    assert not ok, table


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    assert reference.tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, 3.0]


def test_three_valued_conjunction():
    t = torch.tensor
    a = (t([True, True, False, True]), t([True, False, True, False]))
    b = (t([True, False, True, False]), t([True, True, False, False]))
    mask, decided = reference._and(a, b)
    assert mask.tolist() == [True, False, False, False]
    # a decided false term decides the conjunction
    assert decided.tolist() == [True, True, True, False]


@pytest.mark.parametrize("workload,kept", [("serf_archive.chorus", "all"),
                                           ("serf_archive.rain", "none")])
def test_each_cells_traffic_keeps_what_its_why_says(config, workload,
                                                    kept):
    """The chorus cell's traffic keeps every chunk, the rain cell's none:
    the reference on one long chunk of each."""
    from perfbench import traffic as T
    b = Bench()
    traffic = dict(b.traffic(b.cell(workload)["traffic"]),
                   pool_items=1, long_chunks_per_item=1)
    (audio,) = T.make_items(traffic, 2**31 + 3)
    ref = reference.run(audio, config["pipeline"], "f32", device="cpu")
    assert ref["keep_decided"].all()
    assert ref["keep"].all() if kept == "all" else not ref["keep"].any()
