"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at one long chunk, once for each fault a cell can have (one card: no
exchange between chips to leave out)."""
import dataclasses
import time

import pytest

from perfbench import harness
from repro_torch.core.graph import PipelineGraph
from repro_torch.distributed.sharding import whole

SEED = 2**31 + 11
SMALL = {"traffic": {"pool_items": 1, "long_chunks_per_item": 1}}

_tail = PipelineGraph.tail_indexed_fused
_detection = PipelineGraph.detection


def state_unchanged(self, wave, idx, rules=None):
    """The survivor tail returns its input: no denoising step."""
    from repro_torch.kernels.fused_tail.ref import gather_rows
    return gather_rows(wave, idx)


def half_the_batch(self, wave, idx, rules=None):
    """The tail computes the first half of its rows; the rest stay zero."""
    out = _tail(self, wave, idx) if rules is None else \
        _tail(self, wave, idx, rules)
    out = whole(out).clone()
    out[(out.shape[0] + 1) // 2:] = 0
    return out


def answer_altered(self, audio, rules=None):
    """Detection's answer altered where it is produced: the first chunk's
    keep flipped."""
    out = _detection(self, audio) if rules is None else \
        _detection(self, audio, rules)
    keep = whole(out.keep).clone()
    keep[0] = ~keep[0]
    return dataclasses.replace(
        out, keep=keep, wave5=whole(out.wave5), rain=whole(out.rain),
        silence=whole(out.silence), cicada15=whole(out.cicada15))


FAULTS = {"state_unchanged": ("tail_indexed_fused", state_unchanged),
          "half_the_batch": ("tail_indexed_fused", half_the_batch),
          "answer_altered": ("detection", answer_altered)}


def _run(workload, overrides):
    return harness.run_cell(workload, SEED, 0.5, 0, time.monotonic(),
                            device="cpu", overrides=overrides)


def test_the_sound_run_compares_survivors():
    r = _run("serf_archive.chorus", SMALL)
    assert r["correct"], r["check"]
    assert r["diagnostics"]["coverage"]["cleaned_rows_compared"] >= 2


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_archive_path_is_not_correct(monkeypatch, fault):
    name, fn = FAULTS[fault]
    monkeypatch.setattr(PipelineGraph, name, fn)
    r = _run("serf_archive.chorus", SMALL)
    assert not r["correct"], r["check"]


def test_a_broken_detection_in_the_rain_cell_is_not_correct(monkeypatch):
    """The rain cell runs no survivor tail: what it can get wrong is the
    answer of detection."""
    r = _run("serf_archive.rain", SMALL)
    assert r["correct"], r["check"]
    assert r["diagnostics"]["coverage"]["cleaned_rows_compared"] == 0
    name, fn = FAULTS["answer_altered"]
    monkeypatch.setattr(PipelineGraph, name, fn)
    r = _run("serf_archive.rain", SMALL)
    assert not r["correct"], r["check"]
