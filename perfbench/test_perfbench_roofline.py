"""The kernels' counters reproduce the least times of PERF.md's kernel
table at its shapes (bytes at 3.35 TB/s or f32 operations at 66.9
TFLOP/s, whichever is longer)."""
import pytest

from perfbench.peaks import least_ms
from perfbench.spec import Bench

PIPELINE = {"source_rate_hz": 44_100, "target_rate_hz": 22_050,
            "long_split_s": 60.0, "detect_split_s": 15.0,
            "final_split_s": 5.0, "hpf_taps": 129, "stft_window": 256,
            "stft_hop": 128, "noise_est_frames": 16}

# kernel -> (shape of PERF.md's row, bound_ms as the table prints it)
TABLE = {
    "fir": ({"B": 4, "S": 2_646_000, "stride": 2, "T": 129}, 0.0190),
    "stft": ({"B": 16, "S": 330_750, "W": 256, "H": 128}, 0.0190),
    "mmse": ({"R": 16, "F": 860, "K": 129}, 0.0042),
    "fused_tail": ({"B": 48, "S": 110_250, "rows": 16, "n_real": 15,
                    "W": 256, "H": 128, "T": 0}, 0.0062),
}


@pytest.mark.parametrize("kernel", sorted(TABLE))
def test_counter_gives_the_tables_bound(kernel):
    shape, bound_ms = TABLE[kernel]
    mod = Bench().rooflines()[kernel]
    ms, by = least_ms(*mod.count(shape))
    assert by == "bytes"
    assert round(ms, 4) == bound_ms


def test_launches_of_a_two_phase_batch():
    """One main-path batch of 4 long chunks with 20 survivors: one FIR,
    one detection STFT and one fused tail over the 20 rows; no MMSE
    launch (the fused tail computes the gain)."""
    batch = {"pipeline": PIPELINE, "rows": 4, "samples": 2_646_000,
             "final_rows": 48, "final_samples": 110_250, "n_real": 20,
             "tail_rows": 20, "fuse_tail": True}
    mods = Bench().rooflines()
    got = {k: m.launches(batch) for k, m in mods.items()}
    assert got["fir"] == [{"B": 4, "S": 2_646_000, "stride": 2, "T": 129}]
    assert got["stft"] == [{"B": 16, "S": 330_750, "W": 256, "H": 128}]
    assert got["mmse"] == []
    assert [s["rows"] for s in got["fused_tail"]] == [20]
    staged = dict(batch, fuse_tail=False)
    assert len(mods["stft"].launches(staged)) == 2
    assert mods["mmse"].launches(staged) == [{"R": 20, "F": 860, "K": 129}]
    assert mods["fused_tail"].launches(dict(batch, n_real=0,
                                            tail_rows=0)) == []
