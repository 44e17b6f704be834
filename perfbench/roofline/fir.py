"""The FIR kernel (`csrc/fir.cu`): the compress stage's band-pass FIR with
stride-2 decimation over the mono long chunks."""
import re

from perfbench.roofline._common import fir_flops

KERNEL = "fir_hpf"
TRACE_NAME = re.compile(r"\bfir_kernel\b")


def launches(batch):
    """The launch shapes of one two_phase batch."""
    p = batch["pipeline"]
    return [{"B": batch["rows"], "S": batch["samples"],
             "stride": p["source_rate_hz"] // p["target_rate_hz"],
             "T": p["hpf_taps"]}]


def count(shape):
    """(bytes, f32 operations): every input sample read once, every output
    written once, the taps read once."""
    B, S, s, T = shape["B"], shape["S"], shape["stride"], shape["T"]
    out_len = S // s
    return 4 * (B * S + B * out_len + T), fir_flops(B * S, B * out_len, T)
