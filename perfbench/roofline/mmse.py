"""The MMSE-STSA gain kernel (`csrc/mmse.cu`): the staged survivor tail
(the fused tail computes the gain inside `fused_tail.cu`)."""
import re

from perfbench.roofline._common import MMSE_OPS_PER_STEP, frames

KERNEL = "mmse_stsa"
TRACE_NAME = re.compile(r"\bmmse_kernel\b")


def launches(batch):
    if not batch["tail_rows"] or batch["fuse_tail"]:
        return []
    p = batch["pipeline"]
    W, H = p["stft_window"], p["stft_hop"]
    return [{"R": batch["tail_rows"],
             "F": frames(batch["final_samples"], W, H), "K": W // 2 + 1}]


def count(shape):
    """(bytes, operations): power read and gains written once, the noise
    PSD read once; one MMSE step a bin and frame."""
    R, Fv, K = shape["R"], shape["F"], shape["K"]
    return 4 * (2 * R * Fv * K + R * K), MMSE_OPS_PER_STEP * R * Fv * K
