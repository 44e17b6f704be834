"""The STFT kernel (`csrc/stft.cu`, the FFT of windows 128 / 256 / 512 or
the direct DFT of the others): the detection STFT over the 15 s chunks,
and the staged survivor tail's STFT."""
import re

from perfbench.roofline._common import frames, stft_flops

KERNEL = "stft_dft"
TRACE_NAME = re.compile(r"\bstft_(dft_)?kernel\b")


def launches(batch):
    p = batch["pipeline"]
    W, H = p["stft_window"], p["stft_hop"]
    n15 = int(round(p["long_split_s"] / p["detect_split_s"]))
    out = [{"B": batch["rows"] * n15,
            "S": batch["samples"] // (p["source_rate_hz"]
                                      // p["target_rate_hz"]) // n15,
            "W": W, "H": H}]
    if batch["tail_rows"] and not batch["fuse_tail"]:
        out.append({"B": batch["tail_rows"], "S": batch["final_samples"],
                    "W": W, "H": H})
    return out


def count(shape):
    """(bytes, operations): the samples the frames cover read once, the
    window and twiddle tables, the complex bins written once."""
    B, S, W, H = shape["B"], shape["S"], shape["W"], shape["H"]
    K = W // 2 + 1
    Fr = frames(S, W, H)
    n_bytes = 4 * B * ((Fr - 1) * H + W) + 4 * 3 * W + 8 * B * Fr * K
    return n_bytes, stft_flops(B * Fr, W)
