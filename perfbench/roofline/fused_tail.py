"""The fused survivor tail (`csrc/fused_tail.cu`): gather, [high-pass,]
STFT, noise PSD and MMSE-STSA gain in one pass over the padded survivor
index vector."""
import re

from perfbench.roofline._common import (MMSE_OPS_PER_STEP, fir_flops,
                                        frames, stft_flops)

KERNEL = "fused_tail"
TRACE_NAME = re.compile(r"\bfused_tail_(dft_)?kernel\b")


def launches(batch):
    if not batch["tail_rows"] or not batch["fuse_tail"]:
        return []
    p = batch["pipeline"]
    return [{"B": batch["final_rows"], "S": batch["final_samples"],
             "rows": batch["tail_rows"], "n_real": batch["n_real"],
             "W": p["stft_window"], "H": p["stft_hop"],
             "T": p["hpf_taps"] if batch.get("tail_hpf") else 0}]


def count(shape):
    """(bytes, operations) of the real rows: their samples the frames
    cover read once, the index vector, tables and taps, every padded row's
    spectrum written once; real FFTs, the recurrence and the gain product
    on the real rows (a pad row only writes zeros)."""
    S, rows, n, W, H, T = (shape["S"], shape["rows"], shape["n_real"],
                           shape["W"], shape["H"], shape["T"])
    K = W // 2 + 1
    Fv = frames(S, W, H)
    span = (Fv - 1) * H + W
    n_flops = n * (stft_flops(Fv, W) + (MMSE_OPS_PER_STEP + 2) * Fv * K) \
        + (fir_flops(n * span, n * span, T) if T else 0)
    n_bytes = 4 * (n * span + rows + 3 * W + T) + 8 * rows * Fv * K
    return n_bytes, n_flops
