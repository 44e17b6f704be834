"""The table of peaks the benchmark holds the card to (one NVIDIA H100 SXM,
80 GB HBM3, at its full 700 W power limit; NVIDIA's data sheet). A card
set below 700 W runs slower under load: the harness prints the card's
limit beside every share of a peak."""

HBM_BYTES_PER_S = 3.35e12       # HBM3 bandwidth
F32_FLOPS = 66.9e12             # float32 outside the tensor cores: 132 SMs
#                                 x 128 FMA lanes x 2 x 1,980 MHz
BF16_FLOPS = 989e12             # dense bf16 on the tensor cores
TF32_FLOPS = 495e12             # dense TF32 on the tensor cores


def least_ms(n_bytes, n_flops, peak_flops=F32_FLOPS):
    """(least ms, "bytes" or "operations"): the bytes over the HBM rate
    against the operations over `peak_flops`, whichever takes longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
