"""The 10 assigned architecture configs (exact figures from the brief).

Head dims not stated in the brief use the published values for each model family.
"""
from repro_torch.configs.base import ModelConfig

LLAMA3_2_3B = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128_256, mlp="swiglu", rope_theta=500_000.0,
    tie_embeddings=True,
    # hillclimbed (EXPERIMENTS §Perf): 3B params over 256 chips is
    # activation-AR-bound under TP; ZeRO-3 pure-DP is compute-bound at 65%
    train_sharding_mode="zero3", train_microbatches=1,
)

NEMOTRON_4_15B = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24_576, vocab_size=256_000, mlp="squared_relu", rope_theta=10_000.0,
    tie_embeddings=False,
)

GEMMA_7B = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24_576, vocab_size=256_000, mlp="geglu", rope_theta=10_000.0,
    tie_embeddings=True, norm_eps=1e-6,
)

MINITRON_8B = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=16_384, vocab_size=256_000, mlp="squared_relu", rope_theta=10_000.0,
    tie_embeddings=False,
)

ZAMBA2_1_2B = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32_000, mlp="geglu",
    ssm_state=64, ssm_expand=2, ssm_conv=4,
    attn_period=6,                      # shared attention block every 6 mamba blocks
    subquadratic=True,                  # mamba2 backbone -> long_500k eligible
    # hillclimb breadth (EXPERIMENTS §Perf appendix): zero3 34 -> 74% roofline
    train_sharding_mode="zero3", train_microbatches=1,
)

XLSTM_125M = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4, head_dim=192,
    d_ff=0,                             # per brief: projections live inside blocks
    vocab_size=50_304, block_types=("mlstm", "slstm"),
    ssm_expand=2, subquadratic=True, norm="layernorm", use_rope=False,
)

PALIGEMMA_3B = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16_384, vocab_size=257_216, mlp="geglu", rope_theta=10_000.0,
    frontend="siglip_stub", num_prefix_tokens=256, tie_embeddings=True,
    # zero3: 57 -> 69% roofline; peak 16.5 GB is marginal on v5e (§Perf appendix)
    train_sharding_mode="zero3", train_microbatches=1,
)

ARCTIC_480B = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32_000, mlp="swiglu",
    num_experts=128, top_k=2,
    dense_ff=7168,                      # dense residual MLP in parallel with MoE
    tie_embeddings=False,
    # 480B params: optimizer state must shard over (pod,data) x model and use
    # 8-bit moments to approach HBM (DESIGN.md §5, EXPERIMENTS.md §Dry-run);
    # train cells use sequence-parallel + EP (EXPERIMENTS §Perf arctic iters)
    sharding_mode="fsdp_tp", quantize_opt_state=True,
    train_sharding_mode="sp_ep", train_microbatches=4,
)

GRANITE_MOE_3B = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49_155, mlp="swiglu",
    num_experts=40, top_k=8, tie_embeddings=True,
    # 40 experts don't divide the 16-way model axis -> shard each expert's
    # ff dim instead (expert-TP); see DESIGN.md §5
    expert_shard="tp",
)

WHISPER_SMALL = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51_865, mlp="gelu", norm="layernorm",
    encoder_layers=12, frontend="audio_stub", use_rope=False,
    tie_embeddings=True,
)

ALL = {
    c.name: c for c in [
        LLAMA3_2_3B, NEMOTRON_4_15B, GEMMA_7B, MINITRON_8B, ZAMBA2_1_2B,
        XLSTM_125M, PALIGEMMA_3B, ARCTIC_480B, GRANITE_MOE_3B, WHISPER_SMALL,
    ]
}
