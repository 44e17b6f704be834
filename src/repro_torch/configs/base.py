"""Config system: architecture + shape cells (the port's copy of the
reference's `configs/base.py`, field for field).

Every assigned architecture is a `ModelConfig`; the paper's own workload is an
`AudioPipelineConfig` (see serf_audio.py). Shapes are the four assigned cells.
The port keeps its own copy, though the reference's module imports no JAX:
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # mlp
    mlp: str = "swiglu"           # swiglu | geglu | squared_relu | gelu
    # moe
    num_experts: int = 0
    top_k: int = 0
    dense_ff: int = 0             # parallel dense residual MLP (arctic-style)
    moe_capacity_factor: float = 1.25   # >= top_k*experts/tokens => dropless
    expert_shard: str = "ep"      # ep: experts over "model" (needs E%16==0);
    #                               tp: shard each expert's ff dim instead
    # ssm / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256          # mamba2 chunked-scan chunk length
    attn_period: int = 0          # hybrid: shared attn block applied every N blocks
    block_types: tuple = ()       # xlstm: cycle of ("mlstm","slstm")
    # enc-dec
    encoder_layers: int = 0
    # modality frontend (stubbed per brief: precomputed embeddings)
    frontend: str = "none"        # none | siglip_stub | audio_stub
    num_prefix_tokens: int = 0
    # attention / norm details
    rope_theta: float = 10_000.0
    use_rope: bool = True
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0
    tie_embeddings: bool = True
    # capability flags
    subquadratic: bool = False    # eligible for long_500k
    # distribution profile (dry-run defaults; see DESIGN.md §5)
    sharding_mode: str = "tp"     # tp | fsdp_tp | zero3 | sp_ep
    train_sharding_mode: str = ""   # override for train cells ("" = same)
    train_microbatches: int = 0     # override for train cells (0 = CLI)
    quantize_opt_state: bool = False
    # numerics
    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so TP=16 shards evenly.

        Padded logit rows are masked out of the loss (see train/loss.py)."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    # ---- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) ----
    def param_counts(self) -> dict:
        """Returns dict with total and active parameter counts (embedding incl.)."""
        E, L = self.d_model, self.num_layers
        attn = E * self.q_dim + E * 2 * self.kv_dim + self.q_dim * E

        def mlp_params(ff):
            if ff == 0:
                return 0
            n_in = 2 if self.mlp in ("swiglu", "geglu") else 1
            return n_in * E * ff + ff * E

        per_layer_total = 0
        per_layer_active = 0
        if self.family in ("dense", "vlm", "audio"):
            per_layer_total = attn + mlp_params(self.d_ff)
            per_layer_active = per_layer_total
        elif self.family == "moe":
            router = E * self.num_experts
            experts = self.num_experts * mlp_params(self.d_ff)
            act_experts = self.top_k * mlp_params(self.d_ff)
            dense = mlp_params(self.dense_ff)
            per_layer_total = attn + router + experts + dense
            per_layer_active = attn + router + act_experts + dense
        elif self.family == "ssm":
            # xlstm-style block: in/out proj with expansion + gates (approximate
            # but exact enough for the roofline's useful-FLOPs ratio)
            d_in = self.ssm_expand * E
            per_layer_total = 2 * E * d_in + 4 * d_in * self.head_dim
            per_layer_active = per_layer_total
        elif self.family == "hybrid":
            d_in = self.ssm_expand * E
            mamba = (E * (2 * d_in + 2 * self.ssm_state)  # in-proj (x,z) + B,C
                     + d_in * E                            # out proj
                     + 3 * d_in)                           # dt/A/D params
            per_layer_total = mamba
            per_layer_active = mamba
        total = L * per_layer_total
        active = L * per_layer_active
        if self.family == "hybrid" and self.attn_period:
            shared = attn + mlp_params(self.d_ff)
            n_apps = max(1, self.num_layers // self.attn_period)
            total += shared                      # shared weights stored once
            active += shared * n_apps            # ... applied n_apps times
        if self.is_enc_dec:
            # encoder layers + cross-attention in decoder
            enc = self.encoder_layers * (attn + mlp_params(self.d_ff))
            cross = L * (E * self.q_dim + E * 2 * self.kv_dim + self.q_dim * E)
            total += enc + cross
            active += enc + cross
        emb = self.padded_vocab * E * (1 if self.tie_embeddings else 2)
        total += emb
        active += emb
        return {"total": total, "active": active}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch x shape) is a live cell, else (False, reason).

    Per the brief: long_500k needs sub-quadratic attention — skipped for pure
    full-attention archs; encoder-only archs would skip decode (none assigned).
    """
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: O(S^2) at 524k tokens excluded by brief"
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests."""
    kw = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(4, max(1, cfg.num_kv_heads * 4 // max(cfg.num_heads, 1))),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        rope_theta=cfg.rope_theta,
    )
    if cfg.family == "moe":
        kw.update(num_experts=8, top_k=min(cfg.top_k, 2),
                  dense_ff=128 if cfg.dense_ff else 0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_chunk=16)
    if cfg.attn_period:
        kw.update(attn_period=2, num_layers=4)
    if cfg.block_types:
        kw.update(num_layers=2)
    if cfg.is_enc_dec:
        kw.update(encoder_layers=2)
    if cfg.num_prefix_tokens:
        kw.update(num_prefix_tokens=8)
    return replace(cfg, name=cfg.name + "-reduced", **kw)
