"""Model zoo: one API over the attention-family architectures (the port's
copy of the reference's `models/zoo.py`, its dense, MoE, VLM and
encoder-decoder models).

Model protocol (each model is an `nn.Module` that carries its parameters,
so the reference's `params` argument is gone)
  init(generator) -> self                                   draw parameters
  param_specs() -> tree of logical-axis tuples (the reference's, stacked)
  loss_fn(batch, rules) -> (loss, metrics)                  forward only
  prefill(batch, rules) -> (last_logits, caches)
  decode_step(caches, tokens, pos, rules) -> (logits, caches)
  init_cache(batch, seq_len) / cache_specs() for serving state.

A batch is a dict of tensors on the model's device: "tokens" (B,S)
integer, "targets" (B,S) (-1 = masked), "prefix" (B,P,E) for the VLM,
"enc_frames" (B,Se,E) for the encoder-decoder. Tied models reuse the
embedding table for logits; the loss masks padded vocab rows.

The recurrent families (hybrid: zamba2, ssm: xlstm) are not ported yet:
`build_model` raises for them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import NULL_RULES
from repro_torch.models import transformer as T
from repro_torch.models.common import (
    apply_norm, dense_init, dtype_of, embed_tokens, make_embedding,
    make_norm_params, sinusoidal_positions,
)

EMB_SPECS = {"tok": ("vocab", "w_embed")}
WHISPER_ENC_LEN = 1500      # standard whisper frame count (30 s @ 50 Hz)


def softmax_xent(cfg, logits, targets, rules):
    """logits: (B,S,Vp) f32; targets: (B,S), -1 = masked."""
    logits = rules.constrain(logits, "batch", "seq", "act_vocab")
    if cfg.padded_vocab != cfg.vocab_size:
        vocab_ok = torch.arange(cfg.padded_vocab,
                                device=logits.device) < cfg.vocab_size
        logits = torch.where(vocab_ok, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long().clamp(min=0)[..., None])[..., 0]
    valid = (targets >= 0).float()
    return ((lse - tgt) * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _logits(cfg, model, x, rules):
    table = model.unemb if hasattr(model, "unemb") else model.emb["tok"]
    logits = torch.einsum("bse,ve->bsv", x, table).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return rules.constrain(logits, "batch", "seq", "act_vocab")


def model_device(device=None) -> torch.device:
    """`resolve_device(device)` with the card's index filled in, so that a
    model, its generator and an engine compare equal on "cuda"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _positions(B, S, device, offset=0):
    return offset + torch.arange(S, dtype=torch.int32,
                                 device=device).expand(B, S)


class BaseModel(nn.Module):
    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.device = model_device(device)
        self.init(generator)

    def init(self, generator=None):
        """Draw every parameter anew from `generator` (a `torch.Generator`
        on the model's device; None: one seeded 0). Its stream is not the
        reference's `jax.random` one."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if model_device(generator.device) != self.device:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        self._modules.clear()           # the old tensors go before the new
        self._parameters.clear()        # ones are drawn
        with torch.no_grad():
            self._build(generator)
        return self

    def _final(self, x):
        return apply_norm(self.cfg, self.ln_f, x)

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)


# ---------------------------------------------------------------- decoder LMs
class DecoderLM(BaseModel):
    """Dense / MoE / VLM decoder-only LM (llama, nemotron, gemma, minitron,
    paligemma, arctic, granite)."""

    def _build(self, g):
        cfg = self.cfg
        self.emb = make_embedding(cfg, g)
        self.layers = nn.ModuleList(
            [T.init_dense_layer(cfg, g) for _ in range(cfg.num_layers)])
        self.ln_f = make_norm_params(cfg, cfg.d_model, self.device)
        if not cfg.tie_embeddings:
            self.unemb = dense_init(g, cfg.d_model,
                                    (cfg.padded_vocab, cfg.d_model),
                                    dtype_of(cfg))

    def param_specs(self):
        cfg = self.cfg
        p = {"emb": EMB_SPECS,
             "layers": T.stacked_specs(T.dense_layer_specs(cfg)),
             "ln_f": T.norm_specs(cfg)}
        if not cfg.tie_embeddings:
            p["unemb"] = ("vocab", "w_embed")
        return p

    def _inputs(self, batch, rules):
        cfg = self.cfg
        x = embed_tokens(cfg, self.emb, self._tensor(batch["tokens"]), rules)
        prefix_len = 0
        if cfg.num_prefix_tokens and "prefix" in batch:
            prefix = self._tensor(batch["prefix"], x.dtype)
            x = torch.cat([prefix, x], dim=1)
            prefix_len = prefix.shape[1]
        B, S = x.shape[:2]
        return x, _positions(B, S, self.device), prefix_len

    def loss_fn(self, batch, rules=NULL_RULES):
        cfg = self.cfg
        x, positions, prefix_len = self._inputs(batch, rules)
        x, aux = T.run_stack(cfg, self.layers, x, positions, rules,
                             causal=True, prefix_len=prefix_len)
        x = self._final(x)
        if prefix_len:
            x = x[:, prefix_len:]
        logits = _logits(cfg, self, x, rules)
        loss = softmax_xent(cfg, logits, self._tensor(batch["targets"]),
                            rules)
        metrics = {"xent": loss}
        if aux is not None:
            loss = loss + 0.01 * aux["lb_loss"] + 1e-3 * aux["router_z"]
            metrics.update(lb_loss=aux["lb_loss"],
                           dropped_frac=aux["dropped_frac"],
                           expert_load_max=aux["expert_load"].max())
        metrics["loss"] = loss
        return loss, metrics

    def prefill(self, batch, rules=NULL_RULES):
        cfg = self.cfg
        x, positions, prefix_len = self._inputs(batch, rules)
        x, caches = T.run_stack_prefill(cfg, self.layers, x, positions,
                                        rules, causal=True,
                                        prefix_len=prefix_len)
        x = self._final(x[:, -1:])
        logits = _logits(cfg, self, x, rules)[:, 0]
        return logits, caches

    def init_cache(self, batch, seq_len, dtype=torch.bfloat16):
        cfg = self.cfg
        shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def cache_specs(self):
        kv = (None, "batch", "kv_seq", "kv_heads", None)
        return {"k": kv, "v": kv}

    def decode_step(self, caches, tokens, pos, rules=NULL_RULES):
        """One token a row at position `pos` (for the VLM, the caller folds
        the prefix length into pos: the prefix lives at cache[:prefix_len]).
        The caches are written in place and returned."""
        cfg = self.cfg
        x = embed_tokens(cfg, self.emb, self._tensor(tokens)[:, None], rules)
        x, caches = T.run_stack_decode(cfg, self.layers, x, caches, pos,
                                       rules)
        x = self._final(x)
        logits = _logits(cfg, self, x, rules)[:, 0]
        return logits, caches


# ----------------------------------------------------------------- enc-dec LM
class EncDecLM(BaseModel):
    """Whisper-family: encoder over (stubbed) audio frames, causal decoder
    with cross-attention."""

    def _build(self, g):
        cfg = self.cfg
        self.emb = make_embedding(cfg, g)
        self.enc = nn.ModuleList(
            [T.init_dense_layer(cfg, g) for _ in range(cfg.encoder_layers)])
        self.ln_enc = make_norm_params(cfg, cfg.d_model, self.device)
        self.dec = nn.ModuleList([T.init_dense_layer(cfg, g, cross=True)
                                  for _ in range(cfg.num_layers)])
        self.ln_f = make_norm_params(cfg, cfg.d_model, self.device)

    def param_specs(self):
        cfg = self.cfg
        ns = T.norm_specs(cfg)
        return {"emb": EMB_SPECS,
                "enc": T.stacked_specs(T.dense_layer_specs(cfg)),
                "ln_enc": ns,
                "dec": T.stacked_specs(T.dense_layer_specs(cfg, cross=True)),
                "ln_f": ns}

    def encode(self, frames, rules=NULL_RULES):
        cfg = self.cfg
        dt = dtype_of(cfg)
        frames = self._tensor(frames)
        B, Se, E = frames.shape
        x = frames.to(dt) + sinusoidal_positions(
            Se, E, device=self.device).to(dt)
        x = rules.constrain(x, "batch", "seq", "embed")
        positions = _positions(B, Se, self.device)
        x, _ = T.run_stack(cfg, self.enc, x, positions, rules, causal=False)
        return apply_norm(cfg, self.ln_enc, x), positions

    def _dec_inputs(self, tokens, rules, offset=0):
        cfg = self.cfg
        tokens = self._tensor(tokens)
        B, S = tokens.shape
        x = embed_tokens(cfg, self.emb, tokens, rules)
        x = x + sinusoidal_positions(S, cfg.d_model, offset=offset,
                                     device=self.device).to(x.dtype)
        return x, _positions(B, S, self.device, offset)

    def loss_fn(self, batch, rules=NULL_RULES):
        cfg = self.cfg
        enc_out, enc_pos = self.encode(batch["enc_frames"], rules)
        x, positions = self._dec_inputs(batch["tokens"], rules)
        x, _ = T.run_stack(cfg, self.dec, x, positions, rules,
                           causal=True, enc_out=enc_out,
                           enc_positions=enc_pos)
        x = self._final(x)
        logits = _logits(cfg, self, x, rules)
        loss = softmax_xent(cfg, logits, self._tensor(batch["targets"]),
                            rules)
        return loss, {"loss": loss, "xent": loss}

    def prefill(self, batch, rules=NULL_RULES):
        cfg = self.cfg
        enc_out, enc_pos = self.encode(batch["enc_frames"], rules)
        x, positions = self._dec_inputs(batch["tokens"], rules)
        x, caches = T.run_stack_prefill(cfg, self.dec, x, positions,
                                        rules, causal=True, enc_out=enc_out,
                                        enc_positions=enc_pos)
        x = self._final(x[:, -1:])
        logits = _logits(cfg, self, x, rules)[:, 0]
        return logits, caches

    def init_cache(self, batch, seq_len, dtype=torch.bfloat16,
                   enc_len=WHISPER_ENC_LEN):
        cfg = self.cfg
        kv = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
        xkv = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        z = lambda shape: torch.zeros(shape, dtype=dtype,  # noqa: E731
                                      device=self.device)
        return {"k": z(kv), "v": z(kv), "xk": z(xkv), "xv": z(xkv)}

    def cache_specs(self):
        kv = (None, "batch", "kv_seq", "kv_heads", None)
        xkv = (None, "batch", None, "kv_heads", None)
        return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}

    def decode_step(self, caches, tokens, pos, rules=NULL_RULES):
        cfg = self.cfg
        S = caches["k"].shape[2]
        x = embed_tokens(cfg, self.emb, self._tensor(tokens)[:, None], rules)
        postab = sinusoidal_positions(S, cfg.d_model, device=self.device)
        x = x + postab[pos:pos + 1].to(x.dtype)
        x, caches = T.run_stack_decode(cfg, self.dec, x, caches, pos, rules)
        x = self._final(x)
        logits = _logits(cfg, self, x, rules)[:, 0]
        return logits, caches


def build_model(cfg, device=None, generator=None):
    """The model for `cfg` on `device` (None: the card; raises without one),
    its parameters drawn from `generator` (None: one seeded 0)."""
    if cfg.family in ("dense", "moe", "vlm"):
        cls = DecoderLM
    elif cfg.family == "audio":
        cls = EncDecLM
    elif cfg.family in ("hybrid", "ssm"):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet: "
            "ROADMAP Queue A item 4 (Mamba2 hybrid, xLSTM)")
    else:
        raise KeyError(cfg.family)
    return cls(cfg, device=device, generator=generator)
