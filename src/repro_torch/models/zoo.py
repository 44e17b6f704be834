"""Model zoo: one API over the ten architectures (the port's copy of the
reference's `models/zoo.py`): dense, MoE, VLM, encoder-decoder, the Mamba2
hybrid and the xLSTM.

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

Caches: K/V slabs (L,B,S,Hkv,D) for the attention families; the hybrid
adds a "mamba" dict of layer-stacked SSM states and conv tails; the xLSTM's
cache is its recurrent states, tuples of layer-stacked tensors. Every
`decode_step` writes its caches in place and returns them.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (NULL_RULES, batch_local,
                                              replicate_dim, rows_local)
from repro_torch.models import transformer as T
from repro_torch.models.common import (
    apply_norm, dense_init, dtype_of, embed_tokens, make_embedding,
    make_norm_params, sinusoidal_positions,
)
from repro_torch.models.mamba2 import (
    MAMBA_SPECS, apply_mamba, decode_mamba, init_mamba, init_mamba_cache,
)
from repro_torch.models.mlp import apply_mlp
from repro_torch.models.xlstm import (
    MLSTM_SPECS, SLSTM_SPECS, apply_mlstm, apply_slstm, decode_mlstm,
    decode_slstm, init_mlstm, init_slstm, mlstm_state0, slstm_state0,
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
    # the target logit is gathered on each rank's rows from whole vocab
    # rows: DTensor's own gather on rows sharded by the batch builds its
    # backward's gradient at the logits' global shape on every rank (538
    # GB for llama3.2-3b's train_4k over 256 ranks); a plain gather
    # without a mesh
    tgt = batch_local(_target_logit, logits, targets.long().clamp(min=0))
    valid = (targets >= 0).float()
    # a replicated scalar under a mesh (a partial sum would meet the
    # replicated aux losses in an add whose backward fails on DTensors)
    return rules.constrain(((lse - tgt) * valid).sum()
                           / torch.clamp(valid.sum(), min=1.0))


def _target_logit(logits, targets):
    return logits.gather(-1, targets[..., None])[..., 0]


def _logits(cfg, model, x, rules):
    table = model.unemb if hasattr(model, "unemb") else model.emb["tok"]
    if rules.mesh is not None and rules.spec("act_vocab")[0] is None:
        # logits wanted whole over the vocab (zero3, sp_ep): the table made
        # whole first, so each rank computes its rows' logits; DTensor
        # would otherwise gather the rows, shard the vocab and then gather
        # every row's logits to re-shard them by rows
        table = replicate_dim(replicate_dim(table, 0), 1)
    logits = rows_local(functools.partial(torch.einsum, "bse,ve->bsv"), x,
                        table).float()
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


# ----------------------------------------------------------------- hybrid LM
def _stack(trees):
    """Stack a list of equal dicts (or tuples) of tensors leaf by leaf on a
    new leading axis."""
    if isinstance(trees[0], dict):
        return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    return tuple(torch.stack(leaves) for leaves in zip(*trees))


class HybridLM(BaseModel):
    """Zamba2-style: Mamba2 backbone + one shared attention/MLP block applied
    before every group of `attn_period` layers (shared weights, a K/V cache
    for each application)."""

    def group_sizes(self):
        cfg = self.cfg
        period = cfg.attn_period
        sizes = []
        left = cfg.num_layers
        while left > 0:
            sizes.append(min(period, left))
            left -= period
        return sizes

    def _build(self, g):
        cfg = self.cfg
        self.emb = make_embedding(cfg, g)
        self.layers = nn.ModuleList([nn.ModuleDict({
            "ln": make_norm_params(cfg, cfg.d_model, self.device),
            "mamba": init_mamba(cfg, g)}) for _ in range(cfg.num_layers)])
        self.shared = T.init_dense_layer(cfg, g)
        self.ln_f = make_norm_params(cfg, cfg.d_model, self.device)

    def param_specs(self):
        cfg = self.cfg
        block = {"ln": T.norm_specs(cfg), "mamba": dict(MAMBA_SPECS)}
        return {"emb": EMB_SPECS,
                "layers": T.stacked_specs(block),
                "shared": T.dense_layer_specs(cfg),
                "ln_f": T.norm_specs(cfg)}

    def _groups(self):
        """(group index, its Mamba layers' indices) in order."""
        idx = 0
        for g, size in enumerate(self.group_sizes()):
            yield g, range(idx, idx + size)
            idx += size

    def _backbone(self, x, positions, rules, collect=False):
        """Returns (x, caches or None). Without `collect` the shared block
        is `apply_dense_layer`; with it, the same block assembled from
        `attn_sublayer(return_kv=True)` and `apply_mlp`, as the
        reference does."""
        cfg = self.cfg
        sh = self.shared
        ks, vs, mamba = [], [], []
        for _, layer_ids in self._groups():
            if collect:
                h = apply_norm(cfg, sh["ln1"], x)
                o, (k, v) = T.attn_sublayer(cfg, sh["attn"], h, positions,
                                            rules, causal=True,
                                            return_kv=True)
                ks.append(k)
                vs.append(v)
                x = x + o
                h = apply_norm(cfg, sh["ln2"], x)
                x = x + apply_mlp(cfg, sh["mlp"], h, rules)
            else:
                x, _, _ = T.apply_dense_layer(cfg, sh, x, positions, rules,
                                              causal=True)
            for i in layer_ids:
                p = self.layers[i]
                if collect:
                    h = apply_norm(cfg, p["ln"], x)
                    o, cache = apply_mamba(cfg, p["mamba"], h, rules,
                                           return_cache=True)
                    mamba.append(cache)
                    x = x + o
                else:       # rematerialised, as the reference's scan body
                    x = T.checkpointed(self._mamba_layer, p, x, rules)
        if collect:
            return x, {"k": torch.stack(ks), "v": torch.stack(vs),
                       "mamba": _stack(mamba)}
        return x, None

    def _mamba_layer(self, p, x, rules):
        return x + apply_mamba(self.cfg, p["mamba"],
                               apply_norm(self.cfg, p["ln"], x), rules)

    def _embed(self, batch, rules):
        tokens = self._tensor(batch["tokens"])
        B, S = tokens.shape
        x = embed_tokens(self.cfg, self.emb, tokens, rules)
        return x, _positions(B, S, self.device)

    def loss_fn(self, batch, rules=NULL_RULES):
        cfg = self.cfg
        x, positions = self._embed(batch, rules)
        x, _ = self._backbone(x, positions, rules)
        logits = _logits(cfg, self, self._final(x), rules)
        loss = softmax_xent(cfg, logits, self._tensor(batch["targets"]),
                            rules)
        return loss, {"loss": loss, "xent": loss}

    def prefill(self, batch, rules=NULL_RULES):
        x, positions = self._embed(batch, rules)
        x, caches = self._backbone(x, positions, rules, collect=True)
        x = self._final(x[:, -1:])
        return _logits(self.cfg, self, x, rules)[:, 0], caches

    def init_cache(self, batch, seq_len, dtype=torch.bfloat16):
        cfg = self.cfg
        kv = (len(self.group_sizes()), batch, seq_len, cfg.num_kv_heads,
              cfg.head_dim)
        mamba = _stack([init_mamba_cache(cfg, batch, dtype, self.device)
                        for _ in range(cfg.num_layers)])
        return {"k": torch.zeros(kv, dtype=dtype, device=self.device),
                "v": torch.zeros(kv, dtype=dtype, device=self.device),
                "mamba": mamba}

    def cache_specs(self):
        kv = (None, "batch", "kv_seq", "kv_heads", None)
        mamba = {"state": (None, "batch", "heads", None, None),
                 "conv_x": (None, "batch", None, "ff"),
                 "conv_B": (None, "batch", None, None),
                 "conv_C": (None, "batch", None, None)}
        return {"k": kv, "v": kv, "mamba": mamba}

    def decode_step(self, caches, tokens, pos, rules=NULL_RULES):
        """One token a row at `pos`: the shared block's new K/V row goes
        into `caches["k"][g]` / `["v"][g]` and each Mamba layer's state and
        conv tails into its slot of `caches["mamba"]`, all in place."""
        cfg = self.cfg
        sh = self.shared
        x = embed_tokens(cfg, self.emb, self._tensor(tokens)[:, None], rules)
        for g, layer_ids in self._groups():
            h = apply_norm(cfg, sh["ln1"], x)
            o, _, _ = T.attn_decode_sublayer(cfg, sh["attn"], h,
                                             caches["k"][g], caches["v"][g],
                                             pos, rules)
            x = x + o
            h = apply_norm(cfg, sh["ln2"], x)
            x = x + apply_mlp(cfg, sh["mlp"], h, rules)
            for i in layer_ids:
                p = self.layers[i]
                cache = {k: v[i] for k, v in caches["mamba"].items()}
                o, _ = decode_mamba(cfg, p["mamba"],
                                    apply_norm(cfg, p["ln"], x[:, 0]),
                                    cache, rules)
                x = x + o[:, None]
        logits = _logits(cfg, self, self._final(x), rules)[:, 0]
        return logits, caches


# ------------------------------------------------------------------ xLSTM LM
_CELLS = {"mlstm": (apply_mlstm, decode_mlstm),
          "slstm": (apply_slstm, decode_slstm)}


class XLSTMLM(BaseModel):
    """Alternating mLSTM / sLSTM blocks (xLSTM), pre-norm residual."""

    def block_kinds(self):
        cfg = self.cfg
        return [cfg.block_types[i % len(cfg.block_types)]
                for i in range(cfg.num_layers)]

    def _build(self, g):
        cfg = self.cfg
        kinds = self.block_kinds()

        def blocks(init_fn, n):
            return nn.ModuleList([nn.ModuleDict({
                "ln": make_norm_params(cfg, cfg.d_model, self.device),
                "cell": init_fn(cfg, g)}) for _ in range(n)])

        self.emb = make_embedding(cfg, g)
        self.mlstm = blocks(init_mlstm, kinds.count("mlstm"))
        self.slstm = blocks(init_slstm, kinds.count("slstm"))
        self.ln_f = make_norm_params(cfg, cfg.d_model, self.device)

    def param_specs(self):
        cfg = self.cfg
        ns = T.norm_specs(cfg)
        return {"emb": EMB_SPECS,
                "mlstm": T.stacked_specs({"ln": ns, "cell": dict(MLSTM_SPECS)}),
                "slstm": T.stacked_specs({"ln": ns, "cell": dict(SLSTM_SPECS)}),
                "ln_f": ns}

    def _blocks(self):
        """(kind, index within its kind, block) in layer order."""
        counters = {"mlstm": 0, "slstm": 0}
        for kind in self.block_kinds():
            i = counters[kind]
            counters[kind] += 1
            yield kind, i, getattr(self, kind)[i]

    def _forward(self, x, rules, collect=False):
        """Returns (x, the final states stacked by kind, or None). The
        reference's `states` argument has no caller and is left out."""
        cfg = self.cfg
        new_states = {"mlstm": [], "slstm": []}
        for kind, _, p in self._blocks():
            h = apply_norm(cfg, p["ln"], x)
            fn = _CELLS[kind][0]
            if collect:
                o, st = fn(cfg, p["cell"], h, rules, return_state=True)
                new_states[kind].append(st)
            else:
                o = fn(cfg, p["cell"], h, rules)
            x = x + o
        if collect:
            return x, {k: _stack(v) for k, v in new_states.items() if v}
        return x, None

    def loss_fn(self, batch, rules=NULL_RULES):
        cfg = self.cfg
        x = embed_tokens(cfg, self.emb, self._tensor(batch["tokens"]), rules)
        x, _ = self._forward(x, rules)
        logits = _logits(cfg, self, self._final(x), rules)
        loss = softmax_xent(cfg, logits, self._tensor(batch["targets"]),
                            rules)
        return loss, {"loss": loss, "xent": loss}

    def prefill(self, batch, rules=NULL_RULES):
        cfg = self.cfg
        x = embed_tokens(cfg, self.emb, self._tensor(batch["tokens"]), rules)
        x, states = self._forward(x, rules, collect=True)
        x = self._final(x[:, -1:])
        return _logits(cfg, self, x, rules)[:, 0], states

    def init_cache(self, batch, seq_len=None, dtype=torch.float32):
        """The zero recurrent states (f32 whatever `dtype`, as in the
        reference); `seq_len` is not needed."""
        kinds = self.block_kinds()
        return {kind: _stack([state0(self.cfg, batch, self.device)
                              for _ in range(kinds.count(kind))])
                for kind, state0 in (("mlstm", mlstm_state0),
                                     ("slstm", slstm_state0))
                if kind in kinds}

    def cache_specs(self):
        m = ((None, "batch", None, None, None), (None, "batch", None, None),
             (None, "batch", None))
        sv = (None, "batch", None, None)
        return {"mlstm": m, "slstm": (sv, sv, sv, sv)}

    def decode_step(self, caches, tokens, pos, rules=NULL_RULES):
        """One token a row; each block's new state is written into its slot
        of `caches` in place (`pos` is not needed)."""
        cfg = self.cfg
        x = embed_tokens(cfg, self.emb, self._tensor(tokens)[:, None],
                         rules)[:, 0]
        for kind, i, p in self._blocks():
            st = tuple(a[i] for a in caches[kind])
            h = apply_norm(cfg, p["ln"], x)
            o, new = _CELLS[kind][1](cfg, p["cell"], h, st, rules)
            for dst, src in zip(st, new):
                dst.copy_(src)
            x = x + o
        logits = _logits(cfg, self, self._final(x[:, None]), rules)[:, 0]
        return logits, caches


def _model_class(cfg):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM
    if cfg.family == "audio":
        return EncDecLM
    if cfg.family == "hybrid":
        return HybridLM
    if cfg.family == "ssm":
        return XLSTMLM
    raise KeyError(cfg.family)


def build_model(cfg, device=None, generator=None):
    """The model for `cfg` on `device` (None: the card; raises without one),
    its parameters drawn from `generator` (None: one seeded 0)."""
    return _model_class(cfg)(cfg, device=device, generator=generator)


class _MetaDraws:
    """Stands in for a generator on the meta device: every draw is a meta
    tensor of its shape (`common.dense_init`), nothing is drawn."""
    device = torch.device("meta")


def build_meta_model(cfg):
    """The model for `cfg` with every parameter and buffer a meta tensor of
    its shape and dtype: nothing drawn, nothing allocated. Only the
    dry-run builds one (`launch/dryrun.py`); every entry point builds its
    model on the card or the CPU with `build_model`."""
    cls = _model_class(cfg)
    model = cls.__new__(cls)
    nn.Module.__init__(model)
    model.cfg = cfg
    model.device = torch.device("meta")
    with torch.no_grad():
        model._build(_MetaDraws())
    return model
