"""The port's attention-family archs against the JAX package's, each at its
`reduced` config and f32 with the reference's `init(jax.random.key(0))`
parameters loaded into the port: loss, prefill logits and K/V caches, and
one decode step's logits. Then the port on its own: decoding token k
against the prefill cache of tokens[:k] reproduces prefill(tokens[:k+1])'s
next-token logits at the reference's own tolerance
(`tests/test_models.py::test_decode_matches_prefill`).

Tolerances: the loss rtol 1e-5; logits rtol = atol = 1e-4 between the
frameworks; caches 1e-5; decode against prefill 5e-3, with caches in the
model's dtype (f32) for all eight archs and in bf16 (the caches' default)
for the five the reference's test takes. With bf16 caches the untied archs
(minitron, nemotron, arctic) miss 5e-3 in the reference too (0.011 and
0.019 for minitron and arctic), which is why its test leaves them out."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS, reduced as rreduced
from repro.distributed.sharding import NULL_RULES as RR
from repro.models.zoo import build_model as rbuild
from repro_torch.configs import ARCHS, reduced
from repro_torch.models.reference_params import load_reference_params
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import decode_caches

ATTENTION_ARCHS = sorted(a for a, c in ARCHS.items()
                         if c.family in ("dense", "moe", "vlm", "audio"))
B, S = 2, 32


def _batch(cfg, seed=1):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "targets": tokens}
    if cfg.num_prefix_tokens:
        batch["prefix"] = rng.randn(B, cfg.num_prefix_tokens,
                                    cfg.d_model).astype(np.float32)
    if cfg.is_enc_dec:
        batch["enc_frames"] = rng.randn(B, 16, cfg.d_model).astype(np.float32)
    return batch


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want), rtol=tol, atol=tol)


def test_the_eight_attention_archs():
    assert len(ATTENTION_ARCHS) == 8


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_arch_matches_reference(arch):
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    rcfg = dataclasses.replace(rreduced(RARCHS[arch]), dtype="float32")
    rmodel = rbuild(rcfg)
    params = rmodel.init(jax.random.key(0))
    model = load_reference_params(build_model(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, params))
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k = S - 1
    head = dict(batch, tokens=batch["tokens"][:, :k])
    jhead = {kk: jnp.asarray(v) for kk, v in head.items()}
    P = cfg.num_prefix_tokens or 0
    ekw = {"enc_len": 16} if cfg.is_enc_dec else {}
    tok = batch["tokens"][:, k]

    @jax.jit
    def reference(p, b, bh):
        loss, metrics = rmodel.loss_fn(p, b, RR)
        logits, caches = rmodel.prefill(p, b, RR)
        _, hc = rmodel.prefill(p, bh, RR)
        cache = rmodel.init_cache(B, S + P, dtype=jnp.float32, **ekw)
        cache = {kk: cache[kk].at[:, :, :hc[kk].shape[2]].set(hc[kk])
                 for kk in cache}
        dlogits, _ = rmodel.decode_step(p, cache, jnp.asarray(tok), P + k, RR)
        return loss, metrics, logits, caches, dlogits

    rloss, rmetrics, rlogits, rcaches, rdlogits = reference(params, jbatch,
                                                            jhead)
    with torch.inference_mode():
        loss, metrics = model.loss_fn(batch)
        logits, caches = model.prefill(batch)
        _, hc = model.prefill(head)
        cache = decode_caches(model, hc, S + P, dtype=torch.float32)
        dlogits, cache2 = model.decode_step(cache, torch.as_tensor(tok),
                                            P + k)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert set(metrics) == set(rmetrics)
    for name in rmetrics:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(rmetrics[name]), rtol=1e-5)
    assert logits.shape == (B, cfg.padded_vocab)
    _close(logits, rlogits, 1e-4)
    assert set(caches) == set(rcaches)
    for kk in rcaches:
        assert caches[kk].shape == rcaches[kk].shape
        _close(caches[kk], rcaches[kk], 1e-5)
    _close(dlogits, rdlogits, 1e-4)
    assert cache2 is cache                      # written in place


REFERENCE_DECODE_ARCHS = ["gemma-7b", "granite-moe-3b-a800m", "llama3.2-3b",
                          "paligemma-3b", "whisper-small"]


@pytest.mark.parametrize("arch,cache_dtype", [
    (a, torch.float32) for a in ATTENTION_ARCHS] + [
    (a, torch.bfloat16) for a in REFERENCE_DECODE_ARCHS])
def test_decode_matches_prefill(arch, cache_dtype):
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32",
                              moe_capacity_factor=16.0)   # dropless: decode
    # has no capacity drops, so prefill must not drop either to compare
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    full = _batch(cfg)
    k = S - 1
    P = cfg.num_prefix_tokens or 0
    with torch.inference_mode():
        want, _ = model.prefill(full)
        _, pf = model.prefill(dict(full, tokens=full["tokens"][:, :k]))
        caches = decode_caches(model, pf, S + P, dtype=cache_dtype)
        got, _ = model.decode_step(caches, torch.as_tensor(
            full["tokens"][:, k]), P + k)
    assert got.shape == (B, cfg.padded_vocab) and torch.isfinite(got).all()
    _close(got, want, 5e-3)


def test_moe_balance_metrics_exposed():
    cfg = reduced(ARCHS["granite-moe-3b-a800m"])
    model = build_model(cfg, device="cpu")
    with torch.inference_mode():
        loss, metrics = model.loss_fn(_batch(cfg))
    assert "lb_loss" in metrics and "dropped_frac" in metrics
    assert float(metrics["dropped_frac"]) < 0.5
    assert 2.0 < float(loss) < 12.0            # ~ln(vocab) at init


def test_vocab_padding_masked_in_loss():
    cfg = reduced(ARCHS["whisper-small"])          # vocab 512 stays unpadded
    assert cfg.padded_vocab == cfg.vocab_size
    full = ARCHS["granite-moe-3b-a800m"]
    assert full.padded_vocab % 256 == 0
    assert full.padded_vocab >= full.vocab_size
