"""Batched serving engine: prefill + decode loop with a host-side request
queue (the port's copy of the reference's `serve/engine.py`).

This is the language-model twin of `serve.preprocess_service`; the
preprocessing traffic path with persistent workers and continuous batching
lives in `serve.pool` + `serve.batcher`.

Differences from the reference, by design:
  * The model (an `nn.Module`) carries its parameters, so `ServeEngine`
    takes no `params` argument; it runs on the model's device, which must
    be the one `device` resolves to (None: the card; raises without one).
  * Decode writes each new K/V row, SSM state or xLSTM state into the
    cache in place (the reference donates the cache buffers to each jitted
    step).
  * Sampling with a temperature draws from a `torch.Generator`, whose
    stream is not `jax.random`'s: sampled tokens differ from the
    reference's, greedy ones (temperature 0) do not.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.distributed.sharding import NULL_RULES
from repro_torch.models.zoo import model_device


KV_CACHES = ("k", "v", "xk", "xv")


def decode_caches(model, pf_caches, max_seq, dtype=None):
    """The decode caches built from `model.prefill`'s caches, by family, as
    the reference's engine builds them: the recurrent ssm family (xLSTM)
    decodes on its prefill states as they are; every other family gets
    `model.init_cache(B, max_seq)` (in `dtype` if given) with the prefill's
    K/V slabs ("k", "v"; cross "xk", "xv") copied into its first rows, and
    any other entry (the hybrid's "mamba" states and conv tails) taken
    from the prefill as it is."""
    cfg = model.cfg
    if cfg.family == "ssm":
        return pf_caches
    kw = {} if dtype is None else {"dtype": dtype}
    if cfg.is_enc_dec:
        kw["enc_len"] = pf_caches["xk"].shape[2]
    caches = model.init_cache(pf_caches["k"].shape[1], max_seq, **kw)
    for k, src in pf_caches.items():
        if k in KV_CACHES:
            caches[k][:, :, :src.shape[2]].copy_(src)
        else:
            caches[k] = src
    return caches


class ServeEngine:
    def __init__(self, model, rules=NULL_RULES, max_seq=512, eos_id=None,
                 temperature=0.0, generator=None, device=None):
        self.device = model_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.rules = rules
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.temperature = temperature
        self.generator = generator

    def _sample(self, logits, generator):
        logits = logits[..., :self.cfg.vocab_size]
        if self.temperature <= 0.0:
            return logits.argmax(-1)        # the first maximum, as jnp's
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def generate(self, prompts, n_tokens, seed=0, extra_batch=None):
        """prompts: (B, S_prompt) integer array. Returns (B, n_tokens) int32
        numpy.

        Runs prefill once, builds the decode caches from its caches
        (`decode_caches`: K/V copied into caches of `max_seq` rows,
        recurrent states as they are), then n_tokens - 1 decode steps
        against them. With a
        temperature, draws from the engine's generator, else from one
        seeded `seed`."""
        prompts = np.asarray(prompts)
        B, S = prompts.shape
        if S + n_tokens > self.max_seq:
            raise ValueError(f"prompt {S} + {n_tokens} tokens exceed "
                             f"max_seq {self.max_seq}")
        gen = self.generator
        if gen is None and self.temperature > 0.0:
            gen = torch.Generator(self.device).manual_seed(seed)
        with torch.inference_mode():
            batch = {"tokens": torch.as_tensor(prompts, device=self.device)}
            for k, v in (extra_batch or {}).items():
                batch[k] = torch.as_tensor(v, device=self.device)
            logits, pf_caches = self.model.prefill(batch, self.rules)

            caches = decode_caches(self.model, pf_caches, self.max_seq)

            prefix_off = self.cfg.num_prefix_tokens or 0
            out = torch.empty((B, n_tokens), dtype=torch.int32,
                              device=self.device)
            tok = self._sample(logits, gen)
            out[:, 0] = tok
            for i in range(1, n_tokens):
                pos = prefix_off + S + i - 1
                logits, caches = self.model.decode_step(caches, tok, pos,
                                                        self.rules)
                tok = self._sample(logits, gen)
                out[:, i] = tok
            return out.cpu().numpy()


class RequestQueue:
    """Host-side batched request pump: collects requests, serves them in
    fixed-size batches (the serving analogue of the paper's slave pull
    queue)."""

    def __init__(self, engine, batch_size, prompt_len, n_tokens):
        self.engine = engine
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        self.n_tokens = n_tokens
        self._queue = collections.deque()
        self._results = {}
        self._next_id = 0

    def submit(self, prompt):
        rid = self._next_id
        self._next_id += 1
        p = np.asarray(prompt, np.int32)[:self.prompt_len]
        p = np.pad(p, (0, self.prompt_len - len(p)))
        self._queue.append((rid, p))
        return rid

    def pump(self):
        """Serve one full (zero-padded) batch from the queue; returns the
        request ids it answered."""
        if not self._queue:
            return []
        batch, rids = [], []
        while self._queue and len(batch) < self.batch_size:
            rid, p = self._queue.popleft()
            rids.append(rid)
            batch.append(p)
        while len(batch) < self.batch_size:      # zero-pad, never copies
            batch.append(np.zeros(self.prompt_len, np.int32))
        toks = self.engine.generate(np.stack(batch), self.n_tokens)
        for i, rid in enumerate(rids):
            self._results[rid] = toks[i]
        return rids

    def result(self, rid):
        """Pop a finished request's tokens (handed over exactly once, so
        the result map stays bounded by in-flight work)."""
        return self._results.pop(rid, None)
