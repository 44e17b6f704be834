"""The port's language-model serving path against the JAX package's:
`ServeEngine` greedy tokens on the reference's parameters at f32, the ports
of the reference's engine and queue tests, the launcher's LM mode, and the
entry points that must not fall back to the CPU."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS, reduced as rreduced
from repro.models.zoo import build_model as rbuild
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.models.reference_params import load_reference_params
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import RequestQueue, ServeEngine

ATTENTION_ARCHS = sorted(a for a, c in ARCHS.items()
                         if c.family in ("dense", "moe", "vlm", "audio"))
NEAR_TIE = 1e-4        # the logit tolerance between the frameworks


def _extra(cfg, B, rng):
    if cfg.num_prefix_tokens:
        return {"prefix": rng.randn(B, cfg.num_prefix_tokens,
                                    cfg.d_model).astype(np.float32)}
    if cfg.is_enc_dec:
        return {"enc_frames": rng.randn(B, 16, cfg.d_model).astype(
            np.float32)}
    return None


def _reference_margins(eng, prompts, n, extra):
    """The reference engine's own loop (its jitted prefill and decode),
    keeping each step's gap between the top two logits: (tokens, gaps)."""
    cfg = eng.cfg
    batch = {"tokens": jnp.asarray(prompts), **(extra or {})}
    logits, pf = eng._prefill(eng.params, batch)
    kw = {"enc_len": pf["xk"].shape[2]} if cfg.is_enc_dec else {}
    caches = eng.model.init_cache(prompts.shape[0], eng.max_seq, **kw)
    caches = {k: jax.lax.dynamic_update_slice(
        caches[k], pf[k].astype(caches[k].dtype), (0,) * 5) for k in caches}
    toks, gaps = [], []
    for i in range(n):
        lg = np.asarray(logits)[:, :cfg.vocab_size]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        toks.append(lg.argmax(-1).astype(np.int32))
        if i + 1 < n:
            pos = (cfg.num_prefix_tokens or 0) + prompts.shape[1] + i
            logits, caches = eng._decode(eng.params, caches,
                                         jnp.asarray(toks[-1]),
                                         jnp.int32(pos))
    return np.stack(toks, 1), np.stack(gaps, 1)


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_greedy_tokens_equal_reference(arch):
    """Same parameters, same prompts: the same greedy tokens. A row stops
    being compared from the first step whose top two reference logits lie
    within NEAR_TIE (either token is right there); such rows are rare."""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    rcfg = dataclasses.replace(rreduced(RARCHS[arch]), dtype="float32")
    rmodel = rbuild(rcfg)
    params = rmodel.init(jax.random.key(0))
    model = load_reference_params(build_model(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, params))
    rng = np.random.RandomState(11)
    B, S, n = 4, 8, 8
    prompts = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = _extra(cfg, B, rng)
    reng = RServeEngine(rmodel, params, max_seq=48)
    want = reng.generate(prompts, n, extra_batch=extra)
    loop, gaps = _reference_margins(reng, prompts, n, extra)
    np.testing.assert_array_equal(loop, want)
    got = ServeEngine(model, max_seq=48, device="cpu").generate(
        prompts, n, extra_batch=extra)
    assert got.shape == (B, n) and got.dtype == np.int32
    stopped = 0
    for b in range(B):
        tie = np.flatnonzero(gaps[b] < NEAR_TIE)
        upto = tie[0] if tie.size else n
        stopped += upto < n
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])
    assert stopped <= 1, f"{stopped} of {B} rows hit a near-tie"


def test_serve_engine_greedy_deterministic():
    cfg = reduced(ARCHS["llama3.2-3b"])
    model = build_model(cfg, device="cpu")
    eng = ServeEngine(model, max_seq=48, device="cpu")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8))
    a = eng.generate(prompts, 6)
    b = eng.generate(prompts, 6)
    np.testing.assert_array_equal(a, b)
    assert (a < cfg.vocab_size).all()


def test_sampling_draws_from_the_generator():
    cfg = reduced(ARCHS["llama3.2-3b"])
    model = build_model(cfg, device="cpu")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8))
    eng = ServeEngine(model, max_seq=48, temperature=1.0, device="cpu")
    a, b = eng.generate(prompts, 6, seed=3), eng.generate(prompts, 6, seed=3)
    np.testing.assert_array_equal(a, b)
    assert (a < cfg.vocab_size).all() and (a >= 0).all()
    assert not np.array_equal(a, eng.generate(prompts, 6, seed=4))
    g = torch.Generator().manual_seed(5)
    eng = ServeEngine(model, max_seq=48, temperature=1.0, generator=g,
                      device="cpu")
    first = eng.generate(prompts, 6)
    assert not np.array_equal(first, eng.generate(prompts, 6))
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(prompts, 41)


def test_request_queue_serves_all():
    """The reference's test runs xlstm, a recurrent arch the port does not
    have yet; a reduced llama here."""
    cfg = reduced(ARCHS["llama3.2-3b"])
    model = build_model(cfg, device="cpu")
    eng = ServeEngine(model, max_seq=32, device="cpu")
    q = RequestQueue(eng, batch_size=3, prompt_len=8, n_tokens=4)
    rng = np.random.RandomState(1)
    rids = [q.submit(rng.randint(0, cfg.vocab_size, 8)) for _ in range(5)]
    done = {}
    while len(done) < len(rids):
        for r in q.pump():
            assert r not in done
            done[r] = q.result(r)
    assert q.pump() == []
    for r in rids:
        assert done[r].shape == (4,)
        assert q.result(r) is None   # popped: handed over exactly once


def test_request_queue_zero_pads_a_short_batch():
    """The last batch of 5 requests in 3s is padded with zero prompts; a
    request's tokens do not depend on which batch it rode in."""
    cfg = reduced(ARCHS["llama3.2-3b"])
    eng = ServeEngine(build_model(cfg, device="cpu"), max_seq=32,
                      device="cpu")
    q = RequestQueue(eng, batch_size=3, prompt_len=8, n_tokens=4)
    prompts = np.random.RandomState(2).randint(0, cfg.vocab_size, (5, 8))
    rids = [q.submit(p) for p in prompts]
    assert q.pump() == rids[:3] and q.pump() == rids[3:]
    alone = eng.generate(np.stack([prompts[4], np.zeros(8, int),
                                   prompts[3]]), 4)
    np.testing.assert_array_equal(q.result(rids[4]), alone[0])
    np.testing.assert_array_equal(q.result(rids[3]), alone[2])


def test_launch_serve_lm_mode_is_seeded(capsys):
    """The launcher's LM mode on the CPU: the same --seed gives the same
    weights, prompts and tokens; every sampled token is in the vocab."""
    from repro_torch.launch import serve
    argv = ["--arch", "gemma-7b", "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "8", "--gen", "4", "--requests", "3",
            "--seed", "3"]
    lines = []
    for _ in range(2):
        assert sorted(serve.main(argv)) == [0, 1, 2]
        out = capsys.readouterr().out
        assert "served 3 requests, 12 tokens in" in out and "on cpu" in out
        lines.append(out.splitlines()[-1])
    assert lines[0] == lines[1] and lines[0].startswith(
        "sample output tokens: [")
    toks = json.loads(lines[0].split(": ", 1)[1])
    assert len(toks) == 4 and all(0 <= t < 512 for t in toks)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_build_model_builds_every_reduced_arch(arch):
    """All ten archs: the family's class, on the CPU, and a finite
    prefill."""
    from repro_torch.models import zoo
    cfg = reduced(ARCHS[arch])
    model = build_model(cfg, device="cpu")
    want = {"dense": zoo.DecoderLM, "moe": zoo.DecoderLM,
            "vlm": zoo.DecoderLM, "audio": zoo.EncDecLM,
            "hybrid": zoo.HybridLM, "ssm": zoo.XLSTMLM}[cfg.family]
    assert type(model) is want and model.device.type == "cpu"
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (2, 8))}
    batch.update(_extra(cfg, 2, rng) or {})
    with torch.inference_mode():
        logits, caches = model.prefill(batch)
    assert logits.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(logits).all() and caches


def _entry_points():
    from repro_torch.launch import serve
    cfg = reduced(ARCHS["llama3.2-3b"])
    return {
        "build_model": lambda: build_model(cfg),
        "ServeEngine": lambda: ServeEngine(build_model(cfg, device="cpu")),
        "launch.serve": lambda: serve.main(["--reduced"]),
    }


@pytest.mark.parametrize("name", ["build_model", "ServeEngine",
                                  "launch.serve"])
def test_entry_points_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
