"""End-to-end example on the PyTorch/CUDA port: the paper's preprocessing
pipeline feeding a whisper-family audio model — preprocess, featurize,
train (the port's twin of `examples/preprocess_and_train.py`).

The pipeline's cleaned 5 s chunks become STFT-frame embeddings (the stubbed
conv frontend), and the whisper-small-family encoder-decoder trains to
predict per-chunk pseudo-transcripts (synthetic token streams keyed to the
chunk's acoustic label — enough structure for the loss to fall). On the
card three hand kernels run on this path: the FIR and STFT of the
detection phase, the fused survivor tail, and the STFT again in
`featurize`.

  PYTHONPATH=src python examples/preprocess_and_train_torch.py --steps 60
  PYTHONPATH=src python examples/preprocess_and_train_torch.py --device cpu

Without a card and without `--device cpu` it fails.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, SERF_AUDIO, reduced
from repro_torch.core import stages as S
from repro_torch.core.plans import Preprocessor
from repro_torch.data.synthetic import generate_labelled
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import NULL_RULES
from repro_torch.models.zoo import build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def spectrogram(cfg_audio, chunks, device):
    """Cleaned 5 s chunks -> their STFT power (B, F, bins) on `device`
    (the STFT kernel on the card, its plain version on the CPU)."""
    _, power = S.stft_chunks(torch.as_tensor(chunks, device=device),
                             cfg_audio)
    return power


def featurize(cfg_audio, model_cfg, chunks, device, n_frames=64):
    """Cleaned 5 s chunks -> frame embeddings (B, n_frames, d_model) on
    `device`: the 'conv frontend stub' = pooled log-power STFT frames
    projected by a fixed random matrix (a generator seeded 7)."""
    feats = torch.log1p(spectrogram(cfg_audio, chunks, device))
    F = feats.shape[1] - feats.shape[1] % n_frames
    feats = feats[:, :F].reshape(feats.shape[0], n_frames, -1,
                                 feats.shape[-1]).mean(dim=2)
    proj = torch.randn((feats.shape[-1], model_cfg.d_model),
                       generator=torch.Generator(device).manual_seed(7),
                       device=device) * 0.05
    return feats @ proj


def minute(step):
    """The step's fresh minute of audio, its twelve labelled 5 s chunks
    laid end to end as one long stereo chunk: ((1, 2, samples), labels)."""
    audio, labels = generate_labelled(step, 12, segment_s=5.0)
    S5 = audio.shape[-1]
    return audio.reshape(1, 12, 2, S5).transpose(0, 2, 1, 3).reshape(
        1, 2, 12 * S5), labels


def main(argv=None):
    """Returns {"losses": each trained step's loss, "steps_per_s"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dec-len", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model_cfg = reduced(ARCHS["whisper-small"])
    model = build_model(model_cfg, device=device)
    opt = OptConfig(lr=3e-3, warmup_steps=10, decay_steps=args.steps)
    opt_state = init_train_state(model, opt,
                                 torch.Generator(device).manual_seed(0))
    step_fn = make_train_step(model, NULL_RULES, opt)

    pre = Preprocessor(SERF_AUDIO, plan="two_phase", device=device)
    rng = np.random.RandomState(0)
    t0, losses = time.time(), []
    for step in range(1, args.steps + 1):
        # 1) preprocess a fresh minute of audio (early-exit pipeline)
        lc, labels = minute(step)
        res = pre(lc)
        if res.n_kept == 0:
            continue
        kept_labels = labels[res.det.keep.cpu().numpy()]
        # 2) featurize survivors; batch up
        idx = rng.choice(res.n_kept, size=args.batch)
        frames = featurize(SERF_AUDIO, model_cfg, res.cleaned[idx], device)
        # pseudo-transcripts keyed to the acoustic label
        base = (kept_labels[idx][:, None] * 31 + 5).astype(np.int32)
        toks = (base + np.arange(args.dec_len)[None, :] * 7) % \
            model_cfg.vocab_size
        batch = {"enc_frames": frames, "tokens": toks, "targets": toks}
        # 3) train
        opt_state, metrics = step_fn(opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0:
            print(f"step {step:4d} kept {res.n_kept:2d}/12 chunks  "
                  f"loss {losses[-1]:.3f}  "
                  f"({step / (time.time() - t0):.2f} steps/s)", flush=True)
    steps_per_s = args.steps / (time.time() - t0)
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'LEARNED' if losses[-1] < losses[0] * 0.8 else 'check setup'})")
    return {"losses": losses, "steps_per_s": steps_per_s}


if __name__ == "__main__":
    main()
