"""The result codec of the reference's `dist/service.py`: a `BatchResult`
as a numpy-only payload and back. The chunk store keeps its entries in
this shape, and the reference's workers send it to their master, so the
port writes and reads the same dicts.

The master's `QueueService` and the rest of the runtime come with the
distribution slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import PipelineOutput


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def pack_result(res) -> dict:
    """BatchResult -> payload: masks + stats + cleaned survivors, all
    numpy. The pre-denoise wave5 intermediate is not kept, only its width,
    so that the reader can rebuild a det record of the right shape."""
    det = res.det
    return {
        "cleaned": np.asarray(_host(res.cleaned), np.float32),
        "keep": _host(det.keep), "rain": _host(det.rain),
        "silence": _host(det.silence), "cicada15": _host(det.cicada15),
        "stats": {k: (int(v) if k == "n_chunks5" else float(v))
                  for k, v in det.stats.items()},
        "n_kept": int(res.n_kept), "src_bytes": int(res.src_bytes),
        "wave_width": int(det.wave5.shape[-1]),
    }


def unpack_result(payload):
    """payload -> (PipelineOutput of CPU tensors, fields): fields carries
    cleaned / n_kept / src_bytes. wave5 is zeros at the recorded shape, as
    in the reference: an intermediate no consumer reads."""
    keep = torch.as_tensor(payload["keep"])
    wave5 = torch.zeros((keep.shape[0], int(payload["wave_width"])),
                        dtype=torch.float32)
    det = PipelineOutput(wave5=wave5, keep=keep,
                         rain=torch.as_tensor(payload["rain"]),
                         silence=torch.as_tensor(payload["silence"]),
                         cicada15=torch.as_tensor(payload["cicada15"]),
                         stats=dict(payload["stats"]))
    return det, {"cleaned": payload["cleaned"],
                 "n_kept": int(payload["n_kept"]),
                 "src_bytes": int(payload["src_bytes"])}
