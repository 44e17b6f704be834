"""The comparison that decides `correct`: what the timed path produced
against the plain reference on the same inputs.

`judge` holds any runner's numbers to a configuration's limits. The rest
is the SERF pipeline's tally, which `runners/archive.py` hands the
harness. Its numbers, each with a limit from the configuration file:

  mask_mismatch    chunks whose keep / rain / silence (5 s) or cicada
                   (15 s, where the path returns it) differ from the
                   reference, among the chunks the reference decides
                   (`reference.serf.MARGIN`), plus any cleaned row missing
                   or extra against the path's own keep mask
  wave5_err        the largest |program - reference| of a 5 s chunk
                   before denoising (the FIR, the STFT, the band-stop and
                   the iSTFT) over the largest |reference| sample of that
                   chunk, over every chunk whose band-stop is decided
  cleaned_err      the largest |program - reference| of a cleaned chunk
                   over the largest |reference| sample of that chunk, over
                   every chunk both kept (decided, band-stop not open)
  cleaned_rms      the root of the summed squared differences over the root
                   of the summed squared reference, over the same chunks
  repeat_mismatch  window items whose survivor count differs from the
                   first time the same input went through the window
"""
from __future__ import annotations

import math

import numpy as np

NUMBERS = ("mask_mismatch", "wave5_err", "cleaned_err", "cleaned_rms",
           "repeat_mismatch")
BIG = 1e30          # what a number that is not finite reads as


class Tally:
    def __init__(self):
        self.mask_mismatch = 0
        self.wave5_err = 0.0
        self.cleaned_err = 0.0
        self.sq_diff = 0.0
        self.sq_ref = 0.0
        self.rows = 0               # cleaned chunks compared
        self.chunks = 0             # 5 s chunks seen
        self.undecided = 0          # 5 s chunks the reference leaves open
        self.items = 0

    def add(self, prog, ref):
        """One batch: `prog` holds the path's host arrays
        (keep, rain, silence, [cicada15], cleaned), `ref` the reference's
        (`reference.serf.run`)."""
        self.items += 1
        keep = np.asarray(prog["keep"], bool)
        self.chunks += keep.size
        self.undecided += int((~ref["keep_decided"]).sum())
        for m in ("keep", "rain", "silence", "cicada15"):
            if m not in prog:
                continue
            got = np.asarray(prog[m], bool)
            want = ref[m]
            if got.shape != want.shape:
                self.mask_mismatch += max(got.size, want.size)
                continue
            self.mask_mismatch += int(((got != want)
                                       & ref[f"{m}_decided"]).sum())
        self._wave5(prog.get("wave5"), ref)
        cleaned = np.asarray(prog["cleaned"])
        self.mask_mismatch += abs(cleaned.shape[0] - int(keep.sum()))
        if cleaned.shape[0] != int(keep.sum()) or keep.shape != \
                ref["keep"].shape:
            return
        row_p = np.cumsum(keep) - 1
        row_r = np.cumsum(ref["keep"]) - 1
        both = keep & ref["keep"] & ref["keep_decided"] \
            & ~ref["bandstop_open5"]
        for c in np.flatnonzero(both):
            got = cleaned[row_p[c]].astype(np.float64)
            want = ref["cleaned"][row_r[c]].astype(np.float64)
            d = got - want
            scale = max(float(np.abs(want).max()), 1e-6)
            e = float(np.abs(d).max()) / scale
            self.cleaned_err = max(self.cleaned_err,
                                   e if math.isfinite(e) else BIG)
            self.sq_diff += float((d * d).sum())
            self.sq_ref += float((want * want).sum())
            self.rows += 1

    def _wave5(self, wave, ref):
        if wave is None:
            return
        wave = np.asarray(wave)
        if wave.shape != ref["wave5"].shape:
            self.wave5_err = BIG
            return
        for c in np.flatnonzero(~ref["bandstop_open5"]):
            want = ref["wave5"][c].astype(np.float64)
            d = np.abs(wave[c].astype(np.float64) - want).max()
            e = float(d) / max(float(np.abs(want).max()), 1e-6)
            self.wave5_err = max(self.wave5_err,
                                 e if math.isfinite(e) else BIG)

    def numbers(self, repeat_mismatch=0):
        rms = (math.sqrt(self.sq_diff / self.sq_ref) if self.sq_ref > 0
               else 0.0)
        out = {"mask_mismatch": self.mask_mismatch,
               "wave5_err": self.wave5_err,
               "cleaned_err": self.cleaned_err,
               "cleaned_rms": rms if math.isfinite(rms) else BIG,
               "repeat_mismatch": repeat_mismatch}
        return out

    def coverage(self):
        return {"items": self.items, "chunks": self.chunks,
                "undecided_chunks": self.undecided,
                "cleaned_rows_compared": self.rows}


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}): every number a tally gave
    (`numbers`, in its order) at or under its limit. Limits that lack a
    number the tally gives, or hold one it does not give, are refused."""
    if set(numbers) != set(limits):
        raise KeyError(f"the limits {sorted(limits)} do not name the "
                       f"numbers compared {list(numbers)}")
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(v["value"] <= v["limit"] for v in table.values()), table


def program_arrays(det, cleaned):
    """The host arrays of a program's detection record (its masks and its
    5 s chunks before denoising) and cleaned rows."""
    out = {"cleaned": np.asarray(cleaned)}
    for m in ("keep", "rain", "silence", "cicada15", "wave5"):
        t = getattr(det, m, None) if not isinstance(det, dict) \
            else det.get(m)
        if t is None:
            continue
        out[m] = (t.detach().cpu().numpy() if hasattr(t, "detach")
                  else np.asarray(t))
    return out
