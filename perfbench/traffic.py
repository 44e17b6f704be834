"""The one traffic generator: it reads a traffic file's parameters and
makes a cell's inputs from `--seed`.

A traffic file (`perfbench/traffic/<name>.json`) holds:

  pool_items            distinct items made from the seed, cycled through
                        by a closed loop (the next item goes in when the
                        last comes out)
  long_chunks_per_item  60 s stereo long chunks in one item
  label_probs           the generator's (bird, rain, cicada, silence) mix
  persistence           the label chain's probability of keeping a label
  segment_s             seconds of one labelled segment
  about                 what the mix stands for, and its source

Items are made on the device by `synthetic.long_chunks`, from a seed
drawn from `--seed`, and handed to the program as host arrays.
"""
from __future__ import annotations

import numpy as np

from perfbench import synthetic

def task_seed(seed, k):
    """A seed for part `k` of the inputs of `--seed` (any whole number up
    to 2**63)."""
    ss = np.random.SeedSequence([int(seed) % 2**63, int(k)])
    return int(ss.generate_state(1, np.uint32)[0])


def make_items(traffic, seed, device="cpu"):
    """The traffic's pool: `pool_items` host arrays, each
    (long_chunks_per_item, 2, S) f32, made on `device`."""
    per_item = int(traffic["long_chunks_per_item"])
    n_long = int(traffic["pool_items"]) * per_item
    longs = synthetic.long_chunks(task_seed(seed, 0), n_long,
                                  traffic["label_probs"],
                                  float(traffic["persistence"]),
                                  float(traffic.get("segment_s", 5.0)),
                                  device=device)
    return [longs[i:i + per_item] for i in range(0, n_long, per_item)]
