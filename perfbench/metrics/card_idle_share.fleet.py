"""card_idle_share.fleet: the share of each card's traced part in which no
kernel, copy or set ran there, the mean over the cards, % (each worker's
`torch.profiler` over its card, `runners/fleet.py`'s `CardTraces`)."""


def read(run):
    cards = getattr(run.trace, "cards", None)
    if not cards or not run.trace.device:
        return None
    shares = [1.0 - t.busy_s() / t.window_s for t in cards.values()
              if t.window_s > 0]
    return 100.0 * sum(shares) / len(shares) if shares else None
