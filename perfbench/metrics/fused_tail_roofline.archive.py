"""fused_tail_roofline.archive: the fused survivor tail's least time over
its device time in the traced window, % (roofline/_share.py)."""
from perfbench.spec import HERE, load_module

_share = load_module(HERE / "roofline" / "_share.py", "perfbench_share")


def read(run):
    return _share.share(run, only=("fused_tail",))
