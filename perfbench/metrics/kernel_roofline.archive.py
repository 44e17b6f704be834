"""kernel_roofline.archive: sum of least times over sum of device times of
every hand-kernel launch in the traced window, % (roofline/_share.py)."""
from perfbench.spec import HERE, load_module

_share = load_module(HERE / "roofline" / "_share.py", "perfbench_share")


def read(run):
    return _share.share(run)
