"""idle_outside_plan_ms.archive: the device's idle ms a traced batch in
gaps whose middle lies in no program span (`obs/...`): the caller between
batches, that is the runner's loop (`perfbench/runners/archive.py`, its
`correct` sampling included) and `Preprocessor.run`'s generator. The
complement of idle_in_plan_ms.archive, whose `split` it reads."""
from perfbench.spec import HERE, load_module

_idle = load_module(HERE / "metrics" / "idle_in_plan_ms.archive.py",
                    "perfbench_idle_in_plan")


def read(run):
    parts = _idle.split(run)
    return None if parts is None else 1e3 * parts[1] / parts[2]
