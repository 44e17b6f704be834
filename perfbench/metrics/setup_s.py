"""setup_s: from the start of the process to the first timed batch:
generating the inputs, building and loading the kernels, the program's
set-up (mesh, plan) and the warm-up."""


def read(run):
    return run.record["setup_s"]
