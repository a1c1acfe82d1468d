"""setup_s: seconds from the process's start, as the kernel records it, to the
first timed unit: imports, the kernels' build or load, the model, the
weights, the inputs and the warm-up."""


def read(run):
    return run.setup_s
