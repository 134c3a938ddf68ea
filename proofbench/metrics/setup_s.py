"""setup_s: seconds from the process's start to the window's start (imports,
the card, kernels loaded or built, the warm proof, the window's traces)."""


def read(run):
    return run.setup_s
