"""proof_s: the window's seconds over the proofs completed in it."""


def read(run):
    return run.window_s / run.proofs if run.proofs else None
