"""launches_per_proof: device kernels in the profiler's trace of the window
(copies and memsets left out), over the proofs completed in it."""


def read(run):
    if run.trace is None or not run.proofs or not len(run.trace.dev_start):
        return None
    return run.trace.kernel_count() / run.proofs
