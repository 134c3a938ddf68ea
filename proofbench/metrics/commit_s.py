"""commit_s: the program's `commit` phase (runtime/tracing.phase, which synchronises
the card at its close), seconds per proof over the traced window's proofs."""


def read(run):
    got = [t["commit"] for t in run.phase_times if "commit" in t]
    return sum(got) / len(got) if got else None
