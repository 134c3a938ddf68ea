"""quotient_s: the program's `quotient` phase (runtime/tracing.phase, which synchronises
the card at its close), seconds per proof over the traced window's proofs."""


def read(run):
    got = [t["quotient"] for t in run.phase_times if "quotient" in t]
    return sum(got) / len(got) if got else None
