"""aux_s: the program's `aux` phase (runtime/tracing.phase, which synchronises
the card at its close), seconds per proof over the traced window's proofs."""


def read(run):
    got = [t["aux"] for t in run.phase_times if "aux" in t]
    return sum(got) / len(got) if got else None
