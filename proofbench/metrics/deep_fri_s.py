"""deep_fri_s: the program's `openings` plus `deep_fri` phases (openings at
zeta and g*zeta, the DEEP codeword, FRI with its query openings), seconds
per proof over the traced window's proofs."""


def read(run):
    got = [t["openings"] + t["deep_fri"] for t in run.phase_times
           if "openings" in t and "deep_fri" in t]
    return sum(got) / len(got) if got else None
