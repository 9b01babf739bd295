"""stage.sat_proof_s: the port's Timer total of R1CSProof::prove (every
SAT proof of a prove, summed), averaged over the window's proves."""


def read(ctx):
    v = [s["R1CSProof::prove"] for s in ctx["stages"].get("prove", ())
         if "R1CSProof::prove" in s]
    return sum(v) / len(v) if v else None
