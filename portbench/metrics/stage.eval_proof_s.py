"""stage.eval_proof_s: the port's Timer total of R1CSEvalProof::prove
(every SPARK eval proof of a prove, summed), averaged over the window's
proves."""


def read(ctx):
    v = [s["R1CSEvalProof::prove"] for s in ctx["stages"].get("prove", ())
         if "R1CSEvalProof::prove" in s]
    return sum(v) / len(v) if v else None
