"""stage.verify_eval_s: the port's Timer total of verify_eval_proof,
averaged over the window's verifies."""


def read(ctx):
    v = [s["verify_eval_proof"] for s in ctx["stages"].get("verify", ())
         if "verify_eval_proof" in s]
    return sum(v) / len(v) if v else None
