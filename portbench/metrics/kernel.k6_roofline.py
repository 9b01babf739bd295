"""kernel.k6_roofline: per cent of K6's least time in the device time of
its launches, over the window's proves. K6 is reached through ops/product.py
`pt_tree`, `pt_round` and `pt_fold`; their least work is
portbench/work.py tree_work, round_work and fold_work."""

from portbench import tracedata, work


def _round(A, B, C, coef, r=None, seq=None):
    return {"op": "round", "rows": int(A.shape[0]), "n": int(A.shape[1]),
            "seq": int(seq[0].shape[0]) if seq is not None else 0,
            "bind": r is not None, "_cuda": A.device.type == "cuda"}


def _fold(A, B, C, r, seq=None):
    return {"op": "fold", "rows": int(A.shape[0]),
            "seq": int(seq[0].shape[0]) if seq is not None else 0,
            "_cuda": A.device.type == "cuda"}


def _tree(leaves):
    return {"op": "tree", "trees": int(leaves.shape[0]),
            "leaves": int(leaves.shape[1]),
            "_cuda": leaves.device.type == "cuda"}


WRAPS = {"spartan_parallel_tpu_torch.ops.product:pt_round": _round,
         "spartan_parallel_tpu_torch.ops.product:pt_fold": _fold,
         "spartan_parallel_tpu_torch.ops.product:pt_tree": _tree}


def least(call) -> tuple:
    if call["op"] == "tree":
        return work.tree_work(call["trees"], call["leaves"])
    if call["op"] == "round":
        return work.round_work(call["rows"], call["n"], call["seq"],
                               call["bind"])
    return work.fold_work(call["rows"], call["seq"])


def read(ctx):
    return tracedata.roofline(tracedata.counted_calls(ctx, __file__, "prove"),
                              least, ctx["int32_rate"])
