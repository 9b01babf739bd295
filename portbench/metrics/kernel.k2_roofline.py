"""kernel.k2_roofline: per cent of K2's least time in the device time of
its launches, over the window's proves. K2 is reached through ops/msm.py
`msm_dev`; its least work (portbench/work.py msm_work) is the least
signed-digit Pippenger work over every window width for each row's
nonzero scalars and bit length, or the bytes, whichever takes longer."""

from portbench import tracedata, work


def shape(points, scalars) -> dict:
    """The points shared by the rows, and each row's nonzero scalars and
    largest bit length (scalars: (B, N, 16) or (N, 16) 16-bit limbs)."""
    import torch

    sc = scalars if scalars.dim() == 3 else scalars[None]
    nz = (sc != 0).any(-1)
    # the highest nonzero 16-bit limb of each row, and the largest value in
    # it: the row's bit length
    any_l = (nz[..., None] & (sc != 0)).any(1)  # (B, 16)
    ar = torch.arange(16, device=sc.device)
    top = torch.where(any_l, ar, torch.full_like(ar, -1)).amax(-1)
    topc = top.clamp(min=0)
    vals = sc.gather(2, topc.view(-1, 1, 1).expand(
        sc.shape[0], sc.shape[1], 1))[..., 0].amax(1)
    bits = torch.where(
        top >= 0, 16 * topc + torch.floor(torch.log2(
            vals.clamp(min=1).double())).long() + 1, torch.zeros_like(topc))
    return {"n": int(sc.shape[1]), "nonzero": nz.sum(1), "bits": bits,
            "_cuda": sc.device.type == "cuda"}


WRAPS = {"spartan_parallel_tpu_torch.ops.msm:msm_dev": shape}


def least(call) -> tuple:
    rows = list(zip(call["nonzero"].tolist(), call["bits"].tolist()))
    return work.msm_work(call["n"], rows)


def read(ctx):
    return tracedata.roofline(tracedata.counted_calls(ctx, __file__, "prove"),
                              least, ctx["int32_rate"])
