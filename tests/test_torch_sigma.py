"""The bullet verifier's G_hat on K2 (models/sigma.py
BulletReductionProof.verify): the JAX package's DotProductProofLog proofs
at n = 64 and 128, made in one fresh process by its host bullet prover
(no MSM is compiled), verified by the port. With the port's threshold
lowered to 0 the device branch runs K2's plain version on CPU tensors; its
G_hat must equal the port's host branch and the JAX verifier's host G_hat
as compressed bytes, and it must reject a tampered proof. The port's
verifies run once per test run (shared by the workers). Tolerance:
exact."""

import pytest
import torch

from spartan_parallel_tpu_torch.core.consts import L
from spartan_parallel_tpu_torch.core.edwards import RistrettoPoint
from spartan_parallel_tpu_torch.core.field import Scalar
from spartan_parallel_tpu_torch.models import sigma
from spartan_parallel_tpu_torch.ops import msm
from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
from spartan_parallel_tpu_torch.utils.transcript import Transcript

from .torch_shared import case_rng, in_fresh_process, shared_result

SIZES = (64, 128)
LABEL = b"test_sigma_gens"
JAX_S = 600


def inputs(n: int):
    """x, blind_x, a, y = <x, a>, blind_y of the size-n case."""
    rng = case_rng("sigma", n)

    def draw():
        return int.from_bytes(rng.bytes(40), "little") % L

    x = [draw() for _ in range(n)]
    a = [draw() for _ in range(n)]
    y = sum(u * v for u, v in zip(x, a)) % L
    return x, draw(), a, y, draw()


def jax_proofs(sizes):
    """The JAX package's proof of each size (host bullet prover, fixed
    tape), its fields as bytes and ints, and the G_hat its verifier
    computed (host multiscalar_mul), compressed."""
    from spartan_parallel_tpu.core.field import Scalar as JS
    from spartan_parallel_tpu.models import sigma as jsig
    from spartan_parallel_tpu.utils.random_tape import RandomTape
    from spartan_parallel_tpu.utils.transcript import Transcript as JT

    seen = []
    verify = jsig.BulletReductionProof.verify

    def spy(self, *args):
        out = verify(self, *args)
        seen.append(out[0].compress())
        return out

    jsig.BulletReductionProof.verify = spy
    out = {}
    for n in sizes:
        x, bx, a, y, by = inputs(n)
        gens = jsig.DotProductProofGens(n, LABEL)
        a_s = [JS(v) for v in a]
        proof, Cx, Cy = jsig.DotProductProofLog.prove(
            gens, JT(b"sigma"), RandomTape(b"proof", seed=b"\x09" * 32),
            [JS(v) for v in x], JS(bx), a_s, JS(y), JS(by))
        proof.verify(n, gens, JT(b"sigma"), a_s, Cx, Cy)
        brp = proof.bullet_reduction_proof
        out[n] = {"L": list(brp.L_vec), "R": list(brp.R_vec),
                  "delta": proof.delta, "beta": proof.beta,
                  "z1": int(proof.z1), "z2": int(proof.z2), "Cx": Cx,
                  "Cy": Cy, "g_hat": seen[-1]}
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return shared_result(tmp_path_factory, "jax_sigma", lambda:
                         in_fresh_process(jax_proofs, SIZES, timeout=JAX_S))


def port_proof(ref, L_vec=None):
    brp = sigma.BulletReductionProof(L_vec or list(ref["L"]), list(ref["R"]))
    return sigma.DotProductProofLog(brp, ref["delta"], ref["beta"],
                                    Scalar(ref["z1"]), Scalar(ref["z2"]))


def verify(proof, n, gens, ref, device):
    """Run the port's verifier; the G_hat its bullet reduction computed
    (compressed) and the devices of its K2 calls (msm_single)."""
    seen, calls = [], []
    brp_verify = sigma.BulletReductionProof.verify
    single = msm.msm_single

    def spy(self, *args, **kw):
        out = brp_verify(self, *args, **kw)
        seen.append(out[0].compress())
        return out

    def counted(*args):
        calls.append(str(args[0].device))
        return single(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sigma.BulletReductionProof, "verify", spy)
        mp.setattr(msm, "msm_single", counted)
        a = [Scalar(v) for v in inputs(n)[2]]
        proof.verify(n, gens, Transcript(b"sigma"), a, ref["Cx"],
                     ref["Cy"], device)
    return seen[-1], calls


def port_runs(refs):
    """The port's verifier on each JAX proof: the host branch's G_hat,
    then, with the threshold at 0, the device branch's (K2's plain version
    on CPU tensors, which takes seconds) and its K2 calls; and whether the
    device branch rejects the n = 64 proof with its first L point
    replaced. A verify that rejects raises, so each result here comes
    from an accepting verify."""
    out = {}
    for n in SIZES:
        gens = sigma.DotProductProofGens(n, LABEL)
        out[n] = {"host": verify(port_proof(refs[n]), n, gens, refs[n],
                                 None)}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sigma, "host_msm_max", lambda device: 0)
            out[n]["device"] = verify(port_proof(refs[n]), n, gens, refs[n],
                                      "cpu")
            if n == SIZES[0]:
                ref = refs[n]
                bad = [RistrettoPoint.basepoint().compress()] + ref["L"][1:]
                assert bad[0] != ref["L"][0]
                try:
                    verify(port_proof(ref, bad), n, gens, ref, "cpu")
                    out["tampered_rejected"] = False
                except ProofVerifyError:
                    out["tampered_rejected"] = True
    return out


def port_runs_one_thread(refs):
    """port_runs on one torch thread: K2's plain version is thousands of
    small tensor operations, which threads only slow beside busy
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return port_runs(refs)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port(tmp_path_factory, jax_ref):
    return shared_result(tmp_path_factory, "port_sigma",
                         lambda: port_runs_one_thread(jax_ref))


@pytest.mark.parametrize("n", SIZES)
def test_device_g_hat_matches_host_and_jax(jax_ref, port, n):
    """With the threshold at 0, the CPU tensors' device branch gives the
    host branch's and JAX's G_hat, through one K2 call, while accepting
    the JAX proof; the host branch makes no K2 call."""
    host, host_calls = port[n]["host"]
    dev, dev_calls = port[n]["device"]
    assert host_calls == [] and dev_calls == ["cpu"]
    assert dev == host == jax_ref[n]["g_hat"]


def test_device_branch_rejects_tampered_proof(port):
    assert port["tampered_rejected"] is True


def test_threshold_keeps_host_branch(jax_ref):
    """At the threshold as it is, the CPU takes the host branch at every
    size; the card's threshold is the JAX package's accelerator one."""
    for n in SIZES:
        gens = sigma.DotProductProofGens(n, LABEL)
        _, calls = verify(port_proof(jax_ref[n]), n, gens, jax_ref[n],
                          "cpu")
        assert calls == []
    assert sigma.host_msm_max(torch.device("cuda")) == 8192
