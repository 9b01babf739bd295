"""The multi-device slice on the CPU: ranks of a torch.distributed gloo
group (spartan_parallel_tpu_torch._dryrun_stages.launch, each rank a
spawned process running tests/torch_shared.py rank_jobs) against the JAX
package's parallel/ on its 8 virtual CPU devices and against the port's
single-rank proofs, which tests/test_torch_nizk.py and
test_torch_r1csproof.py hold against the JAX bytes. Tolerance: exact
everywhere (limbs, compressed points, proof bytes).

The JAX side runs once per test run in one fresh process (torch_shared.py);
each launch has a timeout, so a rank that hangs fails its test. Every
sharded proof also reports how many rounds each of its sumchecks ran on
split tables, so a split that silently fell back to whole tables fails."""

import time

import numpy as np
import pytest
import torch

from spartan_parallel_tpu_torch import _dryrun_stages as ds
from spartan_parallel_tpu_torch.core.consts import L
from spartan_parallel_tpu_torch.core.edwards import (
    RistrettoPoint,
    _elligator_map,
)
from spartan_parallel_tpu_torch.ops import curve
from spartan_parallel_tpu_torch.ops import limbs as lb
from spartan_parallel_tpu_torch.ops import msm
from spartan_parallel_tpu_torch.ops import sumcheck as sck
from spartan_parallel_tpu_torch.parallel.mesh import dryrun_tables

from .test_torch_nizk import jax_verify
from .torch_shared import in_fresh_process, shared_result

SEED = b"\x05" * 32  # the fixed tape of tests/test_torch_nizk.py
NIZK_ARGS = (16, 4, 0, SEED, b"nizk_example")  # n, inputs, seed, tape, label
DP_ARGS = ((4, 2, 1), 32, 4, 3, SEED, b"dryrun_dp")
LAUNCH_S = 300
JAX_S = 600
SCALES = [0, 1, L - 1, L + 5, int.from_bytes(
    np.random.default_rng(31).bytes(40), "little")]
POINT_SUMS = [(3, 4), (4, 2)]


def round_tables() -> dict:
    """tests/test_sharding.py's seed-21 tables (its draws, in its order)."""
    return {k: v.numpy() for k, v in dryrun_tables(2, 16, 8, 21).items()}


def msm_inputs():
    """tests/test_msm_sharded.py's seed-23 points and scalars."""
    rng = np.random.default_rng(23)
    n = 64
    pts = [_elligator_map(int.from_bytes(rng.bytes(32), "little"))
           for _ in range(8)]
    pts = (pts * (n // 8))[:n]
    ks = [int.from_bytes(rng.bytes(40), "little") % L for _ in range(2 * n)]
    return curve.encode_points(pts), lb.ints_to_limbs(ks).reshape(2, n, 16)


def points(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return curve.encode_points([RistrettoPoint.basepoint() * int(
        rng.integers(1, 1 << 62)) for _ in range(n)])


def jax_refs(tables, sums, scale_pts):
    """In one fresh process, the JAX package's: sharded_p1_round under
    make_mesh(8) on `tables` (as test_sharding.py), dryrun_step's
    evaluations, tree_reduce of each (D, B) point array of `sums`, and
    scale_points of `scale_pts` by each of SCALES (points as ristretto
    encodings)."""
    import jax
    import jax.numpy as jnp

    from spartan_parallel_tpu.ops import curve as jcurve
    from spartan_parallel_tpu.ops import sumcheck as jsck
    from spartan_parallel_tpu.parallel.mesh import (
        dryrun_step,
        make_mesh,
        replicate,
        shard_q,
        sharded_p1_round,
    )

    mesh = make_mesh(8)
    t = {k: jnp.asarray(v.astype(np.uint32)) for k, v in tables.items()}
    args = (replicate(mesh, t["tp"]), shard_q(mesh, t["tq"], 0),
            replicate(mesh, t["tx"]), shard_q(mesh, t["B"]),
            shard_q(mesh, t["C"]), shard_q(mesh, t["D"]),
            replicate(mesh, t["r"]))
    ev, bound = sharded_p1_round(*args, np.uint32(4), jsck.MODE_X)

    def enc(pts):
        return [p.compress() for p in jcurve.decode_points(np.asarray(pts))]

    tree = jax.jit(lambda x: jcurve.tree_reduce(x, axis=0))
    sp = jnp.asarray(scale_pts.astype(np.uint32))
    return {"round": (np.asarray(ev), [np.asarray(b) for b in bound]),
            "dryrun": np.asarray(dryrun_step(mesh)[0]),
            "sums": [enc(tree(jnp.asarray(s.astype(np.uint32))))
                     for s in sums],
            "scale": [enc(jcurve.scale_points(sp, k)) for k in SCALES]}


def sum_inputs():
    return [points(d * b, 40 + d).reshape(d, b, 4, 16)
            for d, b in POINT_SUMS]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return shared_result(tmp_path_factory, "jax_parallel", lambda:
                         in_fresh_process(jax_refs, round_tables(),
                                          sum_inputs(), points(8, 50),
                                          timeout=JAX_S))


def _launch(tmp_path_factory, name, world, jobs, shape=None):
    from .torch_shared import rank_jobs

    def run():
        reps = ds.launch(rank_jobs, world, args=(jobs,), device="cpu",
                         shape=shape, timeout=LAUNCH_S)
        return [r["result"] for r in reps]

    return shared_result(tmp_path_factory, name, run)


@pytest.fixture(scope="module")
def d2(tmp_path_factory):
    """Two ranks: the seed-21 round q-sharded, dryrun_step, the sharded
    MSM, the NIZK, the DP R1CSProof, and the NIZK with device rounds."""
    return _launch(tmp_path_factory, "port_mesh_d2", 2, [
        ("sharded_round", (round_tables(), 4, sck.MODE_X)),
        ("stage_1_sharded_round", (2, 8, 8)),
        ("sharded_round", (round_tables(), 8, sck.MODE_Q)),
        ("msm_sharded", msm_inputs()),
        ("stage_2_nizk", NIZK_ARGS),
        ("stage_4_dp_r1cs", DP_ARGS),
        ("device_rounds", ("stage_2_nizk", NIZK_ARGS))])


@pytest.fixture(scope="module")
def single():
    """The port's single-rank proofs of the same statements and tapes."""
    return {"nizk": ds.stage_2_nizk(None, "cpu", *NIZK_ARGS)["bytes"],
            "dp": ds.stage_4_dp_r1cs(None, "cpu", *DP_ARGS)["bytes"]}


def split_rounds(x_len: int, y_len: int, world: int) -> list:
    """The rounds each sumcheck of a NIZK or R1CSProof runs on split
    tables: phase 1 over x_len constraints, phase 2 over y_len witness
    entries, each split world ways, one cross-rank sum a round while the
    round's half length is at least world."""
    return [x_len.bit_length() - world.bit_length(),
            y_len.bit_length() - world.bit_length()]


def unshard(parts, axis):
    """Rank k's entries back at k, k + D, ... along `axis`."""
    return np.stack(parts, axis=axis + 1).reshape(
        parts[0].shape[:axis] + (-1,) + parts[0].shape[axis + 1:])


def test_sharded_round_matches_jax(jax_ref, d2):
    """sharded_p1_round on two ranks (q split) equals the JAX package's
    under make_mesh(8): evaluations and every bound table, bit for bit."""
    ev, bound = jax_ref["round"]
    for rank in d2:
        assert np.array_equal(rank[0]["evals"], ev)
    got = [b for b in d2[0][0]["bound"]]
    got[1] = unshard([r[0]["bound"][1] for r in d2], 0)
    for k in range(3, 6):
        got[k] = unshard([r[0]["bound"][k] for r in d2], 1)
    for k in (0, 2):
        assert np.array_equal(d2[1][0]["bound"][k], got[k])
    for a, b in zip(got, bound):
        assert np.array_equal(a, b)


def test_dryrun_step_matches_jax(jax_ref, d2):
    for rank in d2:
        assert np.array_equal(rank[1]["evals"], jax_ref["dryrun"])


def test_sharded_q_round_matches_single_rank(d2):
    """A q round of the seed-21 tables on two ranks: each rank folds its
    own half of q (n_half 8 over 2 ranks), and the evaluations and bound
    tables equal the single-rank round's."""
    want = ds.sharded_round(None, "cpu", round_tables(), 8, sck.MODE_Q)
    for rank in d2:
        assert np.array_equal(rank[2]["evals"], want["evals"])
    got = [b for b in d2[0][2]["bound"]]
    got[1] = unshard([r[2]["bound"][1] for r in d2], 0)
    for k in range(3, 6):
        got[k] = unshard([r[2]["bound"][k] for r in d2], 1)
    for a, b in zip(got, want["bound"]):
        assert np.array_equal(a, b)


def test_msm_sharded_matches_single_rank(d2):
    """The sharded MSM at test_msm_sharded.py's inputs on two ranks equals
    the port's single-rank msm (held against the JAX package's msm by
    tests/test_torch_msm.py) and the JAX package's host multiscalar_mul."""
    from spartan_parallel_tpu.core import edwards as jed

    pts, limbs = msm_inputs()
    want = [p.compress() for p in msm.msm(torch.from_numpy(pts),
                                          torch.from_numpy(limbs))]
    jpts = [jed.RistrettoPoint.decompress(p.compress())
            for p in curve.decode_points(torch.from_numpy(pts))]
    ks = lb.limbs_to_ints(limbs)
    n = len(jpts)
    assert want == [jed.multiscalar_mul(ks[i:i + n], jpts).compress()
                    for i in range(0, len(ks), n)]
    for rank in d2:
        assert rank[3] == want


@pytest.mark.parametrize("case", range(len(POINT_SUMS)))
def test_point_sum_plain_matches_jax(jax_ref, case):
    """K12's plain version (tree_sum's halving tree) against JAX
    tree_reduce, an odd and an even number of partials."""
    got = curve.point_sum(torch.from_numpy(sum_inputs()[case]))
    assert [p.compress() for p in curve.decode_points(got)] == \
        jax_ref["sums"][case]


@pytest.mark.parametrize("case", range(len(SCALES)))
def test_scale_points_plain_matches_jax(jax_ref, case):
    """K13's plain version against JAX scale_points on 8 points: k = 0,
    1, l - 1, l + 5 (taken mod l) and a random 320-bit k."""
    got = curve.scale_points(torch.from_numpy(points(8, 50)), SCALES[case])
    assert [p.compress() for p in curve.decode_points(got)] == \
        jax_ref["scale"][case]


def test_sharded_nizk_matches_single_rank(d2, single):
    """The 16 x 16 x 4 NIZK on two ranks: every rank's proof is the
    single-rank proof, byte for byte, and the JAX verifier accepts it."""
    for rank in d2:
        assert rank[4]["bytes"] == single["nizk"]
        assert rank[4]["split_rounds"] == split_rounds(16, 16, 2)
    assert in_fresh_process(jax_verify, d2[0][4]["bytes"], timeout=600)


def test_two_axis_mesh_nizk_matches_single_rank(tmp_path_factory, single):
    """The same NIZK on a 2 x 2 (host, chip) mesh of four ranks."""
    ranks = _launch(tmp_path_factory, "port_mesh_2x2", 4,
                    [("stage_2_nizk", NIZK_ARGS)], shape=(2, 2))
    for rank in ranks:
        assert rank[0]["bytes"] == single["nizk"]
        assert rank[0]["split_rounds"] == split_rounds(16, 16, 4)


def test_sharded_dp_matches_single_rank(d2, single):
    """The DP R1CSProof at the 4_dp_r1cs stage's shape (32 constraints,
    executed [4, 2, 1] times: the classed prover) on two ranks."""
    for rank in d2:
        assert rank[5]["bytes"] == single["dp"]
        assert rank[5]["split_rounds"] == split_rounds(32, 32, 2)


def test_sharded_device_rounds_match_single_rank(d2, single):
    """The NIZK on two ranks with every round device-resident (K11's
    plain version reads the ranks' summed evaluations)."""
    for rank in d2:
        assert rank[6]["bytes"] == single["nizk"]
        assert rank[6]["split_rounds"] == split_rounds(16, 16, 2)


def test_failing_rank_fails_the_launch():
    """A rank that raises ends the launch with its error well within the
    timeout, while the other rank waits in a collective."""
    from .torch_shared import rank_jobs

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        ds.launch(rank_jobs, 2, args=([("fail", (1,))],), device="cpu",
                  timeout=120)
    assert time.perf_counter() - t0 < 60


def test_launch_on_the_card_needs_a_card():
    """The launcher's default device is the card: with none present and
    the CPU not named, it raises before it starts a rank."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.launch(ds.stage_1_sharded_round, 2, timeout=30)
