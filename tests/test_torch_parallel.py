"""The port's data parallelism (`parallel/`, the trainers' and the
loader's `mesh=`, `train-hardening --data-parallel`) against one process
on the same global batch, and so against the JAX package's mesh, whose
step equals its unsharded step on the global batch
(`tests/test_parallel_utils.py::test_mesh_psum_reduction`); the
one-process port step is held against JAX's unsharded step in
tests/test_torch_hardening.py and tests/test_torch_distill.py.

One spawn of two ranks a module (tests/parallel_ranks.py: gloo through a
file store, a 60 s group timeout, each rank joined with a timeout) runs
every case of tests/parallel_common.py on its rows, while this process
runs them alone; the training halves then run here on the ranks'
texture, so both sides train on one texture. JAX's
`HardeningTrainer(mesh=make_mesh(2))` is not run beside them: jitting its
step takes longer on this CPU than the suite's budget for this file.

Tolerances, and why:

* the global BatchNorm against `nn.BatchNorm2d` / `BatchNorm1d` on the
  global batch: outputs, gradients and running statistics within 1e-6
  relative L2 (float32; measured up to 2.1e-7), the bf16 output and input
  gradient equal up to one bf16 rounding; against flax's `BatchNorm`
  (one-pass variance) within BN_FLAX_RTOL, its running variance times
  n / (n - 1) (ROADMAP Queue 3, "BatchNorm running variance");
* textures bit-equal across the ranks; the L0 iteration counts equal the
  one process's; the first L0 iteration's gradients within 1e-5 of their
  largest magnitude (the sums' order); the L-inf texture on the golden
  model and the L0 loop on the per-pixel predictor within 1e-4 of the
  one process's except at most 0.1% of the texels (tests/test_torch_l0.py's
  rule: Adam's and PGD's sign steps split where a gradient is within
  rounding of 0);
* the training half on one texture, the gradients, parameters and
  running statistics bit-equal across the ranks, Adam's moments the first
  step's on the gradients (MOMENT_RTOL), and: the distillation step's loss within 1e-5 relative, every
  gradient, Adam moment and running statistic within 1e-5 relative L2 per
  tensor (HALF_RTOL; 4.2e-6 measured at worst). The hardening step
  amplifies rounding (the SSIM clip's derivative at flat blocks, train-mode
  BatchNorm over 4 samples, SimSiam's BatchNorm1d, the temporal warps'
  jumps), so there the gradients are held within STEP_L2_ALL relative L2
  over all tensors and STEP_L2 per tensor (a tensor below STEP_FLOOR of
  the largest norm held to that floor; `chip_smoke.py`'s HARDEN_GRAD_L2
  and floor), the running statistics within STEP_STATS, the loss terms
  within 1e-5 relative plus 1e-5 absolute (the contrastive term is a
  difference of near-equal cosines: 2.8e-6 measured). Two ranks read,
  frames 0,s / mono+stereo / DepthHints / the CLI's plain step:
  gradients 2.0e-2 / 7.7e-3 / 7.1e-3 / 8.8e-3 overall, 2.5e-2 / 1.2e-2 /
  3.3e-2 / 2.1e-2 worst tensor, statistics 1.5e-5 / 2.2e-5 / 1.4e-6 /
  1.3e-6 (DepthHints' self-supervised loss, its masked means summed over
  the global batch, bit-equal). The one process against itself
  reads: with 4 torch threads instead of 1, 1.8e-2 / 6.0e-3 overall and
  2.2e-2 / 8.8e-3 worst; with every weight of every module one ulp away
  (phase 11's rule), 3.0e-3 to 4.6e-3 / 3.1e-4 to 7.2e-4 overall, 4.3e-3
  to 8.7e-3 / 1.2e-3 to 3.5e-3 worst, statistics 1.3e-5 / 1.9e-5 to
  2.5e-5 (three seeds). So two ranks lie within the one process's own
  spread over thread counts (about its size; a wider perturbation than
  one ulp of the weights), and differ by rounding only: the ranks' SimSiam in float64
  equals the one process's to 2e-14, a permutation of the batch's rows
  moves the one process by 1.5e-6, and the distillation step (no SSIM,
  no SimSiam) holds to 1e-5.
"""

import datetime
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.distributed as dist

import parallel_common as pc
from depthmodelhardening_tpu_torch.data import kitti_raw
from depthmodelhardening_tpu_torch.data.loader import PrefetchLoader
from depthmodelhardening_tpu_torch.parallel import mesh as pmesh
from depthmodelhardening_tpu_torch.training.distill import DistillTrainer
from depthmodelhardening_tpu_torch.training.config import DistillConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 600  # seconds to join each rank
BN_RTOL = 1e-6
BN_FLAX_RTOL = 1e-5
GRAD_ATOL = 1e-5  # of the largest magnitude
TEX_ATOL, TEX_SPLIT_MAX = 1e-4, 1e-3
HALF_RTOL = 1e-5
MOMENT_RTOL = 1e-6
STEP_L2_ALL, STEP_L2, STEP_FLOOR, STEP_STATS = 5e-2, 0.1, 1e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def lean_process():
    """One torch thread (the suite's workers take the cores) and no
    tensorboardX, as on the card's machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "tensorboardX", None)
    yield
    mp.undo()
    torch.set_num_threads(n)


def _join(proc):
    try:
        out, _ = proc.communicate(timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"a rank hung:\n{out}")
    assert proc.returncode == 0, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the cases alone on the global batch, [rank 0's, rank 1's])."""
    root = tmp_path_factory.mktemp("parallel")
    tree = pc.write_tree(str(root / "tree"))
    tree_json = str(root / "tree.json")
    with open(tree_json, "w") as f:
        json.dump(tree, f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "parallel_ranks.py"),
         str(r), str(pc.WORLD), str(root / "store"), tree_json, str(root)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(pc.WORLD)]
    try:
        solo = {"bn": [pc.bn_case(None, *c) for c in pc.BN_CASES],
                "psum": pc.psum_case(None),
                "l0": pc.refresh_case(None, "l_0"),
                "linf": pc.refresh_case(None, "l_inf"),
                "l0_grads": pc.l0_gradient_case(None),
                "pixel": [pc.pixel_loop_case(None, t)
                          for t in pc.PIXEL_THRESHOLDS],
                "mono": pc.training_half_case(None, None, pc.MONO),
                "hints": pc.training_half_case(None, None, **pc.HINTS),
                "cli": pc.cli_case(tree, str(root / "solo_cli"), False),
                "cli_log": str(root / "solo_cli"),
                "dp_log": str(root / "cli")}
    finally:
        for p in procs:
            _join(p)
    ranks = [torch.load(str(root / f"rank{r}.pt"), weights_only=False)
             for r in range(pc.WORLD)]
    solo["half"] = pc.training_half_case(None, ranks[0]["l0"]["texture"])
    solo["distill"] = pc.distill_half_case(None,
                                           ranks[0]["distill_texture"])
    return solo, ranks


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _cat(ranks, key, i):
    return torch.cat([r["bn"][i][key] for r in ranks])


# -- the global BatchNorm and the gradient mean ------------------------------
def _flax_bn(x, ct, w, b):
    """flax's train-mode BatchNorm (momentum 0.9, eps 1e-5: the port's
    models') on the global batch, channels last: y, the gradients of
    sum(y * ct) and the new running statistics, channels first."""
    perm = (0, 2, 3, 1) if x.dim() == 4 else (0, 1)
    inv = (0, 3, 1, 2) if x.dim() == 4 else (0, 1)
    xj = jnp.asarray(x.float().permute(*perm).numpy())
    cj = jnp.asarray(ct.float().permute(*perm).numpy())
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), xj)
    params = {"scale": jnp.asarray(w.numpy()), "bias": jnp.asarray(b.numpy())}

    def loss(params, xj):
        y, new = bn.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xj,
                          mutable=["batch_stats"])
        return jnp.sum(y * cj), (y, new["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, xj)
    t = lambda a: torch.from_numpy(np.array(a))
    return {"y": t(y).permute(*inv), "dx": t(gx).permute(*inv),
            "dw": t(gp["scale"]), "db": t(gp["bias"]),
            "running_mean": t(stats["mean"]),
            "running_var": t(stats["var"])}


@pytest.mark.parametrize("i", range(len(pc.BN_CASES)),
                         ids=[f"{d}d-{str(t)[6:]}" for d, t, _ in pc.BN_CASES])
def test_global_batchnorm_matches_torch_and_flax(runs, i):
    """Each rank's rows of the global BatchNorm concatenate to the
    single-process BatchNorm's on the global batch; its weight and bias
    gradients sum to it; its running statistics are it (float32 within
    BN_RTOL, bf16 within one bf16 rounding), and flax's (the running
    variance by n / (n - 1))."""
    solo, ranks = runs
    dims, dtype, shape = pc.BN_CASES[i]
    want = solo["bn"][i]
    got = {k: _cat(ranks, k, i) for k in ("y", "dx")}
    got.update({k: ranks[0]["bn"][i][k] + ranks[1]["bn"][i][k]
                for k in ("dw", "db")})
    for k in ("running_mean", "running_var"):
        assert torch.equal(ranks[0]["bn"][i][k], ranks[1]["bn"][i][k])
        got[k] = ranks[0]["bn"][i][k]
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        if dtype == torch.bfloat16 and k in ("y", "dx"):
            ulp = torch.finfo(torch.bfloat16).eps * want[k].float().abs()
            assert bool(((v.float() - want[k].float()).abs() <= ulp).all()), k
        else:
            assert _rel(v, want[k]) <= BN_RTOL, (k, _rel(v, want[k]))
    n = shape[0] * int(np.prod(shape[2:]))
    flax = _flax_bn(*pc.bn_inputs(dims, dtype, shape))
    flax["running_var"] = 0.9 + (flax["running_var"] - 0.9) * n / (n - 1)
    for k, v in flax.items():
        tol = 2 * torch.finfo(dtype).eps if k in ("y", "dx") else 0.0
        assert _rel(got[k].float(), v) <= BN_FLAX_RTOL + tol, (
            k, _rel(got[k].float(), v))


def test_mesh_psum_reduction(runs):
    """JAX `test_mesh_psum_reduction`: the ranks' mean gradient of a mean
    loss over their rows is the single-process gradient, on every rank."""
    solo, ranks = runs
    for r in ranks:
        torch.testing.assert_close(r["psum"], solo["psum"], rtol=1e-6,
                                   atol=0)


# -- the hardening step ------------------------------------------------------
def _texture_split(a, b) -> float:
    return float(((a - b).abs() > TEX_ATOL).float().mean())


def test_texture_refresh_is_the_global_batchs(runs):
    """The L0 and L-inf refresh on the golden model and the L0 loop on
    the per-pixel predictor: one texture on every rank, the one process's
    iteration counts and early breaks, the texture as the one process's
    up to sign splits; the first L0 iteration's gradients are the one
    process's."""
    solo, ranks = runs
    for key in ("l0", "linf"):
        assert torch.equal(ranks[0][key]["texture"], ranks[1][key]["texture"])
        assert all(r[key]["iterations"] == solo[key]["iterations"]
                   for r in ranks)
    assert _texture_split(ranks[0]["linf"]["texture"],
                          solo["linf"]["texture"]) <= TEX_SPLIT_MAX
    for got, other, want in zip(ranks[0]["l0_grads"], ranks[1]["l0_grads"],
                                solo["l0_grads"]):
        assert torch.equal(got, other)
        assert float((got - want).abs().max()) <= GRAD_ATOL * float(
            want.abs().max())
    for (a, b), want in zip(zip(ranks[0]["pixel"], ranks[1]["pixel"]),
                            solo["pixel"]):
        assert torch.equal(a["texture"], b["texture"])
        for r in (a, b):
            assert (r["iterations"], r["early_break"]) == (
                want["iterations"], want["early_break"])
        assert _texture_split(a["texture"], want["texture"]) <= TEX_SPLIT_MAX
    assert [w["early_break"] for w in solo["pixel"]] == [False, True]


def _l2(got, want, floor=0.0):
    """(worst per-tensor relative L2, its name, overall) of the dicts,
    each tensor relative to the larger of its norm and `floor` times the
    largest norm (chip_smoke.py's `_l2_with_floor`)."""
    assert set(got) == set(want)
    big = max(float(w.double().norm()) for w in want.values())
    worst, num, den = (0.0, ""), 0.0, 0.0
    for n, w in want.items():
        err = float((got[n].double() - w.double()).norm())
        ref = float(w.double().norm())
        worst = max(worst, (err / max(ref, floor * big, 1e-30), n))
        num, den = num + err ** 2, den + ref ** 2
    return worst[0], worst[1], (num / den) ** 0.5


def _assert_half(ranks, want, exact=True):
    """The ranks' training-half outcomes against the one process's
    `want`: HALF_RTOL throughout when `exact`, else phase 11's rule (the
    module docstring). Adam's moments are the first step's on each side's
    gradients (within MOMENT_RTOL), so holding the gradients holds them;
    the ranks' gradients, parameters and statistics are bit-equal."""
    got = ranks[0]
    for k, v in want["metrics"].items():
        tol = HALF_RTOL * (abs(v) if exact else abs(v) + 1.0)
        for r in ranks:
            assert abs(r["metrics"][k] - v) <= tol, (k, r["metrics"][k], v)
    worst, name, overall = _l2(got["grads"], want["grads"],
                               0.0 if exact else STEP_FLOOR)
    if exact:
        assert worst <= HALF_RTOL, (name, worst)
    else:
        assert worst <= STEP_L2 and overall <= STEP_L2_ALL, (
            name, worst, overall)
    worst, name, _ = _l2(got["stats"], want["stats"], STEP_FLOOR)
    assert worst <= (HALF_RTOL if exact else STEP_STATS), (name, worst)
    assert max(r["moments"] for r in ranks + [want]) <= MOMENT_RTOL
    for k in ("grad_digests", "params"):
        assert ranks[1][k] == got[k], k
    for n, v in got["stats"].items():
        assert torch.equal(ranks[1]["stats"][n], v), n


@pytest.mark.parametrize("case", ["half", "mono", "hints", "distill"])
def test_training_half_is_the_global_batchs(runs, case):
    """The hardening step's training half (frames 0,s: supervised +
    contrastive + photometric), the mono+stereo one (the pose networks'
    and SimSiam's BatchNorms too), DepthHints' (its masked means over the
    global batch) and the distillation step's, on one texture: on both
    ranks the one process's loss, gradients, Adam moments and running
    statistics, and the same parameters."""
    solo, ranks = runs
    _assert_half([r[case] for r in ranks], solo[case],
                 exact=case == "distill")
    if case == "mono":
        assert {n.split(".")[0] for n in solo[case]["stats"]} == {
            "model", "simsiam", "pose_encoder"}


# -- the command line --------------------------------------------------------
def _jsonl(log_dir):
    with open(os.path.join(log_dir, "train_metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_cli_data_parallel_trains_the_global_batch(runs):
    """train-hardening --data-parallel on two ranks: the plain step is the
    one-process CLI's (phase 11's rule, the module docstring); rank 0 alone writes opt.json, the
    checkpoints and the log; the resumed run restores rank 0's checkpoint
    on both ranks, takes an L0 step with a robustness val, and leaves the
    same parameters on both."""
    solo, ranks = runs
    dp = [r["cli"] for r in ranks]
    _assert_half([r["runs"][0]["outcome"] for r in dp],
                 solo["cli"]["runs"][0]["outcome"], exact=False)
    want = [row for row in _jsonl(solo["cli_log"]) if "loss" in row]
    got = [row for row in _jsonl(solo["dp_log"]) if "loss" in row]
    assert abs(got[0]["loss"] - want[0]["loss"]) <= HALF_RTOL * abs(
        want[0]["loss"])
    assert [row["step"] for row in got] == [0, 1]
    assert any("val/mean_abs_err" in row for row in _jsonl(solo["dp_log"]))
    for run in (0, 1):
        assert sorted(dp[0]["runs"][run]["calls"]) == [
            "MetricsLogger", "save_options", "save_state"]
        assert dp[1]["runs"][run]["calls"] == []
        assert dp[1]["runs"][run]["stdout"] == ""
    assert "resumed from step 1" in dp[0]["runs"][1]["stdout"]
    assert sorted(os.listdir(os.path.join(solo["dp_log"], "ckpts"))) == [
        "1", "2"]
    saved = dp[0]["runs"][0]["outcome"]["params"]
    for r in dp:
        assert r["restored"] == [saved]
    assert dp[1]["runs"][1]["outcome"]["params"] == dp[0]["runs"][1][
        "outcome"]["params"]


# -- the refusals --------------------------------------------------------------
def test_world_sizes_that_split_no_batch_and_failing_launches_raise(
        tmp_path, monkeypatch):
    """A world size that does not divide the global batch, the attack
    batch or the loader's batch raises, naming both numbers; a
    coordinator named by explicit arguments or by torchrun's variables
    that fails raises, and leaves no group behind."""
    three = pmesh.Mesh(0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="batch_size 4 .* world size 3"):
        pc.harden_trainer(three, pc.harden_cfg())
    with pytest.raises(ValueError,
                       match="attack_batch_size 2 .* world size 4"):
        pc.harden_trainer(pmesh.Mesh(0, 4, torch.device("cpu")),
                          pc.harden_cfg())
    obj, mask = pc.car()
    with pytest.raises(ValueError, match="batch_size 4 .* world size 3"):
        DistillTrainer(DistillConfig(batch_size=4), torch.Generator(), obj,
                       mask, None, device="cpu", mesh=three)
    with pytest.raises(ValueError, match="batch_size 4 .* world size 3"):
        PrefetchLoader([], 4, kitti_raw.collate, mesh=three, device="cpu")
    with pytest.raises(ValueError, match="not the mesh's"):
        PrefetchLoader([], 6, kitti_raw.collate, mesh=three, device="meta")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        pmesh.initialize_distributed(
            f"file://{tmp_path}/store", world_size=2, rank=5,
            timeout=datetime.timedelta(seconds=5))
    assert not dist.is_initialized()
    # no coordinator in the environment: False, not an error
    assert not any(v in os.environ for v in pmesh.ENV_VARS)
    assert pmesh.initialize_distributed() is False
    # torchrun's variables naming a coordinator that cannot start (its
    # port is taken): make_mesh raises, and starts no world of one
    with socket.socket() as busy:
        busy.bind(("localhost", 0))
        busy.listen(1)
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", str(busy.getsockname()[1]))
        with pytest.raises(RuntimeError, match="EADDRINUSE|in use"):
            pmesh.make_mesh(device="cpu")
    assert not dist.is_initialized()
