"""Data parallelism of the PyTorch port against the JAX package, on the CPU:
4 ranks over gloo, one process each, spawned once for the module and
reused by every test that needs a group.

* one global-mode DLA-34 step (head_conv 16, 64x128, global batch 4, one
  sample a rank) against the JAX package's unsharded train step on the
  same global batch, which is what its mesh step computes
  (tests/test_train.py:77-98), both in f64 (the ranks' nets and batches,
  and JAX's model under jax.enable_x64): loss rtol 1e-4; every gradient, in
  relative L2, within 4x the port's own sensitivity floor (+1e-3) of
  JAX's (read from Adam's first moment), `test_torch_train.
  _check_train_step`'s bound; the BatchNorm statistics within rtol 1e-4,
  atol 1e-5; the gradients, the stats and the statistics equal on every
  rank; and, as a sanity check beside them, the parameters after Adam
  within 2 lr + 1e-6 (Adam's first step moves a weight by ~lr sign(g)
  whatever the gradient, so this bound alone checks no gradient);
* the same step against the port's own one-process batch-4 step in f64,
  with the same bounds;
* `grad_bucket=True` on a batch that tiles one sample over the ranks,
  where per-rank statistics are the global ones, against the same JAX
  step on that batch: loss and parameters, as the JAX package's bucket
  test (tests/test_train.py:100-127), and the gradients against the
  port's one-process step of that sample;
* `grad_bucket=True` on the global batch, one sample a rank: the
  gradients, stats and BatchNorm statistics are the means of the port's
  one-process steps of each sample;
* each polydet loss over the 4 ranks: the shares sum to the global
  batch's loss, and their gradients are its gradient;
* `main` over the 4 ranks on a PNG fixture: one process writes the
  checkpoints and the log, validation scores the whole val split once,
  `--resume` loads on every rank;
* the loader's shards index for index against the JAX package's Loader;
* the config flags, `initialize_distributed`, `make_mesh`,
  `shard_batch` and `serving_devices`;
* `run_batch` over ["cpu", "cpu"] with 3 frames (one padded) against
  one-device `run_batch` and the JAX package's.

The DLA-34 weights are the JAX package's random variables carried across
by `weights.state_dict_from_jax`, with the DCN offset convs at zero (the
DCNv2 init, as the trainer starts): at offset gain 1 the random net
moves its loss by ~5e-4 under a 1e-6 weight change (test_torch_train.py),
above the loss bound.  The ranks import this module, so JAX is imported
inside the parent's tests only.
"""
import hashlib
import json
import multiprocessing
import os
import queue
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from centerpoly_tpu_torch import main as tmain
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (CityscapesMeta, CocoPolyAnnotations,
                                       Loader, PolydetSampler)
from centerpoly_tpu_torch.data.fixture import write_rect_fixture
from centerpoly_tpu_torch.infer.detector import create_detector
from centerpoly_tpu_torch.losses import PolydetLossConfig, polydet_loss
from centerpoly_tpu_torch.models import create_model
from centerpoly_tpu_torch.train import mesh, state as tstate
from centerpoly_tpu_torch.train.step import make_train_step, to_device
from centerpoly_tpu_torch.weights import load_weights

WORLD = 4
# a rank that has not answered by then has died or hangs in a collective
TIMEOUT = 120
H, W, HEAD_CONV, LR = 64, 128, 16, 2e-4
HEADS = {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}
LOSS = dict(rep="polar", poly_loss="l1+iou", poly_order=True)
BN_STATS = ("running_mean", "running_var")


# -- the ranks ---------------------------------------------------------------

def _rank_loop(rank, port, inbox, outbox):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=TIMEOUT))
    try:
        for fn, args in iter(inbox.get, None):
            try:
                outbox.put((rank, True, fn(rank, *args)))
            except Exception:  # noqa: BLE001 - reported to the parent
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Ranks:
    """WORLD processes in one gloo group, each running the functions it is
    sent as fn(rank, *args)."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        port = mesh.free_port()
        self.inboxes = [ctx.Queue() for _ in range(WORLD)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_loop,
                                  args=(r, port, self.inboxes[r], self.outbox))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> list:
        """fn's result on every rank, in rank order; a rank's exception
        fails the test with its traceback, a silent rank after TIMEOUT."""
        for q in self.inboxes:
            q.put((fn, args))
        out = [None] * WORLD
        for _ in range(WORLD):
            try:
                rank, ok, res = self.outbox.get(timeout=TIMEOUT)
            except queue.Empty:
                pytest.fail(f"a rank gave no answer in {TIMEOUT} s")
            assert ok, f"rank {rank} failed:\n{res}"
            out[rank] = res
        return out

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=TIMEOUT)
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(timeout=10)
        assert not alive, "a rank did not leave its group"


@pytest.fixture(scope="module")
def ranks():
    r = Ranks()
    yield r
    r.close()


def _port_net(sd, double=False):
    net = create_model("dla_34", HEADS, HEAD_CONV)
    load_weights(net, sd, strict=True)
    return net.double() if double else net


def _port_batch(host, double=False):
    """A host batch as the port's step takes it; in f64 with `double`
    (to_device casts to f32, and the sampler's batches are f32, so the
    values are the same)."""
    batch = to_device(host, "cpu")
    return {k: v.double() if double and v.is_floating_point() else v
            for k, v in batch.items()}


def _grads(model) -> dict:
    return {n: p.grad.detach().numpy().copy()
            for n, p in model.named_parameters() if p.grad is not None}


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for n in sorted(arrays):
        h.update(n.encode())
        h.update(np.ascontiguousarray(arrays[n]).tobytes())
    return h.hexdigest()


def _step_on_rank(rank, sd, host, grad_bucket, double=False):
    """One data-parallel step of this rank's share of `host` (in f64 with
    `double`): the loss stats, the BatchNorm statistics, a digest of the
    gradients the step applied, and on rank 0 every parameter after the
    step and every gradient."""
    st = tstate.create_train_state(_port_net(sd, double), base_lr=LR)
    step = make_train_step(PolydetLossConfig(**LOSS), group=dist.group.WORLD,
                           grad_bucket=grad_bucket)
    st, stats = step(st, _port_batch(mesh.shard_batch(host, rank, WORLD),
                                     double))
    grads = _grads(st.model)
    params = ({n: p.detach().numpy() for n, p in st.model.named_parameters()}
              if rank == 0 else None)
    bufs = {n: b.numpy() for n, b in st.model.named_buffers()
            if n.endswith(BN_STATS)}
    return ({k: float(v) for k, v in stats.items()}, bufs, _digest(grads),
            (params, grads) if rank == 0 else None)


def _loss_on_rank(rank, maps, gt, cfg_kw):
    """This rank's share of the polydet loss of its slice of a global
    batch, and its gradient with respect to the slice's head maps."""
    maps = {k: torch.tensor(v, requires_grad=True)
            for k, v in mesh.shard_batch(maps, rank, WORLD).items()}
    gt = {k: torch.tensor(v) for k, v in
          mesh.shard_batch(gt, rank, WORLD).items()}
    loss, stats = polydet_loss([maps], gt, PolydetLossConfig(**cfg_kw),
                               group=dist.group.WORLD)
    grads = torch.autograd.grad(loss, list(maps.values()))
    return ({k: v.item() for k, v in stats.items()},
            {k: g.numpy() for k, g in zip(maps, grads)})


def _main_on_rank(rank, argv, size):
    CityscapesMeta.eval_image_size = size
    tr = tmain.main(argv)
    return tr.state.step, tr.start_epoch, tr.best


# -- the JAX reference -------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_batches(tmp_path_factory):
    """The global batch of 4 from the port's sampler on a 128x256 rectangle
    fixture, and a batch that tiles its first sample 4 times."""
    root = write_rect_fixture(str(tmp_path_factory.mktemp("fx")), 4, 0,
                              2 * H, 2 * W)
    cfg = Config(input_h=H, input_w=W, head_conv=HEAD_CONV, **LOSS)
    meta = CityscapesMeta(root)
    sampler = PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    batch = next(iter(Loader(sampler, 4, 4, shuffle=False)))
    tiled = {k: np.repeat(v[:1], WORLD, axis=0) for k, v in batch.items()
             if k != "meta"}
    return {k: v for k, v in batch.items() if k != "meta"}, tiled


@pytest.fixture(scope="module")
def jax_side():
    """(DLA-34 variables with zero offset convs, a function that runs the
    JAX package's one-device train step on a host batch and returns its
    stats, its parameters and BatchNorm statistics after the step, and
    its gradients; the same in f64, torch_port_common.jax_step_f64)."""
    import jax
    import jax.numpy as jnp
    from torch_port_common import jax_dla_variables, jax_step_f64

    from centerpoly_tpu.losses import PolydetLossConfig as JLossConfig
    from centerpoly_tpu.train import state as jstate
    from centerpoly_tpu.train.step import make_train_step as jmake_train_step
    from centerpoly_tpu_torch.weights import state_dict_from_jax

    model, variables = jax_dla_variables(HEADS, HEAD_CONV, H, W, seed=2)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.zeros_like(a) if "conv_offset_mask" in "/".join(
            str(getattr(p, "key", p)) for p in path) else np.asarray(a),
        variables)
    step = jmake_train_step(JLossConfig(**LOSS))
    # one state's static fields (tx, apply_fn) for every run: a new
    # optimizer would compile the step anew
    base = jstate.create_train_state(model, jax.random.PRNGKey(0),
                                     (1, H, W, 3), base_lr=LR, fast_init=True)

    def run(host):
        params = jax.tree.map(jnp.asarray, variables["params"])
        st = base.replace(step=jnp.asarray(0), params=params,
                          opt_state=base.tx.init(params),
                          batch_stats=jax.tree.map(jnp.asarray,
                                                   variables["batch_stats"]))
        st, stats = step(st, {k: jnp.asarray(v) for k, v in host.items()})
        after = state_dict_from_jax(jax.tree.map(np.asarray, {
            "params": st.params, "batch_stats": st.batch_stats}))
        # Adam's first moment after one step is (1 - b1) g
        mu = jax.tree.map(lambda m: np.asarray(m) / 0.1,
                          st.opt_state[0][0].mu)
        grads = {k: v.numpy() for k, v in
                 state_dict_from_jax({"params": mu}).items()}
        return {k: float(v) for k, v in stats.items()}, after, grads

    def run_f64(host):
        stats, grads, after = jax_step_f64("dla_34", HEADS, HEAD_CONV, (H, W),
                                           LR, LOSS, variables, host)
        return stats, after, {k: v.numpy() for k, v in grads.items()}

    return state_dict_from_jax(variables), run, run_f64


def _floor(sd, host, double=False):
    """The port's own sensitivity floor on the host batch
    (torch_port_common.self_sensitivity), in f64 with `double`."""
    from torch_port_common import self_sensitivity
    return self_sensitivity(_port_net(sd, double), _port_batch(host, double),
                            PolydetLossConfig(**LOSS))[1]


def _check_close_grads(grads, ref, rtol=1e-5):
    """Every gradient within `rtol` of `ref` in relative L2: for two runs
    of one arithmetic, which differ only in the order of a mean."""
    assert grads.keys() == ref.keys()
    for name, r in ref.items():
        r = np.asarray(r, np.float64)
        err = np.linalg.norm(grads[name] - r) / max(np.linalg.norm(r), 1e-30)
        assert err <= rtol, (name, err)


def _check_grads(grads, ref, floor):
    """Each gradient within 4x its sensitivity floor (+1e-3) of `ref` in
    relative L2 (`test_torch_train._check_train_step`'s bound); the
    floored tensors, every DCN offset conv among them, all compared."""
    assert sum("conv_offset_mask" in n for n in floor) == 32
    for name, f in floor.items():
        r = np.asarray(ref[name], np.float64)
        err = np.linalg.norm(grads[name] - r) / np.linalg.norm(r)
        assert err <= 4 * f + 1e-3, (name, err, f)


def _check_against(stats, bufs, params, ref_stats, ref_after, loss_rtol):
    """Each stat within `loss_rtol`, the parameters after Adam within
    2 lr + 1e-6 (a sanity check: it passes any gradient), the BatchNorm
    statistics within rtol 1e-4, atol 1e-5."""
    for k, ref in ref_stats.items():
        np.testing.assert_allclose(stats[k], ref, rtol=loss_rtol, atol=1e-7,
                                   err_msg=k)
    for name, p in params.items():
        np.testing.assert_allclose(p, ref_after[name].numpy(), rtol=0,
                                   atol=2 * LR + 1e-6, err_msg=name)
    for name, b in bufs.items():
        np.testing.assert_allclose(b, ref_after[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _same_on_every_rank(out):
    """Every rank got the global stats, applied the same gradients and
    holds the same BatchNorm statistics; rank 0's results."""
    stats, bufs, digest, (params, grads) = out[0]
    for s, b, d, _ in out[1:]:
        assert s == stats and d == digest
        for name, v in b.items():
            np.testing.assert_array_equal(v, bufs[name], err_msg=name)
    return stats, bufs, params, grads


def _one_process_step(sd, host, double=False):
    """The port's one-process step of `host`: (stats, parameters and
    BatchNorm statistics after it, gradients); in f64 with `double`, else
    in a rank's f32 arithmetic (one thread, `torch_port_common.threads`:
    the ranks run one thread each)."""
    from torch_port_common import threads
    st = tstate.create_train_state(_port_net(sd, double), base_lr=LR)
    with threads(torch.get_num_threads() if double else 1):
        st, stats = make_train_step(PolydetLossConfig(**LOSS))(
            st, _port_batch(host, double))
    after = {**dict(st.model.named_parameters()),
             **dict(st.model.named_buffers())}
    return ({k: float(v) for k, v in stats.items()},
            {k: v.detach() for k, v in after.items()}, _grads(st.model))


def test_global_step_matches_jax_and_one_process(ranks, fixture_batches,
                                                 jax_side):
    """The global step in f64 on every rank, against JAX's one-device step
    and the port's one-process step, both in f64: in f32 the port's
    result moves with torch's thread count, and JAX's with flax's f32
    BatchNorm variance, by as much as the gradient bound
    (tests/test_torch_train.py)."""
    host, _ = fixture_batches
    sd, _, jax_run_f64 = jax_side
    stats, bufs, params, grads = _same_on_every_rank(
        ranks.run(_step_on_rank, sd, host, False, True))
    floor = _floor(sd, host, double=True)
    ref_stats, ref_after, ref_grads = jax_run_f64(host)
    _check_grads(grads, ref_grads, floor)
    _check_against(stats, bufs, params, ref_stats, ref_after, loss_rtol=1e-4)

    one, one_after, one_grads = _one_process_step(sd, host, double=True)
    assert grads.keys() == one_grads.keys()
    _check_grads(grads, one_grads, floor)
    _check_against(stats, bufs, params, one, one_after, loss_rtol=1e-4)


def test_grad_bucket_on_a_tiled_batch_matches_jax(ranks, fixture_batches,
                                                  jax_side):
    """Per-rank statistics equal the global ones on a batch that tiles one
    sample over the ranks, so the bucketed step computes the JAX step's
    function there: the loss within rtol 1e-4 and the parameters after
    Adam within 2 lr + 1e-6, what the JAX package's own bucket test holds
    (tests/test_train.py:100-127), and the BatchNorm statistics equal on
    every rank.  One sample alone is ill-conditioned: the deepest
    BatchNorm normalises 8 values a channel, where a rank's batch-1
    arithmetic moves a batch mean by ~6e-4 and a gradient by up to ~11 %
    relative L2 from JAX's batch of 4, 4x the port's sensitivity to a
    1e-6 weight change (measured), so the loss parts, statistics and
    gradients are not held to JAX's here (the global test holds them).
    The gradients are the port's one-process gradients of that sample in
    a rank's arithmetic instead (relative L2 1e-5)."""
    _, tiled = fixture_batches
    sd, jax_run, _ = jax_side
    stats, _, params, grads = _same_on_every_rank(
        ranks.run(_step_on_rank, sd, tiled, True))
    ref_stats, ref_after, _ = jax_run(tiled)
    np.testing.assert_allclose(stats["loss"], ref_stats["loss"], rtol=1e-4)
    _check_against({}, {}, params, {}, ref_after, 1e-4)
    one = _one_process_step(sd, {k: v[:1] for k, v in tiled.items()})
    _check_close_grads(grads, one[2])


def test_grad_bucket_means_the_ranks_gradients(ranks, fixture_batches,
                                               jax_side):
    """`grad_bucket=True` on the global batch, one sample a rank: the
    gradients, the stats and the BatchNorm statistics are the means of
    the port's one-process steps of each sample in a rank's arithmetic
    (one thread): gradients within 1e-5 in relative L2, stats rtol 1e-5,
    statistics rtol 1e-5, atol 1e-7; and all of them the same on every
    rank.  Ranks that kept their own gradients, or a mean of other
    tensors, would be O(1) off."""
    host, _ = fixture_batches
    sd, _, _ = jax_side
    stats, bufs, _, grads = _same_on_every_rank(
        ranks.run(_step_on_rank, sd, host, True))
    steps = [_one_process_step(sd, {k: v[i:i + 1] for k, v in host.items()})
             for i in range(WORLD)]
    _check_close_grads(grads, {n: np.mean([s[2][n] for s in steps], axis=0)
                               for n in steps[0][2]})
    for k, v in stats.items():
        np.testing.assert_allclose(v, np.mean([s[0][k] for s in steps]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for name, b in bufs.items():
        np.testing.assert_allclose(
            b, np.mean([s[1][name].numpy() for s in steps], axis=0),
            rtol=1e-5, atol=1e-7, err_msg=name)


def _loss_batch(positives):
    """NHWC head maps and GT for a global batch of 4 (8 object slots, 16
    vertices, 3 classes at 12x20); `positives` lists the samples whose
    heat map has peaks (value 1)."""
    rng = np.random.RandomState(1)
    b, h, w, c, k, n = WORLD, 12, 20, 3, 8, 16
    ind = rng.randint(0, h * w, (b, k))
    hm = (rng.rand(b, h, w, c) ** 3 * 0.9).astype(np.float32)
    for i in positives:
        hm.reshape(b, h * w, c)[i, ind[i, :3], np.arange(3) % c] = 1.0
    mask = (rng.rand(b, k) > 0.3).astype(np.float32)
    th = np.sort(rng.uniform(0, 2 * np.pi, (b, k, n)), -1)
    poly = np.stack([rng.uniform(1, 8, (b, k, n)), th], -1).reshape(
        b, k, 2 * n).astype(np.float32)
    maps = {"hm": rng.randn(b, h, w, c), "pseudo_depth": rng.randn(b, h, w, 1),
            "reg": rng.rand(b, h, w, 2),
            "poly": rng.randn(b, h * w, 2 * n)}
    for i in range(b):
        maps["poly"][i, ind[i]] = poly[i] + 0.3 * rng.randn(k, 2 * n)
    maps["poly"] = maps["poly"].reshape(b, h, w, 2 * n)
    gt = {"hm": hm, "ind": ind, "reg_mask": mask, "poly": poly,
          "pseudo_depth": rng.rand(b, k, 1) * 3, "reg": rng.rand(b, k, 2)}
    return tuple({k: np.asarray(v, np.int64 if k == "ind" else np.float32)
                  for k, v in d.items()} for d in (maps, gt))


@pytest.mark.parametrize("cfg_kw,positives", [
    (dict(rep="polar", poly_loss="l1+iou", poly_order=True), [0, 1, 2, 3]),
    (dict(rep="polar", poly_loss="iou", poly_order=True), [0]),
    (dict(rep="cartesian", poly_loss="relu"), []),
    (dict(rep="cartesian", poly_loss="l1", mse_loss=True), [1, 2])])
def test_loss_shares_sum_to_the_global_loss(ranks, cfg_kw, positives):
    """Each loss over the 4 ranks, one sample each: the ranks' shares of
    every stat sum to the one-process loss of the global batch (rtol
    1e-5), and their gradients with respect to their head maps are that
    loss's (rtol 1e-4, atol 1e-6: test_torch_losses.py's bounds).  The
    focal loss's positives lie on one rank only, or on none: the branch
    for no positive is taken on the global count."""
    maps, gt = _loss_batch(positives)
    out = ranks.run(_loss_on_rank, maps, gt, cfg_kw)
    tmaps = {k: torch.tensor(v, requires_grad=True) for k, v in maps.items()}
    loss, stats = polydet_loss([tmaps], {k: torch.tensor(v) for k, v in
                                         gt.items()},
                               PolydetLossConfig(**cfg_kw))
    grads = torch.autograd.grad(loss, list(tmaps.values()))
    for k, v in stats.items():
        np.testing.assert_allclose(sum(o[0][k] for o in out), v.item(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, g in zip(tmaps, grads):
        np.testing.assert_allclose(
            np.concatenate([o[1][k] for o in out]), g.numpy(), rtol=1e-4,
            atol=1e-6, err_msg=k)


def test_main_over_ranks_validates_the_whole_split(ranks, tmp_path,
                                                   monkeypatch):
    """`main --distributed --device cpu` on every rank of the group, on a
    PNG fixture of 6 frames per split: a global batch of 4 (one step an
    epoch), validation of one frame a rank, and of the 6 % 4 that no shard
    holds on rank 0, with oracle heads so the AP needs no trained net;
    then --resume."""
    size = (128, 256)
    root = write_rect_fixture(str(tmp_path), 6, 1, *size,
                              splits=("train", "val"), png=True)
    save = tmp_path / "exp"
    argv = ["polydet", "--data_dir", root, "--save_dir", str(save),
            "--input_h", "64", "--input_w", "128", "--head_conv", "16",
            "--K", "8", "--batch_size", "4", "--num_workers", "0",
            "--val_intervals", "1", "--eval_oracle_hm", "--eval_oracle_poly",
            "--eval_oracle_offset", "--eval_oracle_pseudo_depth",
            "--distributed", "--device", "cpu"]
    out = ranks.run(_main_on_rank, argv + ["--num_epochs", "1"], size)
    assert [o[:2] for o in out] == [(1, 0)] * WORLD
    # rank 0's AP decision reached every rank, and it is the AP one
    # process gets from the whole split (the oracle AP depends on the GT
    # and the frames scored only)
    monkeypatch.setattr(CityscapesMeta, "eval_image_size", size)
    one = tmain.main([a for a in argv if a != "--distributed"] + [
        "--num_epochs", "1", "--save_dir", str(tmp_path / "one")])
    assert {o[2] for o in out} == {one.best} and one.best > 0
    run_dir = save / "cityscapes" / "polydet" / "default"
    assert (run_dir / "model_last.pth").exists()
    assert (run_dir / "model_best.pth").exists()
    with open(run_dir / "results.json") as f:
        scored = {r["image_id"] for r in json.load(f)}
    with open(CityscapesMeta(root).annot_path("val")) as f:
        val_ids = {im["id"] for im in json.load(f)["images"]}
    assert scored == val_ids and len(val_ids) == 6
    logs = [os.path.join(d, f) for d, _, fs in os.walk(run_dir) for f in fs
            if f == "log.txt"]
    assert len(logs) == 1, logs
    out = ranks.run(_main_on_rank, argv + ["--num_epochs", "2", "--resume"],
                    size)
    assert [o[:2] for o in out] == [(2, 1)] * WORLD
    logs = [os.path.join(d, f) for d, _, fs in os.walk(run_dir) for f in fs
            if f == "log.txt"]
    text = "".join(open(p).read() for p in logs)
    assert "resumed from epoch 1" in text and "epoch 2 | 1 iters" in text
    assert text.count("val   2 | AP") == 1


# -- no group needed ---------------------------------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_shards_match_jax(shuffle):
    from centerpoly_tpu.data.loader import Loader as JLoader
    n, bs = 10, 2
    kw = dict(shuffle=shuffle, drop_last=shuffle, seed=3)
    ours = [Loader(None, n, bs, rank=r, world=WORLD, **kw)
            for r in range(WORLD)]
    ref = [JLoader(None, n, bs, rank=r, world=WORLD, **kw)
           for r in range(WORLD)]
    for _ in range(2):
        shards = []
        for a, b in zip(ours, ref):
            got = [x.tolist() for x in a._index_batches()]
            assert got == [x.tolist() for x in b._index_batches()]
            assert len(got) == len(a) == len(b)
            shards.append(np.concatenate(got))
        held = np.concatenate(shards)
        assert len(held) == n // WORLD * WORLD == len(set(held.tolist()))
        # the rest of the epoch is what no shard held
        assert sorted([*held.tolist(), *ours[0].left_out.tolist()]) == list(
            range(n))


def test_explicit_triple_starts_one_rank_a_card(monkeypatch):
    """`main --distributed` with the triple and no --device, on a host of
    2 cards: process 1 of 3 starts 2 ranks, global ranks 2 and 3 of 6 on
    cuda:0 and cuda:1 (LOCAL_RANK, LOCAL_WORLD_SIZE), as the JAX package's
    process meshes both devices.  Without --distributed, one host's 2
    cards are ranks 0 and 1 of 2.  torchrun's path (no triple) starts no
    process."""
    spawned = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.multiprocessing, "spawn",
                        lambda fn, args, nprocs: spawned.append(
                            (fn, args, nprocs)))
    triple = ["--distributed", "--coordinator_address", "10.0.0.1:1234",
              "--num_processes", "3", "--process_id", "1"]
    assert tmain.main(["polydet", "--batch_size", "12", *triple]) is None
    assert tmain.main(["polydet", "--batch_size", "12"]) is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["polydet", "--distributed"])     # torchrun's
    assert [nprocs for _, _, nprocs in spawned] == [2, 2]

    ranks = []
    for key in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.setenv(key, "unset")             # restored afterwards
    monkeypatch.setattr(tmain, "main", lambda argv, device=None: ranks.append(
        (Config.from_args(argv), device, os.environ["LOCAL_RANK"],
         os.environ["LOCAL_WORLD_SIZE"])))
    for fn, args, nprocs in spawned:
        for k in range(nprocs):
            fn(k, *args)
    got = [(c.distributed, c.process_id, c.num_processes, dev, lr, lw)
           for c, dev, lr, lw in ranks]
    assert got == [(True, 2, 6, "cuda", "0", "2"),
                   (True, 3, 6, "cuda", "1", "2"),
                   (True, 0, 2, "cuda", "0", "2"),
                   (True, 1, 2, "cuda", "1", "2")]
    assert ranks[0][0].coordinator_address == "10.0.0.1:1234"
    assert ranks[2][0].coordinator_address.startswith("localhost:")
    with pytest.raises(ValueError):
        mesh.host_ranks(3, 3, 2)


@pytest.mark.parametrize("processes,cards", [(2, 2), (3, 2), (1, 4)])
def test_triple_global_batch_is_jax_loaders(processes, cards):
    """The ranks of `mesh.host_ranks` over every process take, step by
    step, the global batch that the JAX package's Loader gives over the
    processes (the same samples; each JAX process then splits its share
    over its devices), over two shuffled epochs."""
    from centerpoly_tpu.data.loader import Loader as JLoader
    n, batch = 29, 12
    kw = dict(shuffle=True, drop_last=True, seed=3)
    ranks = [rank for p in range(processes)
             for rank, world in mesh.host_ranks(processes, p, cards)]
    world = processes * cards
    assert sorted(ranks) == list(range(world))
    ours = [Loader(None, n, batch // world, rank=r, world=world, **kw)
            for r in ranks]
    ref = [JLoader(None, n, batch // processes, rank=p, world=processes, **kw)
           for p in range(processes)]
    for _ in range(2):
        got = list(zip(*[loader._index_batches() for loader in ours]))
        want = list(zip(*[loader._index_batches() for loader in ref]))
        assert len(got) == len(want) == n // batch
        for a, b in zip(got, want):
            assert sorted(np.concatenate(a).tolist()) == sorted(
                np.concatenate(b).tolist())


def test_config_flags_roundtrip():
    cfg = Config.from_args([
        "polydet", "--distributed", "--coordinator_address", "10.0.0.1:1234",
        "--num_processes", "4", "--process_id", "2", "--infer_devices", "2",
        "--mesh_shape", "-1"])
    assert cfg.distributed and cfg.num_processes == 4
    assert cfg.coordinator_address == "10.0.0.1:1234" and cfg.process_id == 2
    assert cfg.infer_devices == 2 and cfg.mesh_shape == (-1,)
    default = Config()
    assert not default.distributed and default.infer_devices == 0


def test_mesh_helpers_without_a_group():
    assert mesh.initialize_distributed(num_processes=1) is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="--process_id"):
        mesh.initialize_distributed("localhost:1", 2, device="cpu")
    assert mesh.make_mesh(device="cpu") == torch.device("cpu")
    assert mesh.serving_devices(2, "cpu") == [torch.device("cpu")] * 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            mesh.make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA devices"):
            mesh.serving_devices(2)
    batch = {"input": np.arange(8).reshape(4, 2), "meta": list("abcd")}
    got = mesh.shard_batch(batch, 1, 2)
    assert got["input"].tolist() == [[4, 5], [6, 7]] and got["meta"] == ["c",
                                                                         "d"]
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, 0, 3)


def _same_detections(got, ref) -> int:
    """Per class the same rows: scores and depth within 1e-3, coordinates
    within 1e-2 px (test_torch_detector.py's bounds).  Returns the number
    of rows."""
    n = 0
    for j in range(1, 9):
        g, r = np.asarray(got[j]), np.asarray(ref[j])
        assert g.shape == r.shape, j
        n += len(r)
        np.testing.assert_allclose(g[:, [4, -1]], r[:, [4, -1]], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(g[:, :4], r[:, :4], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 5:-1], r[:, 5:-1], rtol=0, atol=1e-2)
    return n


def test_run_batch_over_two_devices_matches_one_and_jax(monkeypatch):
    """3 frames over 2 replicas (the last frame padded once), input
    64x128 from 128x256 frames, head_conv 32, K 16, f32, exact DCN."""
    from torch_port_common import jax_dla_variables

    from centerpoly_tpu.configs import Config as JaxConfig
    from centerpoly_tpu.infer import detector as jdet

    kw = dict(input_h=64, input_w=128, head_conv=32, K=16,
              mixed_precision=False)
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    variables = jax_dla_variables(HEADS, 32, 64, 128, seed=8)[1]
    frames = [np.random.RandomState(s).randint(0, 256, (128, 256, 3),
                                               dtype=np.uint8)
              for s in (11, 12, 13)]
    try:
        ref = jdet.create_detector(JaxConfig(dcn_kernel="off", **kw),
                                   variables).run_batch(frames)
    finally:
        JaxConfig(**kw)     # dcn_kernel auto: the variable's prior value
    cfg = Config(dcn_kernel="off", **kw)
    one = create_detector(cfg, variables, device="cpu").run_batch(frames)
    two = create_detector(cfg, variables, devices=["cpu", "cpu"])
    assert len(two.replicas) == 2
    # the first entry is the detector's own net, the second a copy
    assert two.replicas[0].model is two.model
    assert two.replicas[1].model is not two.replicas[0].model
    got = two.run_batch(frames)
    assert len(got) == len(one) == len(ref) == 3
    for g, o, r in zip(got, one, ref):
        for j in range(1, 9):
            np.testing.assert_array_equal(g["results"][j], o["results"][j])
        assert _same_detections(g["results"], r["results"]) == 16
