"""dtt_torch's data parallelism held against dtt's on the CPU: two gloo
ranks (spawned processes over a ``file://`` store, tests/torch_port_ranks.py)
against dtt's steps on a 2-device mesh of the conftest's virtual CPU
devices, and against the port's own one-process steps.

* The train step (``make_parallel_train_step``, ``shard_batch``,
  ``shard_draws``, ``replicate_tree``) on a global batch of 2 pairs, one a
  rank, at the tiny training config of tests/test_torch_port_train.py:
  the ranks' discrete decisions, the global losses and the updated
  parameters against dtt's ``make_parallel_train_step`` at that file's
  tolerances, and against the port's ``make_train_step`` on the whole
  batch at a tighter one.
* The video step (``make_video_step_parallel``, 1 and 2 frames a rank,
  psroi and align) and the pair step (``make_pair_step_parallel``) against
  dtt's, the snippet drivers over them (the wrapped pair trimmed by
  ``real``) against the port's serial drivers.
* ``train_torch.main`` on two ranks against one process, the sharding's
  refusal of a batch that does not divide, and ``eval_torch --parallel``
  on a one-rank group.
* The steps as programs (on the CPU: copies around a direct call): the
  train program over three steps with a rate change among them against
  dtt's jitted parallel step and the port's serial program, the video
  and pair programs at two scales and two extents against dtt's, each
  program's outputs against its ``.eager`` form's bit for bit.

All ranks' work runs in one start of the two processes (module fixture).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtt.core.anchors import grid_anchors_for
from dtt.eval import inference as jinf
from dtt.models import dnt as jdnt
from dtt.parallel.mesh import data_mesh as j_data_mesh
from dtt.train import trainer as jtrainer
from tests import test_models, test_train
from tests.test_torch_port_train import (GRAD_TOL, LOSS_TOL, _batch,
                                         _jax_decisions, _jax_draws,
                                         torch_config)
from tests.torch_port_ranks import parallel_jobs, record_render_run, run_ranks

from dtt_torch.core.config import load_config
from dtt_torch.data.synthetic import synthetic_batch
from dtt_torch.eval import inference as tinf
from dtt_torch.models.targets import Draws
from dtt_torch.parallel import DataMesh
from dtt_torch.train import trainer as ttrainer
from dtt_torch.utils.logging import read_metrics
from dtt_torch.utils.params import from_jax_params, init_jax_params

import train_torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 64, 96
B = 2                      # the global train batch: one pair a rank
WORLD = 2
KEY = 7
FRAMES = 7                 # snippet length: chunks overlap, the tail pads
IM_HW = (56, 80)
SCALES = (1.0, 0.6)
EXTENTS = (IM_HW, (H, W))
STEPS3 = 3                 # train program steps; the warm-up ends at step 2
MODES = ("psroi", "align")
# the port's two ranks against its one process on the same global batch:
# the same arithmetic but for the order of the batch's sums (a rank sums
# its rows, the all-reduce the ranks), so float32 roundoff of a sum
TIGHT_LOSS = dict(rtol=1e-6, atol=1e-7)
# ... and each updated parameter, as chip_smoke.py holds the card's step
# against the CPU's: two float32 ulps of the parameter plus 2e-8, under 1%
# of a typical lr * g update of ~1e-5
TIGHT_PARAM = dict(atol=2e-8, rtol=2.5e-7)
# eval outputs at tests/test_torch_port_video.py's bounds
EVAL_ATOL = (("boxes", 1e-2), ("scores", 1e-4), ("valid", 0),
             ("tracked", 1e-2))
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "tiny_synth.yml")


def _eval_cfg(mode):
    cfg = test_models.tiny_config()
    return cfg.replace(
        input=cfg.input.replace(canvas_height=H, canvas_width=W),
        model=cfg.model.replace(roi=cfg.model.roi.replace(pooling_mode=mode)))


def _train_argv(out, per_rank):
    return ["--synthetic", "--calibrate-bn", "--config", CONFIG, "--out",
            str(out), "--set", "train.total_steps=2", "train.log_every=1",
            f"train.batch_size_per_chip={per_rank}"]


def _render_argv(out, per_rank):
    return ["--synthetic", "--device-render", "--config", CONFIG, "--out",
            str(out), "--set", "train.total_steps=2", "train.log_every=1",
            f"train.batch_size_per_chip={per_rank}"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs of every case, and the two ranks' results."""
    root = tmp_path_factory.mktemp("parallel")
    train_cfg = test_train.tiny_config()
    tc = torch_config(train_cfg)
    # dtt's own initial variables, as tests/test_torch_port_train.py's
    tree = jax.tree.map(np.asarray, jax.jit(
        jdnt.make_model(train_cfg.model).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3), jnp.float32)))
    anchors = grid_anchors_for(train_cfg.model.anchors, H // 16, W // 16)
    key = jax.random.PRNGKey(KEY)
    draws = _jax_draws(key, anchors.shape[0],
                       tc.model.rpn.post_nms_top_n_train
                       + tc.input.max_gt_boxes)
    frames = np.random.RandomState(5).randint(0, 256, (FRAMES, H, W, 3)
                                              ).astype(np.uint8)
    train3_cfg = test_train.tiny_config(warmup_steps=2)
    n_rois = (tc.model.rpn.post_nms_top_n_train + tc.input.max_gt_boxes)
    keys3 = [jax.random.PRNGKey(20 + i) for i in range(STEPS3)]
    eval_cfgs = {m: torch_config(_eval_cfg(m)) for m in MODES}
    eval_trees = {m: init_jax_params(c.model, seed=1)
                  for m, c in eval_cfgs.items()}
    p = dict(tree=tree, train_cfg=tc, batch=_batch(train_cfg, seed=4),
             draws=draws, anchors=anchors, feat_hw=(H // 16, W // 16),
             frames=frames, im_hw=IM_HW, eval_cfgs=eval_cfgs,
             eval_trees=eval_trees,
             train_argv=_train_argv(root / "run2", 1),
             render_argv=_render_argv(root / "render2", 1),
             train3_cfg=torch_config(train3_cfg),
             batches3=[_batch(train3_cfg, seed=10 + i)
                       for i in range(STEPS3)],
             draws3=[_jax_draws(k, anchors.shape[0], n_rois) for k in keys3],
             scales=SCALES, extents=EXTENTS,
             pairs=frames[[0, 2, 1, 3, 2, 4, 3, 5]].reshape(4, 2, H, W, 3))
    ranks = run_ranks(parallel_jobs, WORLD, root / "ranks", p)
    return dict(p, ranks=ranks, root=root, train_cfg=train_cfg, key=key,
                train3_jcfg=train3_cfg, keys3=keys3)


# ------------------------------------------------------------------ train

@pytest.fixture(scope="module")
def dtt_train(setup):
    """dtt's parallel step on a 2-device mesh: decisions, metrics and the
    updated parameters."""
    cfg = setup["train_cfg"]
    mesh = j_data_mesh(jax.devices()[:WORLD])
    model = jdnt.make_model(cfg.model)
    params = jax.tree.map(jnp.asarray, setup["tree"])
    tx = jtrainer.make_optimizer(cfg)
    state = jtrainer.TrainState(params, tx.init(params["params"]),
                                jnp.zeros((), jnp.int32))
    state = jtrainer.TrainState(*jtrainer.replicate_tree(tuple(state), mesh))
    step = jtrainer.make_parallel_train_step(cfg, model, setup["feat_hw"],
                                             mesh)
    jbatch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    decisions = jax.jit(lambda p: _jax_decisions(
        cfg, model, p, jnp.asarray(setup["anchors"]), jbatch,
        setup["key"]))(params)
    new, metrics = step(state, jtrainer.shard_batch(setup["batch"], mesh),
                        setup["key"])
    return dict(decisions=jax.tree.map(np.asarray, decisions),
                metrics={k: float(v) for k, v in metrics.items()},
                params=jax.tree.map(np.asarray, new.params))


def _port_params(state_dict, tree, cfg):
    """A rank's updated state as a flax tree."""
    from dtt_torch.utils.params import to_jax_tree
    model = from_jax_params(tree, cfg.model, device="cpu")
    model.load_state_dict(state_dict)
    return to_jax_tree(model)


def test_ranks_hold_one_replica(setup):
    """Both ranks end the step with the same state, bit for bit, and the
    all-reduce moves every trainable float32 parameter once."""
    a, b = (r["train"] for r in setup["ranks"])
    assert [r["rank"] for r in setup["ranks"]] == [0, 1]
    assert all(r["size"] == WORLD for r in setup["ranks"])
    assert a["step"] == b["step"] == 1
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    assert a["metrics"] == b["metrics"]
    n = sum(v.numel() for k, v in a["state"].items()
            if k.endswith(("weight", "bias", "kernel")))
    assert 0 < a["allreduce_bytes"] <= 4 * n


def test_parallel_decisions_match_dtt(setup, dtt_train):
    """Each rank's anchor labels, proposals, RoI labels and OHEM selection
    are dtt's for that rank's rows of the global batch."""
    for name, want in dtt_train["decisions"].items():
        got = np.concatenate([r["train"]["decisions"][name].numpy()
                              for r in setup["ranks"]])
        got = got.reshape(want.shape)
        if name == "proposal_rois":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_parallel_step_matches_dtt(setup, dtt_train):
    """The global losses at LOSS_TOL and each parameter's update at
    GRAD_TOL against dtt's 2-device step: an update is the learning rate
    times the clipped gradient (plus the same weight decay on both
    sides), so its atol is GRAD_TOL's times the rate, plus the two
    float32 roundings of the parameter that the update is read through."""
    got_m = setup["ranks"][0]["train"]["metrics"]
    for name, want in dtt_train["metrics"].items():
        np.testing.assert_allclose(got_m[name], want, **LOSS_TOL,
                                   err_msg=name)
    tc = setup["train_cfg"]
    lr = tc.train.learning_rate
    got = _port_params(setup["ranks"][0]["train"]["state"], setup["tree"],
                       torch_config(tc))
    before = jax.tree_util.tree_flatten_with_path(setup["tree"])[0]
    after_p = jax.tree_util.tree_leaves(got)
    after_j = jax.tree_util.tree_leaves(dtt_train["params"])
    moved = 0
    for (path, p0), pp, pj in zip(before, after_p, after_j):
        name = jax.tree_util.keystr(path)
        got_u, want_u = pp - p0, pj - p0
        tol = (GRAD_TOL["atol"] * lr + GRAD_TOL["rtol"] * np.abs(want_u)
               + 2 * np.spacing(np.abs(p0)))
        bad = np.abs(got_u - want_u) > tol
        assert not bad.any(), (name, int(bad.sum()),
                               float(np.abs(got_u - want_u).max()))
        moved += bool(np.any(pj != p0))
    assert moved > 0


def test_parallel_step_matches_one_process(setup):
    """The two ranks against the port's one-process ``make_train_step`` on
    the whole global batch with the whole draws: losses at TIGHT_LOSS,
    every updated parameter at TIGHT_PARAM."""
    cfg = setup["train_cfg"]
    tc = torch_config(cfg)
    model, state = ttrainer.create_train_state(tc, "cpu", tree=setup["tree"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = ttrainer.make_train_step(tc, model, setup["feat_hw"], "cpu")
    state, metrics = step(state, setup["batch"], setup["draws"])
    got = setup["ranks"][0]["train"]
    for name, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][name], v.item(),
                                   **TIGHT_LOSS, err_msg=name)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                   **TIGHT_PARAM, err_msg=k)


# ------------------------------------------------------------ train programs

@pytest.fixture(scope="module")
def dtt_train3(setup):
    """dtt's jitted parallel step on a 2-device mesh over the STEPS3
    batches and keys: each step's metrics, the parameters and the
    momentum (optax's trace) after."""
    cfg = setup["train3_jcfg"]
    mesh = j_data_mesh(jax.devices()[:WORLD])
    model = jdnt.make_model(cfg.model)
    params = jax.tree.map(jnp.asarray, setup["tree"])
    tx = jtrainer.make_optimizer(cfg)
    state = jtrainer.TrainState(params, tx.init(params["params"]),
                                jnp.zeros((), jnp.int32))
    state = jtrainer.TrainState(*jtrainer.replicate_tree(tuple(state), mesh))
    step = jtrainer.make_parallel_train_step(cfg, model, setup["feat_hw"],
                                             mesh)
    metrics = []
    for batch, key in zip(setup["batches3"], setup["keys3"]):
        state, m = step(state, jtrainer.shard_batch(batch, mesh), key)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics,
                params=jax.tree.map(np.asarray, state.params),
                trace=jax.tree.map(np.asarray, optax.tree_utils.tree_get(
                    state.opt_state, "trace")))


def test_parallel_train_program_matches_dtt_over_three_steps(setup,
                                                             dtt_train3):
    """The parallel train program on two ranks over three steps whose
    rate changes (the warm-up ends at step 2) against dtt's jitted
    parallel step: the global losses of each step at LOSS_TOL, the
    parameters' total update at GRAD_TOL, its atol scaled by the rates
    and momentum the gradients went through (as
    tests/test_torch_port_programs.py holds the serial program), plus two
    float32 roundings of each parameter."""
    got = setup["ranks"][0]["train3"]
    assert got["step"] == STEPS3
    for i, (g, w) in enumerate(zip(got["metrics"], dtt_train3["metrics"])):
        for name, v in w.items():
            np.testing.assert_allclose(g[name], v, **LOSS_TOL,
                                       err_msg=f"step {i} {name}")
    tc = setup["train3_cfg"]
    t = tc.train
    rates = [ttrainer.learning_rate(tc, i) for i in range(STEPS3)]
    assert len(set(rates)) > 1
    reach = sum(r * sum(t.momentum ** j for j in range(STEPS3 - k))
                for k, r in enumerate(rates))
    after = _port_params(got["state"], setup["tree"], tc)
    before = jax.tree_util.tree_leaves(setup["tree"])
    moved = 0
    for p0, pp, pj in zip(before, jax.tree_util.tree_leaves(after),
                          jax.tree_util.tree_leaves(dtt_train3["params"])):
        got_u, want_u = pp - p0, pj - p0
        tol = (GRAD_TOL["atol"] * 2 * reach + GRAD_TOL["rtol"]
               * np.abs(want_u) + 2 * np.spacing(np.abs(p0)))
        assert not (np.abs(got_u - want_u) > tol).any()
        moved += bool(np.any(want_u != 0))
    assert moved > 10


def test_parallel_train_program_matches_serial_program(setup):
    """The two ranks' program against the port's serial train program on
    the whole global batches and draws over the same three steps: every
    step's losses at TIGHT_LOSS, every parameter after at TIGHT_PARAM; and
    both ranks end with one replica."""
    tc = setup["train3_cfg"]
    model, state = ttrainer.create_train_state(tc, "cpu", tree=setup["tree"])
    step = ttrainer.make_train_step(tc, model, setup["feat_hw"], "cpu")
    a, b = (r["train3"] for r in setup["ranks"])
    for i, (batch, draws) in enumerate(zip(setup["batches3"],
                                           setup["draws3"])):
        state, metrics = step(state, batch, draws)
        for name, v in metrics.items():
            np.testing.assert_allclose(a["metrics"][i][name], v.item(),
                                       **TIGHT_LOSS,
                                       err_msg=f"step {i} {name}")
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(a["state"][k].numpy(), v.numpy(),
                                   **TIGHT_PARAM, err_msg=k)
        assert torch.equal(a["state"][k], b["state"][k]), k
    assert a["metrics"] == b["metrics"]


def test_parallel_programs_equal_their_eager_form(setup):
    """On each rank, the train program's three steps equal three
    ``step.eager`` steps from the same state bit for bit (every metric,
    parameter and momentum buffer), and each call of the video and pair
    programs equals ``step.eager``'s."""
    for r in setup["ranks"]:
        assert r["train3"]["differ"] == [], r["rank"]
        assert r["train3"]["n_bufs"] > 0
        assert r["grid"]["differ"] == [], r["rank"]
        assert len(r["grid"]["outputs"]) == len(MODES) * 3 * len(
            SCALES) * len(EXTENTS)


def test_global_batch_must_divide_by_the_world():
    """shard_batch, shard_draws and PairLoader refuse a global batch that
    does not divide by the world size, as dtt's sharding does."""
    from dtt_torch.data.loader import PairLoader
    from dtt_torch.core.config import InputConfig
    mesh = DataMesh(rank=1, size=2, device=torch.device("cpu"))
    batch = synthetic_batch(np.random.RandomState(0), 3, H, W, 4, 4,
                            uint8=True)
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        ttrainer.shard_batch(batch, mesh)
    draws = Draws(*(torch.zeros(3, 2, 5) for _ in range(4)))
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        ttrainer.shard_draws(draws, mesh)
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        PairLoader([{"source": "x"}], InputConfig(), 3, rank=1, world_size=2)
    rows = ttrainer.shard_batch({k: v[:2] for k, v in batch.items()}, mesh)
    np.testing.assert_array_equal(rows["images"], batch["images"][1:2])


@pytest.mark.parametrize("det_fraction", [None, 0.5])
def test_pair_loader_rank_yields_its_rows(det_fraction):
    """A rank's PairLoader yields its rows of each global batch the
    one-process loader yields at the same seed (the index stream is
    dtt's), preparing only those; with and without the DET:VID draw."""
    from dtt_torch.core.config import InputConfig
    from dtt_torch.data.loader import PairLoader
    roidb = [{"id": i, "source": "det" if i % 3 == 0 else "vid"}
             for i in range(10)]
    prepared = []

    def prepare(entry, cfg):
        prepared.append(entry["id"])
        return {"id": np.asarray(entry["id"])}

    def first(rank=0, world=1, n=6):
        loader = PairLoader(roidb, InputConfig(), 4, seed=3, num_workers=1,
                            prefetch=1, prepare_fn=prepare,
                            det_fraction=det_fraction, rank=rank,
                            world_size=world)
        try:
            it = iter(loader)
            return [next(it)["id"] for _ in range(n)]
        finally:
            loader.stop()

    whole = first()
    ranks = []
    for r in range(WORLD):
        prepared.clear()
        ranks.append(first(r, WORLD))
        # its 2 rows of the 6 batches taken and of at most 3 more in the
        # queue or in preparation; all 4 rows would be at least 24
        assert len(prepared) <= 2 * (6 + 3)
    for i, batch in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([r[i] for r in ranks]), batch)
        assert len(ranks[0][i]) == 2


def test_train_torch_two_ranks_match_one_process(setup, tmp_path):
    """train_torch.main --calibrate-bn on two ranks (one pair each) and
    on one process (two pairs) for 2 steps: the ranks calibrate on the
    whole first batch, rank 0 alone wrote the run dir (one row a step),
    and the logged losses agree to the log's 4 decimals (one unit of the
    last, for a value that rounds the other way)."""
    one = tmp_path / "run1"
    train_torch.main(_train_argv(one, 2), device="cpu")
    two = read_metrics(str(setup["root"] / "run2" / "metrics.jsonl"))
    want = read_metrics(str(one / "metrics.jsonl"))
    assert [r["step"] for r in two] == [r["step"] for r in want] == [1, 2]
    for a, b in zip(two, want):
        for k in ("total", "rpn_cls", "rpn_box", "rfcn_cls", "rfcn_box",
                  "track", "num_fg", "fg_ce"):
            assert abs(a[k] - b[k]) <= 1.0001e-4, (k, a[k], b[k])
    assert sorted(os.listdir(setup["root"] / "run2")) == sorted(
        os.listdir(one))


def test_device_render_draws_are_one_process_draws(setup, tmp_path):
    """train_torch.main --device-render on two ranks and on one process
    for 2 steps: every step's draws are the one process's, bit for bit
    (the draws' generator renders nothing), and each rank draws its
    canvases from a generator of its own (seed + 2 + rank)."""
    one = record_render_run(_render_argv(tmp_path / "render1", 2))
    seed = load_config(CONFIG).train.seed
    assert one["seeds"] == [seed + 2] * 2
    for r in setup["ranks"]:
        got = r["render"]
        assert got["seeds"] == [seed + 2 + r["rank"]] * 2
        assert len(got["draws"]) == len(one["draws"]) == 2
        for a, b in zip(got["draws"], one["draws"]):
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_synthetic_batch_renders_only_its_rows(monkeypatch):
    """A rank's host batch (synthetic_batch with rows) is its rows of the
    whole batch, bit for bit, leaves the rng where the whole batch does,
    and renders only its own pairs."""
    from dtt_torch.data import synthetic
    whole_rng, rank_rng = (np.random.RandomState(3) for _ in range(2))
    whole = synthetic.synthetic_batch(whole_rng, 4, H, W, 4, 4, uint8=True)
    drawn = []
    render = synthetic.render_frame
    monkeypatch.setattr(synthetic, "render_frame",
                        lambda *a: drawn.append(1) or render(*a))
    mesh = DataMesh(rank=1, size=2, device=torch.device("cpu"))
    rows = synthetic.synthetic_batch(rank_rng, 4, H, W, 4, 4, uint8=True,
                                     rows=mesh.rows(4))
    assert len(drawn) == 2 * 2          # two pairs of two frames
    for k, v in whole.items():
        np.testing.assert_array_equal(rows[k], v[2:4], err_msg=k)
    assert whole_rng.randint(1 << 30) == rank_rng.randint(1 << 30)


def test_collectives_take_only_the_ranks_device(monkeypatch):
    """No host tensor reaches a collective (NCCL takes none): the gather
    copies its input to the rank's device first, and the in-place
    collectives refuse a tensor off it. A mesh on the meta device stands
    for a card here."""
    import torch.distributed as dist
    from dtt_torch import parallel
    seen = []

    def all_gather(parts, t):
        seen.append(t.device)

    monkeypatch.setattr(DataMesh, "distributed", property(lambda m: True))
    monkeypatch.setattr(dist, "all_gather", all_gather)
    mesh = DataMesh(rank=0, size=2, device=torch.device("meta"))
    out = parallel.all_gather_cat(torch.zeros(3, 2), mesh)
    assert seen == [torch.device("meta")]
    assert out.device == mesh.device and out.shape == (6, 2)
    for call in (lambda t: parallel.all_reduce_mean_(t, mesh),
                 lambda t: parallel.broadcast_([t], mesh),
                 lambda t: parallel.exchange_halo([t], mesh)):
        with pytest.raises(ValueError, match="given a tensor on cpu"):
            call(torch.zeros(2))


# ------------------------------------------------------------------ eval

@pytest.fixture(scope="module")
def dtt_eval(setup):
    """dtt's parallel video (1 and 2 frames a device) and pair steps on a
    2-device mesh, per pooling mode, with the port's weights."""
    mesh = j_data_mesh(jax.devices()[:WORLD])
    im_hw = jnp.asarray(IM_HW, jnp.float32)
    out = {}
    for mode in MODES:
        cfg = _eval_cfg(mode)
        model = jdnt.make_model(cfg.model)
        params = jax.tree.map(jnp.asarray, setup["eval_trees"][mode])
        for fpd in (1, 2):
            step = jinf.make_video_step_parallel(cfg, model, mesh, fpd)
            chunk = setup["frames"][:step.frames_per_chunk]
            out[mode, "chunk", fpd] = [np.asarray(x) for x in step(
                params, jnp.asarray(chunk), im_hw, jnp.float32(1.0))]
        step = jinf.make_pair_step_parallel(cfg, model, mesh, 2)
        out[mode, "pair"] = jinf.evaluate_snippet(
            cfg, step, params, setup["frames"], tau=2, batch=step.batch,
            im_hw=IM_HW)
    return out


@pytest.fixture(scope="module")
def dtt_grid(setup):
    """dtt's parallel video (1 and 2 frames a device) and pair (2 pairs a
    device) steps on a 2-device mesh at each scale and extent, per
    pooling mode."""
    mesh = j_data_mesh(jax.devices()[:WORLD])
    out = {}
    for mode in MODES:
        cfg = _eval_cfg(mode)
        model = jdnt.make_model(cfg.model)
        params = jax.tree.map(jnp.asarray, setup["eval_trees"][mode])
        steps = {("video", fpd): (jinf.make_video_step_parallel(
            cfg, model, mesh, fpd), setup["frames"][:WORLD * fpd])
            for fpd in (1, 2)}
        steps["pair", 2] = (jinf.make_pair_step_parallel(cfg, model, mesh, 2),
                            setup["pairs"])
        for (kind, n), (step, x) in steps.items():
            for scale in SCALES:
                for hw in EXTENTS:
                    out[mode, kind, n, scale, hw] = [np.asarray(y) for y in step(
                        params, jnp.asarray(x), jnp.asarray(hw, jnp.float32),
                        jnp.float32(scale))]
    return out


@pytest.mark.parametrize("kind,n", [("video", 1), ("video", 2), ("pair", 2)])
@pytest.mark.parametrize("mode", MODES)
def test_parallel_programs_match_dtt_at_scales_and_extents(setup, dtt_grid,
                                                           mode, kind, n):
    """The video program (n frames a rank) and the pair program (2 pairs
    a rank) on both ranks at two scales and two extents against dtt's
    parallel steps at the same arguments (the extent and the scale are
    inputs of both): `valid` equal, the rest at the video test's
    bounds."""
    for r in setup["ranks"]:
        for scale in SCALES:
            for hw in EXTENTS:
                key = (mode, kind, n, scale, hw)
                _close(r["grid"]["outputs"][key], dtt_grid[key], str(key))
    assert any(setup["ranks"][0]["grid"]["outputs"][mode, kind, n, s, e][2]
               .any() for s in SCALES for e in EXTENTS)


def _close(got, want, what):
    for i, (name, atol) in enumerate(EVAL_ATOL):
        g, w = np.asarray(got[i]), np.asarray(want[i])
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        if name == "valid":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("fpd", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_video_step_parallel_matches_dtt(setup, dtt_eval, mode, fpd):
    """One chunk of 2 x fpd frames: every pair, the wrapped last one
    included, on both ranks; `valid` equal, the rest at the video test's
    bounds."""
    for r in setup["ranks"]:
        got = r["eval"][mode, "chunk", fpd]
        assert got[0].shape[0] == WORLD * fpd
        _close(got, dtt_eval[mode, "chunk", fpd], f"{mode} fpd={fpd}")
    assert setup["ranks"][0]["eval"][mode, "chunk", fpd][2].any()


@pytest.mark.parametrize("mode", MODES)
def test_pair_step_parallel_matches_dtt(setup, dtt_eval, mode):
    """``evaluate_snippet`` at tau=2 over 4-pair batches (2 a rank):
    keyframes and `valid` equal, the rest at the video test's bounds."""
    for r in setup["ranks"]:
        got = r["eval"][mode, "pair"]
        want = dtt_eval[mode, "pair"]
        assert got[4] == want[4] == [0, 2, 4, 6]
        _close(got[:4], want[:4], f"{mode} pair")


@pytest.mark.parametrize("mode", MODES)
def test_parallel_drivers_trim_the_wrapped_pair(setup, mode):
    """``evaluate_snippet_video`` over the parallel step gives the serial
    step's arrays (T frames: each chunk's wrapped last pair trimmed by
    `real`), and the wrapped pair of a chunk is the serial step's pair of
    its last frame with its first."""
    cfg = setup["eval_cfgs"][mode]
    model = from_jax_params(setup["eval_trees"][mode], cfg.model,
                            device="cpu")
    im_hw = torch.tensor(IM_HW, dtype=torch.float32)
    frames = setup["frames"]
    for fpd in (1, 2):
        f = WORLD * fpd
        serial = tinf.make_video_step(cfg, model, f, device="cpu")
        want = tinf.evaluate_snippet_video(cfg, serial, frames, im_hw=IM_HW)
        for r in setup["ranks"]:
            got = r["eval"][mode, "video", fpd]
            assert got[0].shape[1] == FRAMES
            _close(got, want, f"{mode} snippet fpd={fpd}")
        wrap = tinf.make_video_step(cfg, model, 2, device="cpu")(
            torch.from_numpy(frames[[f - 1, 0]]), im_hw)
        got = setup["ranks"][1]["eval"][mode, "chunk", fpd]
        _close([x[-1:] for x in got], [x.numpy() for x in wrap],
               f"{mode} wrapped pair fpd={fpd}")


def test_eval_torch_parallel_runs_one_rank(tmp_path, capsys):
    """``eval_torch.py --parallel`` without torchrun makes a group of one
    rank (gloo on the CPU) and prints the one-process run's result, at
    tau=1 (video step) and tau=2 (pair step)."""
    import eval_torch
    from dtt_torch.core.config import load_config
    from dtt_torch.train.checkpoint import save_checkpoint
    import torch.distributed as dist

    cfg = load_config(CONFIG)
    _, state = ttrainer.create_train_state(
        cfg, "cpu", tree=init_jax_params(cfg.model, seed=2))
    ck = save_checkpoint(str(tmp_path), state, cfg)
    for extra in (["--link"], ["--tau", "2"]):
        argv = ["--checkpoint", ck, "--synthetic", "--synthetic-snippets",
                "1", *extra]
        want = eval_torch.main(argv, device="cpu")
        got = eval_torch.main(argv + ["--parallel"], device="cpu")
        assert "rank(s) (gloo)" in capsys.readouterr().out
        assert got[0] == want[0] and got[2] == want[2]
        assert not dist.is_initialized()
