"""The port's step programs (``dtt_torch.utils.programs``: on CUDA a serial
step captured once as a CUDA graph and replayed) held against dtt's jitted
steps on the CPU, where a program runs its step directly with the same
copies in and out: the device-side learning rate against dtt's optax
schedule, three train steps, the video and single-frame steps at two
scales and two extents, both ``split_video_step`` forms, and the copies
that keep two calls in flight apart. Tiny configs (64x96, float32); the
card's side is ``tests/test_torch_port_programs_gpu.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtt.core.config import Config as JConfig
from dtt.core.config import load_config as j_load_config
from dtt.eval import inference as jinf
from dtt.models import dnt as jdnt
from dtt.train import trainer as jtrainer
from tests import test_models, test_train
from tests.test_torch_port_eval import torch_config
from tests.test_torch_port_train import GRAD_TOL, LOSS_TOL, _batch, _jax_draws

from dtt_torch.core.config import Config, load_config
from dtt_torch.eval import inference as tinf
from dtt_torch.models.targets import sample_draws
from dtt_torch.train import trainer as ttrainer
from dtt_torch.train.checkpoint import _state_dict
from dtt_torch.utils.params import from_jax_params, to_jax_tree
from dtt_torch.utils.programs import StepProgram

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 64, 96
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the eval outputs at tests/test_torch_port_video.py's bounds
EVAL_ATOL = (("boxes", 1e-2), ("scores", 1e-4), ("valid", 0),
             ("tracked", 1e-2))
SCALES = (1.0, 0.6)
EXTENTS = ((56, 80), (H, W))


# ------------------------------------------------------------------ (a) rate

def _rate_steps(t) -> list:
    """The steps around the warm-up's end and every decay boundary."""
    steps = {0, 1, 2}
    if t.warmup_steps:
        steps |= {t.warmup_steps + d for d in (-2, -1, 0, 1)}
    for b in t.lr_decay_steps:
        steps |= {int(b) + d for d in (-1, 0, 1)}
    return sorted(s for s in steps if s >= 0)


@pytest.mark.parametrize("config", [None, "mid_synth.yml",
                                    "flagship_synth.yml"])
def test_learning_rate_tensor_is_dtt_schedule_bit_for_bit(config):
    """``learning_rate_tensor`` at each step around the warm-up and every
    decay boundary equals, bit for bit, the rate dtt's optax chain applies
    at that count: the update of a zero weight with gradient 1 (under the
    clip, no decay on zero, momentum from zero) is -rate exactly."""
    path = None if config is None else os.path.join(ROOT, "configs", config)
    jcfg = JConfig() if path is None else j_load_config(path)
    tc = Config() if path is None else load_config(path)
    tx = jtrainer.make_optimizer(jcfg)
    params = {"head": {"kernel": jnp.zeros((1,), jnp.float32)}}
    grads = {"head": {"kernel": jnp.ones((1,), jnp.float32)}}
    state = tx.init(params)
    rate = jax.jit(lambda count: -tx.update(
        grads, optax.tree_utils.tree_set(state, count=count),
        params)[0]["head"]["kernel"][0])
    steps = _rate_steps(tc.train)
    assert len(steps) >= 6
    for step in steps:
        want = np.asarray(rate(jnp.int32(step)), np.float32)
        got = ttrainer.learning_rate_tensor(
            tc, torch.tensor(step)).numpy()
        assert got.dtype == np.float32
        assert got.view(np.int32) == want.view(np.int32), (step, got, want)
        assert got == np.float32(ttrainer.learning_rate(tc, step))


# ------------------------------------------------------------------ (b) train

def _trace_tree(state, tc) -> dict:
    """The port's momentum as optax's trace (buffer times ``lr_mult``),
    in flax layout."""
    chain = _state_dict(state, tc)["opt_state"]
    sgd = next(v for v in chain.values() if "0" in v and "trace" in v["0"])
    return sgd["0"]["trace"]


def test_train_program_matches_dtt_over_three_steps():
    """Three steps of the train program (on the CPU: the step with its
    copies in and out) against three of dtt's jitted ``train_step`` from
    dtt's initial weights, on the same batches and draws, with a warm-up
    over two steps so that the rate moves: losses at LOSS_TOL each step;
    the parameters' total update and the momentum (optax's trace) at
    GRAD_TOL, its atol scaled by the rates and momentum the gradients
    went through, plus two float32 roundings of each parameter."""
    cfg = test_train.tiny_config(warmup_steps=2)
    tc = torch_config(cfg)
    model = jdnt.make_model(cfg.model)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 2, H, W, 3), jnp.float32))
    tree = jax.tree.map(np.asarray, params)
    tx = jtrainer.make_optimizer(cfg)
    jstate = jtrainer.TrainState(params, tx.init(params["params"]),
                                 jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(cfg, model, (H // 16, W // 16))
    tmodel, tstate = ttrainer.create_train_state(tc, "cpu", tree=tree)
    step = ttrainer.make_train_step(tc, tmodel, (H // 16, W // 16), "cpu")
    n_anchors = (H // 16) * (W // 16) * tc.model.anchors.num_anchors
    n_rois = tc.model.rpn.post_nms_top_n_train + tc.input.max_gt_boxes
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        jstate, want = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, key)
        tstate, got = step(tstate, batch, _jax_draws(key, n_anchors, n_rois))
        assert tstate.step == i + 1
        for name, v in want.items():
            np.testing.assert_allclose(got[name].item(), float(v),
                                       **LOSS_TOL, err_msg=f"{i} {name}")
    t = tc.train
    rates = [ttrainer.learning_rate(tc, i) for i in range(3)]
    # how much of one step's gradient reaches the parameters and the trace
    reach = sum(r * sum(t.momentum ** j for j in range(3 - k))
                for k, r in enumerate(rates))
    got_p = jax.tree_util.tree_leaves(to_jax_tree(tmodel)["params"])
    want_p = jax.tree_util.tree_leaves(jstate.params["params"])
    before = jax.tree_util.tree_leaves(tree["params"])
    moved = 0
    for p0, pp, pj in zip(before, got_p, want_p):
        got_u, want_u = pp - p0, np.asarray(pj) - p0
        tol = (GRAD_TOL["atol"] * 2 * reach + GRAD_TOL["rtol"]
               * np.abs(want_u) + 2 * np.spacing(np.abs(p0)))
        assert not (np.abs(got_u - want_u) > tol).any()
        moved += bool(np.any(want_u != 0))
    assert moved > 10
    want_t = jax.tree_util.tree_leaves(
        optax.tree_utils.tree_get(jstate.opt_state, "trace"))
    got_t = jax.tree_util.tree_leaves(_trace_tree(tstate, tc))
    assert len(got_t) == len(want_t) == len(before)
    for a, b in zip(got_t, want_t):
        b = np.asarray(b)
        tol = (GRAD_TOL["atol"] * 2 * 3 + GRAD_TOL["rtol"] * np.abs(b))
        assert not (np.abs(np.asarray(a) - b) > tol).any()


# ------------------------------------------------------------------ eval setup

@pytest.fixture(scope="module")
def eval_setup():
    cfg = test_models.tiny_config()
    cfg = cfg.replace(input=cfg.input.replace(canvas_height=H,
                                              canvas_width=W))
    model = jdnt.make_model(cfg.model)
    params = jax.jit(model.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 2, H, W, 3)))
    tc = torch_config(cfg)
    tmodel = from_jax_params(jax.tree.map(np.asarray, params), tc.model,
                             device="cpu")
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (7, H, W, 3)).astype(np.uint8)
    return dict(cfg=cfg, model=model, params=params, tc=tc, tmodel=tmodel,
                frames=frames)


def _split(cfg, split: bool):
    return cfg.replace(eval=cfg.eval.replace(split_video_step=split))


def _assert_outputs(got, want, what: str) -> None:
    for i, (name, atol) in enumerate(EVAL_ATOL[:len(got)]):
        g = got[i].numpy() if isinstance(got[i], torch.Tensor) else got[i]
        w = np.asarray(want[i])
        assert np.isfinite(g.astype(np.float32)).all(), (what, name)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{what} {name}")


# ------------------------------------------------------------------ (c)

def test_program_calls_share_no_storage_and_drivers_match_eager(eval_setup):
    """Two consecutive calls of each program return tensors that share no
    storage (the train step's metrics too), and ``evaluate_snippet_video``
    over a 3-chunk snippet (two chunks in flight) through the program
    equals the same driver over ``step.eager``."""
    s = eval_setup
    tc, tmodel, frames = s["tc"], s["tmodel"], s["frames"]
    im_hw = torch.tensor(EXTENTS[0], dtype=torch.float32)

    def storages(out):
        xs = out.values() if isinstance(out, dict) else out
        return {x.untyped_storage().data_ptr() for x in xs}

    video = tinf.make_video_step(tc, tmodel, 4, device="cpu")
    pair = tinf.make_pair_step(tc, tmodel, 2, device="cpu")
    frame = tinf.make_single_frame_step(tc, tmodel, device="cpu")
    chunk = torch.from_numpy(frames[:4])
    for step, x in ((video, chunk), (pair, chunk.reshape(2, 2, H, W, 3)),
                    (frame, chunk[:1])):
        a, b = step(x, im_hw, 1.0), step(x, im_hw, 1.0)
        assert not storages(a) & storages(b)
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    ttc = torch_config(test_train.tiny_config())
    model, state = ttrainer.create_train_state(ttc, "cpu")
    train = ttrainer.make_train_step(ttc, model, (H // 16, W // 16), "cpu")
    g = torch.Generator().manual_seed(0)
    outs = []
    for i in range(2):
        state, m = train(state, _batch(test_train.tiny_config(), i),
                         sample_draws(ttc, 2, g))
        outs.append(m)
    assert not storages(outs[0]) & storages(outs[1])

    got = tinf.evaluate_snippet_video(tc, video, frames, im_hw=EXTENTS[0])
    want = tinf.evaluate_snippet_video(tc, video.eager, frames,
                                       im_hw=EXTENTS[0])
    assert video.programs[0].replays == 0     # the CPU runs no graph
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2].any()


def test_step_program_keys_calls_by_signature():
    """Numbers are inputs (a new value is copied in, not a new program);
    a new shape, dtype or object is a new signature; a borrowed argument
    is read in place; outputs are copies unless ``copy_out=False``."""
    seen = []

    def fn(x, s, obj):
        seen.append(obj)
        return {"y": x * s}

    p = StepProgram(fn, "probe", "cpu")
    x = torch.ones(3)
    a = p(x, 2.0, "o")["y"]
    b = p(x, 3, "o")["y"]          # int: another signature
    c = p(x, 4.0, "o")["y"]
    assert a.tolist() == [2.0] * 3 and b.tolist() == [3.0] * 3
    assert c.tolist() == [4.0] * 3
    assert len(p._entries) == 2
    p(torch.ones(4), 2.0, "o")
    p(x, 2.0, "other")
    assert len(p._entries) == 4 and seen[-1] == "other"
    entry = p._entries[next(iter(p._entries))]
    assert entry.buffers[0] is not x and entry.buffers[1].dtype == torch.float32

    inner = StepProgram(lambda x: x + 1, "stage", "cpu", copy_out=False)
    outer = StepProgram(lambda y, z: y * z, "next", "cpu", borrow=(0,))
    y = inner(x)
    assert outer(y, 2.0).tolist() == [4.0] * 3
    assert outer._entries[next(iter(outer._entries))].buffers[0] is y
    assert torch.equal(p.eager(x, 2.0, "o")["y"], a)


# ------------------------------------------------------------------ (d), (e)

@pytest.mark.parametrize("split", [True, False])
def test_video_program_matches_dtt_at_scales_and_extents(eval_setup, split):
    """The video program (``split_video_step`` on: trunk and post-trunk
    programs; off: one) on a 4-frame chunk at two scales and two extents
    against dtt's jitted step with the same flag and arguments, at the
    video test's bounds; both port forms give the same bits."""
    s = eval_setup
    cfg, tc = _split(s["cfg"], split), _split(s["tc"], split)
    jstep = jinf.make_video_step(cfg, s["model"], 4)
    step = tinf.make_video_step(tc, s["tmodel"], 4, device="cpu")
    other = tinf.make_video_step(_split(s["tc"], not split), s["tmodel"], 4,
                                 device="cpu")
    assert len(step.programs) == (2 if split else 1)
    chunk = s["frames"][:4]
    for scale in SCALES:
        for hw in EXTENTS:
            want = jstep(s["params"], jnp.asarray(chunk),
                         jnp.asarray(hw, jnp.float32), scale)
            im_hw = torch.tensor(hw, dtype=torch.float32)
            got = step(torch.from_numpy(chunk), im_hw, scale)
            _assert_outputs(got, want, f"scale {scale} extent {hw}")
            for a, b in zip(got, other(torch.from_numpy(chunk), im_hw,
                                       scale)):
                assert torch.equal(a, b)
            assert got[2].any()


def test_single_frame_program_matches_dtt_at_scales_and_extents(eval_setup):
    """The single-frame program at two scales and two extents against
    dtt's jitted step at the same arguments (the extent and the scale are
    inputs of both, not constants)."""
    s = eval_setup
    jstep = jinf.make_single_frame_step(s["cfg"], s["model"])
    step = tinf.make_single_frame_step(s["tc"], s["tmodel"], device="cpu")
    image = s["frames"][3:4]
    for scale in SCALES:
        for hw in EXTENTS:
            want = jstep(s["params"], jnp.asarray(image),
                         jnp.asarray(hw, jnp.float32), scale)
            got = step(torch.from_numpy(image), hw, scale)
            _assert_outputs(got, want, f"scale {scale} extent {hw}")
            assert got[2].any()


def test_pair_program_forms_agree(eval_setup):
    """The pair step under both ``split_video_step`` forms gives the same
    outputs, and ``step.eager`` the program's."""
    s = eval_setup
    pairs = torch.from_numpy(s["frames"][:4]).reshape(2, 2, H, W, 3)
    im_hw = torch.tensor(EXTENTS[0], dtype=torch.float32)
    a, b = (tinf.make_pair_step(_split(s["tc"], f), s["tmodel"], 2,
                                device="cpu") for f in (True, False))
    assert (len(a.programs), len(b.programs)) == (2, 1)
    for x, y, z in zip(a(pairs, im_hw, 0.6), b(pairs, im_hw, 0.6),
                       a.eager(pairs, im_hw, 0.6)):
        assert torch.equal(x, y) and torch.equal(x, z)
