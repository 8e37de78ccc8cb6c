"""The step programs (``dtt_torch.utils.programs``: a serial step captured
once as a CUDA graph and replayed) held against their eager form on a CUDA
card, at a tiny float32 config (``chip_smoke.py`` holds them at full
width). Marked ``gpu``: they skip without a card. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_port_programs_gpu.py
"""

import numpy as np
import pytest
import torch

from dtt_torch.core.config import Config
from dtt_torch.data.device_synth import make_pair_render_fn
from dtt_torch.data.synthetic import sample_params_batch
from dtt_torch.eval.inference import (make_pair_step, make_single_frame_step,
                                      make_video_step)
from dtt_torch.models.targets import sample_draws
from dtt_torch.ops import nms as tnms
from dtt_torch.train.trainer import create_train_state, make_train_step
from dtt_torch.utils.params import from_jax_params, init_jax_params
from dtt_torch.utils.programs import StepProgram

pytestmark = pytest.mark.gpu

H, W = 64, 96
CALLS = 3          # calls of each inference program, inputs changing
STEPS = 5          # train steps of the program against the eager form


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tiny(split: bool = True) -> Config:
    cfg = Config()
    m = cfg.model
    return cfg.replace(
        model=m.replace(backbone="tiny", dtype="float32", frozen_stages=0,
                        reduced_channels=64, num_classes=4,
                        anchors=m.anchors.replace(scales=(1.0, 2.0, 4.0)),
                        rpn=m.rpn.replace(channels=32,
                                          pre_nms_top_n_train=128,
                                          post_nms_top_n_train=32,
                                          pre_nms_top_n_test=64,
                                          post_nms_top_n_test=16),
                        roi=m.roi.replace(ps_grid=3, batch_size=16),
                        track=m.track.replace(max_displacement=2, stride=1)),
        input=cfg.input.replace(canvas_height=H, canvas_width=W,
                                max_gt_boxes=4),
        eval=cfg.eval.replace(split_video_step=split))


def _exact(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(ints), b.view(ints))
    return torch.equal(a, b)


def _frames(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (n, H, W, 3)).astype(np.uint8))


def _hold(step, calls: list) -> None:
    """Each call of the program bit-equal to ``step.eager`` on the same
    arguments; no storage shared by consecutive calls; each program
    captured once and replayed every call."""
    prev = set()
    for args in calls:
        got, want = list(step(*args)), list(step.eager(*args))
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert _exact(g, w), i
        ptrs = {t.untyped_storage().data_ptr() for t in got}
        assert not ptrs & prev
        prev = ptrs
    assert [p.captures for p in step.programs] == [1] * len(step.programs)
    assert all(p.replays == len(calls) for p in step.programs)


def _calls(cuda, frames: list) -> list:
    hw = [(H, W), (56, 80), (48, 72)]
    return [(x, torch.tensor(hw[i], dtype=torch.float32, device=cuda),
             (1.0, 0.6, 1.5)[i]) for i, x in enumerate(frames)]


@pytest.mark.parametrize("split", [True, False])
def test_video_program_matches_eager(cuda, split):
    cfg = _tiny(split)
    model = from_jax_params(init_jax_params(cfg.model, seed=1), cfg.model,
                            cuda)
    step = make_video_step(cfg, model, 4)
    assert len(step.programs) == (2 if split else 1)
    _hold(step, _calls(cuda, [_frames(4, s) for s in range(CALLS)]))


@pytest.mark.parametrize("split", [True, False])
def test_pair_program_matches_eager(cuda, split):
    cfg = _tiny(split)
    model = from_jax_params(init_jax_params(cfg.model, seed=1), cfg.model,
                            cuda)
    step = make_pair_step(cfg, model, 2)
    _hold(step, _calls(cuda, [_frames(4, s).reshape(2, 2, H, W, 3)
                              for s in range(CALLS)]))


def test_single_frame_program_matches_eager(cuda):
    cfg = _tiny()
    model = from_jax_params(init_jax_params(cfg.model, seed=1), cfg.model,
                            cuda)
    step = make_single_frame_step(cfg, model)
    _hold(step, [(x, hw.cpu(), s) for x, hw, s in
                 _calls(cuda, [_frames(1, s) for s in range(CALLS)])])


def test_replays_count_the_captured_launches(cuda):
    """A replay adds the launches its capture recorded (the capture itself
    counts none), so a path's counts see every kernel of every call."""
    cfg = _tiny()
    model = from_jax_params(init_jax_params(cfg.model, seed=1), cfg.model,
                            cuda)
    step = make_single_frame_step(cfg, model)
    x = _frames(1, 0)
    before = tnms.nms_cuda.launches
    step.eager(x)
    torch.cuda.synchronize()
    per_call = tnms.nms_cuda.launches - before
    assert per_call >= 2
    before = tnms.nms_cuda.launches
    step(x)              # the warm-up and the first replay
    step(x)
    torch.cuda.synchronize()
    assert tnms.nms_cuda.launches - before == 3 * per_call


def test_video_program_records_replays_and_pinned_bytes(cuda):
    """Recorded (``dtt_torch.utils.profiling``), each call of a captured
    video step's two programs is a ``program.call`` labelled with the
    program's name, with ``program.copy_in`` and ``program.replay`` under
    it (and the post-trunk stage's ``program.copy_out``), and
    ``program.pinned_bytes`` adds a chunk's bytes a call: each chunk is a
    fresh host array, pinned to be uploaded."""
    from dtt_torch.utils.profiling import recording
    cfg = _tiny()
    model = from_jax_params(init_jax_params(cfg.model, seed=1), cfg.model,
                            cuda)
    step = make_video_step(cfg, model, 4)
    hw = torch.tensor((H, W), dtype=torch.float32, device=cuda)
    step(_frames(4, 0), hw)              # the warm-up and the capture
    with recording() as rec:
        for s in range(CALLS):
            step(_frames(4, s), hw)
        torch.cuda.synchronize()
    calls = rec.named("program.call")
    assert sorted(c.label for c in calls) == sorted(
        [p.name for p in step.programs] * CALLS)
    for name, n in (("program.copy_in", 2), ("program.replay", 2),
                    ("program.copy_out", 1)):
        under = [rec.spans[s.parent] for s in rec.named(name)]
        assert len(under) == n * CALLS
        assert all(p.name == "program.call" for p in under)
    assert rec.counts == {"program.pinned_bytes": CALLS * 4 * H * W * 3}


def test_train_program_matches_eager_with_device_render(cuda):
    """STEPS train steps of the program (the first eager, then captured)
    against STEPS of ``step.eager`` from the same weights, batches, draws
    and render generators seeded alike, with cuDNN's deterministic
    algorithms: every loss, parameter and momentum buffer bit for bit, and
    the render generators end in the same state."""
    cfg = _tiny()
    tree = init_jax_params(cfg.model, seed=2)
    b = 2
    rng = np.random.RandomState(3)
    batches = [sample_params_batch(rng, b, H, W, cfg.model.num_classes,
                                   cfg.input.max_gt_boxes,
                                   num_objects=(1, 4)) for _ in range(STEPS)]
    dgen = torch.Generator(device=cuda).manual_seed(4)
    draws = [sample_draws(cfg, b, dgen, cuda) for _ in range(STEPS)]
    render = make_pair_render_fn(H, W, cuda)
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for form in ("program", "eager"):
            model, state = create_train_state(cfg, cuda, tree=tree)
            step = make_train_step(cfg, model, (H // 16, W // 16),
                                   render_fn=render)
            fn = step if form == "program" else step.eager
            gen = torch.Generator(device=cuda).manual_seed(5)
            metrics = []
            for i in range(STEPS):
                state, m = fn(state, batches[i], draws[i], gen)
                metrics.append(m)
            torch.cuda.synchronize()
            runs.append((metrics, state, gen, step))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (mp, sp, gp, step), (me, se, ge, _) = runs
    assert step.programs[0].captures == 1
    assert step.programs[0].replays == STEPS - 1
    assert sp.step == se.step == STEPS
    for a, e in zip(mp, me):
        assert a.keys() == e.keys()
        for k in a:
            assert _exact(a[k], e[k]), k
    want = se.model.state_dict()
    for k, v in sp.model.state_dict().items():
        assert _exact(v, want[k]), k
    bp = [s["momentum_buffer"] for s in sp.optimizer.state.values()]
    be = [s["momentum_buffer"] for s in se.optimizer.state.values()]
    assert len(bp) == len(be) > 0
    assert all(_exact(x, y) for x, y in zip(bp, be))
    assert torch.equal(gp.get_state(), ge.get_state())


def test_capture_that_reads_back_raises_naming_the_step(cuda):
    """A step that reads a CUDA value back to the host cannot be captured:
    the program raises an error naming the step and the line, runs
    nothing eagerly in its place, and raises again on the next call; the
    card goes on working, random draws from the default and from a
    registered generator included."""
    ran = []

    def body(x, gen):
        ran.append(1)
        return x * x.sum().item()

    program = StepProgram(body, "read-back probe", cuda)
    x = torch.ones(4, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with pytest.raises(RuntimeError, match="read-back probe.*x.sum"):
        program(x, gen)
    assert len(ran) == 2          # the warm-up and the failed capture
    with pytest.raises(RuntimeError, match="read-back probe"):
        program(x, gen)
    assert len(ran) == 2
    assert program.replays == 0
    assert torch.equal(torch.ones(2, device=cuda) + 1,
                       torch.full((2,), 2.0, device=cuda))
    assert torch.rand(2, device=cuda).shape == (2,)
    assert torch.rand(2, device=cuda, generator=gen).shape == (2,)
