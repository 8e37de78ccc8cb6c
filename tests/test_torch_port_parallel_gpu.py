"""The data-parallel steps as programs (``make_parallel_train_step``,
``make_video_step_parallel``, ``make_pair_step_parallel``: on CUDA under
NCCL each captured once as a CUDA graph with its collectives inside) held
against their eager form and the serial programs on a CUDA card, at
``tests/test_torch_port_programs_gpu.py``'s tiny float32 config, with one
NCCL rank in this process (an in-process ``HashStore``, world 1; the
group is left at each test's end). Also an eager step after program
steps on one state, and the refusal of a program under gloo. Marked
``gpu``: they skip without a card. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_port_parallel_gpu.py
"""

import numpy as np
import pytest
import torch

from dtt_torch.data.synthetic import sample_params_batch
from dtt_torch.data.device_synth import make_pair_render_fn
from dtt_torch.models.targets import sample_draws
from dtt_torch.train.trainer import create_train_state, make_train_step
from dtt_torch.utils.params import init_jax_params

# pytest puts this directory on the path (the card's machine has another
# package named tests)
from test_torch_port_programs_gpu import (CALLS, H, W, _calls, _exact,
                                          _frames, _hold, _tiny)

pytestmark = pytest.mark.gpu

STEPS = 5          # train steps that cross a learning-rate boundary


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def _train_cfg():
    """The tiny config with a warm-up of 2 steps and a decay at step 3,
    so that the rate changes inside STEPS steps."""
    cfg = _tiny()
    return cfg.replace(train=cfg.train.replace(
        learning_rate=1e-3, warmup_steps=2, lr_decay_steps=(3,)))


def _train_inputs(cfg, cuda, b: int = 2):
    rng = np.random.RandomState(3)
    batches = [sample_params_batch(rng, b, H, W, cfg.model.num_classes,
                                   cfg.input.max_gt_boxes,
                                   num_objects=(1, 4)) for _ in range(STEPS)]
    dgen = torch.Generator(device=cuda).manual_seed(4)
    draws = [sample_draws(cfg, b, dgen, cuda) for _ in range(STEPS)]
    return batches, draws


def _run(cfg, cuda, make_step, forms, batches, draws, tree):
    """One state stepped by ``forms[i]`` of the step at step i ("program"
    or "eager"): the metrics of each step, the state, the render generator
    and the step."""
    model, state = create_train_state(cfg, cuda, tree=tree)
    step = make_step(model)
    gen = torch.Generator(device=cuda).manual_seed(5)
    metrics = []
    for i, form in enumerate(forms):
        fn = step if form == "program" else step.eager
        state, m = fn(state, batches[i], draws[i], gen)
        metrics.append(m)
    torch.cuda.synchronize()
    return metrics, state, gen, step


def _same_run(a, b) -> list:
    """What differs between two runs of `_run`, bit for bit: the losses
    of each step, the parameters and buffers, the momentum buffers and
    the render generator's state."""
    (ma, sa, ga, _), (mb, sb, gb, _) = a, b
    bad = [(i, k) for i, (x, y) in enumerate(zip(ma, mb)) for k in x
           if not _exact(x[k], y[k])]
    want = sb.model.state_dict()
    bad += [k for k, v in sa.model.state_dict().items()
            if not _exact(v, want[k])]
    bufs = lambda s: [x["momentum_buffer"] for x in s.optimizer.state.values()]
    assert len(bufs(sa)) == len(bufs(sb)) > 0
    bad += [f"momentum {i}" for i, (x, y) in enumerate(zip(bufs(sa),
                                                             bufs(sb)))
            if not _exact(x, y)]
    if not torch.equal(ga.get_state(), gb.get_state()):
        bad.append("render generator")
    assert sa.step == sb.step == len(ma)
    return bad


def _s2(cuda, make_step):
    """Program steps then eager steps on one state, and eager steps then
    program steps, each against eager steps only: bit for bit."""
    cfg = _train_cfg()
    tree = init_jax_params(cfg.model, seed=2)
    batches, draws = _train_inputs(cfg, cuda)
    make = lambda model: make_step(cfg, model)
    eager = _run(cfg, cuda, make, ["eager"] * STEPS, batches, draws, tree)
    for forms in (["program"] * 3 + ["eager"] * 2,
                  ["eager"] * 2 + ["program"] * 3):
        mixed = _run(cfg, cuda, make, forms, batches, draws, tree)
        assert _same_run(mixed, eager) == [], forms
        programs = mixed[3].programs
        assert [p.captures for p in programs] == [1]
        assert programs[0].replays == forms.count("program") - 1


def test_s2_eager_steps_after_program_steps_serial(cuda):
    """S2 for the serial train step (``make_train_step``, rendering on
    the card)."""
    _s2(cuda, lambda cfg, model: make_train_step(
        cfg, model, (H // 16, W // 16),
        render_fn=make_pair_render_fn(H, W, cuda)))


@pytest.fixture
def nccl(cuda):
    """One NCCL rank in this process; the group is left at the end."""
    import torch.distributed as dist

    from dtt_torch.parallel import data_mesh, initialize_distributed
    initialize_distributed(store=dist.HashStore(), world_size=1, rank=0,
                           device="cuda:0")
    try:
        yield data_mesh("cuda:0")
    finally:
        dist.destroy_process_group()


def _parallel_train(mesh):
    from dtt_torch.train.trainer import make_parallel_train_step
    return lambda cfg, model: make_parallel_train_step(
        cfg, model, (H // 16, W // 16), mesh,
        render_fn=make_pair_render_fn(H, W, mesh.device))


def test_s2_eager_steps_after_program_steps_parallel(nccl):
    """S2 for the parallel train step on one NCCL rank."""
    _s2(nccl.device, _parallel_train(nccl))


def test_parallel_train_program_matches_eager_and_serial(nccl):
    """STEPS steps of the parallel train program (the first eager, then
    captured with the all-reduces inside), of its ``.eager`` and of the
    serial program from one state, batches, draws and render generators
    seeded alike, across the warm-up's end and a decay: every loss,
    parameter, buffer and momentum buffer and the render generator's
    state bit for bit."""
    cuda = nccl.device
    cfg = _train_cfg()
    tree = init_jax_params(cfg.model, seed=2)
    batches, draws = _train_inputs(cfg, cuda)
    par = _parallel_train(nccl)
    program = _run(cfg, cuda, lambda m: par(cfg, m), ["program"] * STEPS,
                   batches, draws, tree)
    eager = _run(cfg, cuda, lambda m: par(cfg, m), ["eager"] * STEPS,
                 batches, draws, tree)
    serial = _run(cfg, cuda, lambda m: make_train_step(
        cfg, m, (H // 16, W // 16),
        render_fn=make_pair_render_fn(H, W, cuda)), ["program"] * STEPS,
        batches, draws, tree)
    assert _same_run(program, eager) == []
    assert _same_run(program, serial) == []
    p = program[3].programs[0]
    assert (p.captures, p.replays) == (1, STEPS - 1)


@pytest.mark.parametrize("kind", ["video", "pair"])
def test_parallel_inference_programs_match_eager(nccl, kind):
    """The parallel video program (4 frames on the rank) and pair program
    (2 pairs) over CALLS calls with changing frames, extents and scales,
    each bit-equal to ``step.eager``; one program, captured once and
    replayed every call; outputs that share no storage between calls."""
    from dtt_torch.eval.inference import (make_pair_step_parallel,
                                          make_video_step_parallel)
    from dtt_torch.utils.params import from_jax_params
    cuda = nccl.device
    cfg = _tiny()
    model = from_jax_params(init_jax_params(cfg.model, seed=1), cfg.model,
                            cuda)
    if kind == "video":
        step = make_video_step_parallel(cfg, model, nccl, 4)
        xs = [_frames(4, s) for s in range(CALLS)]
    else:
        step = make_pair_step_parallel(cfg, model, nccl, 2)
        xs = [_frames(4, s).reshape(2, 2, H, W, 3) for s in range(CALLS)]
    assert len(step.programs) == 1
    _hold(step, _calls(cuda, xs))


def test_parallel_programs_refuse_under_gloo_on_cuda(cuda):
    """Under a gloo group on the card every parallel program raises a
    RuntimeError naming the backend (gloo's collectives cannot be
    captured) before it runs anything; ``step.eager`` runs."""
    import torch.distributed as dist

    from dtt_torch.eval.inference import (make_pair_step_parallel,
                                          make_video_step_parallel)
    from dtt_torch.parallel import data_mesh, initialize_distributed
    from dtt_torch.train.trainer import make_parallel_train_step
    from dtt_torch.utils.params import from_jax_params
    initialize_distributed(store=dist.HashStore(), world_size=1, rank=0,
                           device="cuda:0", backend="gloo")
    try:
        mesh = data_mesh("cuda:0")
        assert mesh.backend == "gloo"
        cfg = _train_cfg()
        model, state = create_train_state(cfg, cuda,
                                          tree=init_jax_params(cfg.model,
                                                               seed=2))
        batches, draws = _train_inputs(cfg, cuda, b=1)
        gen = torch.Generator(device=cuda).manual_seed(5)
        train = make_parallel_train_step(
            cfg, model, (H // 16, W // 16), mesh,
            render_fn=make_pair_render_fn(H, W, cuda))
        video = make_video_step_parallel(cfg, model, mesh, 2)
        pair = make_pair_step_parallel(cfg, model, mesh, 1)
        im_hw = torch.tensor((H, W), dtype=torch.float32, device=cuda)
        frames = _frames(2, 0)
        for call in (lambda: train(state, batches[0], draws[0], gen),
                     lambda: video(frames, im_hw),
                     lambda: pair(frames.reshape(1, 2, H, W, 3), im_hw)):
            with pytest.raises(RuntimeError, match="gloo backend"):
                call()
        assert [p.captures + p.replays for s in (train, video, pair)
                for p in s.programs] == [0, 0, 0]
        state, _ = train.eager(state, batches[0], draws[0], gen)
        assert state.step == 1
        out = video.eager(frames, im_hw)
        assert out[0].shape[0] == 2
    finally:
        dist.destroy_process_group()


def _count_collectives(monkeypatch) -> dict:
    """Count the calls of torch.distributed's collectives by name
    (``dtt_torch.parallel.mesh`` calls them through the module)."""
    import torch.distributed as dist
    counts = {}
    for name in ("all_reduce", "all_gather", "broadcast",
                 "batch_isend_irecv"):
        def call(*args, _fn=getattr(dist, name), _name=name, **kwargs):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(dist, name, call)
    return counts


def test_parallel_replays_call_no_collective_from_python(nccl, monkeypatch):
    """The collectives are inside the graphs: once captured, the train
    program (2 more steps) and the video and pair programs (2 more calls
    each) replay without calling a torch.distributed collective from
    Python, while their first calls and each ``.eager`` call do; the
    replays' outputs follow their inputs (the gather's device copy
    replays)."""
    from dtt_torch.eval.inference import (make_pair_step_parallel,
                                          make_video_step_parallel)
    from dtt_torch.utils.params import from_jax_params
    cuda = nccl.device
    counts = _count_collectives(monkeypatch)
    cfg = _train_cfg()
    tree = init_jax_params(cfg.model, seed=2)
    batches, draws = _train_inputs(cfg, cuda)
    model, state = create_train_state(cfg, cuda, tree=tree)
    train = _parallel_train(nccl)(cfg, model)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for i in range(2):                  # eager, then the capture
        state, _ = train(state, batches[i], draws[i], gen)
    assert counts.get("all_reduce", 0) == 4
    counts.clear()
    for i in range(2, 4):
        state, _ = train(state, batches[i], draws[i], gen)
    torch.cuda.synchronize()
    assert counts == {}
    train.eager(state, batches[4], draws[4], gen)
    assert counts == {"all_reduce": 2}

    model = from_jax_params(init_jax_params(cfg.model, seed=1), cfg.model,
                            cuda)
    for step, xs in (
            (make_video_step_parallel(cfg, model, nccl, 4),
             [_frames(4, s) for s in range(3)]),
            (make_pair_step_parallel(cfg, model, nccl, 2),
             [_frames(4, s).reshape(2, 2, H, W, 3) for s in range(3)])):
        calls = _calls(cuda, xs)
        step(*calls[0])                 # the warm-up and the capture
        counts.clear()
        got = [step(*args) for args in calls[1:]]
        torch.cuda.synchronize()
        assert counts == {}
        for args, out in zip(calls[1:], got):
            want = step.eager(*args)
            assert all(_exact(a, b) for a, b in zip(out, want))
        assert counts == {"all_gather": 4 * 2}
        counts.clear()
