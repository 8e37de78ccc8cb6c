"""The snippet drivers' staging of a chunk on a CUDA card
(``dtt_torch.eval.inference``: each chunk gathered into a pinned slot of a
ring, its outputs copied back into the slot behind the step, read once
the slot's event is done). Held bit for bit against the loop the drivers
ran before it (each chunk gathered into a fresh array, the same step
called, each chunk's rows read back by ``.cpu()``) with the card kept
behind the host, so that a slot written or read before its event would
show; and the card kept busy from a snippet's fourth chunk on, where that
loop drained it. At ``tests/test_torch_port_programs_gpu.py``'s tiny
float32 config. Marked ``gpu``: they skip without a card. This file
imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_port_staging_gpu.py
"""

import numpy as np
import pytest
import torch

from dtt_torch.eval.inference import (PairOutputs, _gather_chunk,
                                      evaluate_snippet,
                                      evaluate_snippet_video, make_pair_step,
                                      make_video_step)
from dtt_torch.utils.params import from_jax_params, init_jax_params
from dtt_torch.utils.profiling import recording

# pytest puts this directory on the path (the card's machine has another
# package named tests)
from test_torch_port_programs_gpu import H, W, _tiny

pytestmark = pytest.mark.gpu

CHUNK = 4            # frames a video chunk: 3 pairs
PAIRS = 2            # pairs a batch of the pair step
EXTENT = (56, 80)
SHORT = 20_000_000   # cycles the card sleeps before each call (~10 ms)
LONG = 100_000_000   # ~50 ms: far longer than the host's work a chunk


@pytest.fixture(scope="module")
def steps():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _tiny()
    model = from_jax_params(init_jax_params(cfg.model, seed=1), cfg.model,
                            torch.device("cuda"))
    return (cfg, make_video_step(cfg, model, CHUNK),
            make_pair_step(cfg, model, PAIRS))


def _frames(t_len: int, kind: str, seed: int = 0) -> np.ndarray:
    x = np.random.RandomState(seed).randint(0, 256, (t_len, H, W, 3))
    if kind == "uint8":
        return x.astype(np.uint8)
    return ((x - 110) / 60).astype(np.float32)      # normalized canvases


def _slowed(step, cycles: int):
    """`step` with the card put to sleep for `cycles` before each call,
    so that it runs behind the host; ``idle`` records, at each call,
    whether the stream had finished all its work (after the chunk's
    gather, before the call's own work)."""
    def slow(x, im_hw, scale=1.0):
        slow.idle.append(torch.cuda.current_stream().query())
        torch.cuda._sleep(cycles)
        return step(x, im_hw, scale)
    slow.idle = []
    for k in ("frames_per_chunk", "batch", "device"):
        if hasattr(step, k):
            setattr(slow, k, getattr(step, k))
    return slow


def _fresh(step, chunks) -> list:
    """The drivers' loop before the staging: each (fresh host chunk, real
    rows) of `chunks` through `step`, two in flight, the oldest read back
    by ``.cpu()`` once a third is queued (which waits for the stream)."""
    hw = torch.tensor(EXTENT, dtype=torch.float32, device=step.device)
    outs, pending = [], []

    def fetch(entry):
        out, real = entry
        return [x[:real].cpu().numpy() for x in out]

    for x, real in chunks:
        pending.append((step(x, hw, 1.0), real))
        if len(pending) > 2:
            outs.append(fetch(pending.pop(0)))
    outs.extend(fetch(e) for e in pending)
    return outs


def _fresh_video(cfg, step, frames) -> tuple:
    """``evaluate_snippet_video``'s outputs by the loop it ran before the
    staging."""
    t_len = len(frames)
    chunks = ((_gather_chunk(cfg, frames, [min(i, t_len - 1) for i in
                                           range(start, start + CHUNK)]),
               min(CHUNK - 1, t_len - start))
              for start in range(0, t_len, CHUNK - 1))
    outs = _fresh(step, chunks)
    return tuple(np.concatenate([o[i] for o in outs])[:t_len].swapaxes(0, 1)
                 for i in range(4))


def _fresh_pairs(cfg, step, frames, tau: int) -> tuple:
    """``evaluate_snippet``'s outputs by the loop it ran before the
    staging."""
    t_len = len(frames)
    pair_idx = [(t, min(t + tau, t_len - 1)) for t in range(0, t_len, tau)]

    def chunks():
        for i in range(0, len(pair_idx), PAIRS):
            chunk = pair_idx[i:i + PAIRS]
            real = len(chunk)
            chunk += [chunk[-1]] * (PAIRS - real)
            g = _gather_chunk(cfg, frames, [t for ab in chunk for t in ab])
            yield g.reshape(PAIRS, 2, *g.shape[1:]), real

    outs = _fresh(step, chunks())
    return tuple(np.concatenate([o[i] for o in outs]).swapaxes(0, 1)
                 for i in range(4))


def _same(got, want) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert a.tobytes() == b.tobytes(), i


@pytest.mark.parametrize("kind", ["uint8", "float32"])
@pytest.mark.parametrize("chunks", [1, 2, 3, 4, 7])
def test_staged_video_driver_equals_the_fresh_loop(steps, chunks, kind):
    """Snippets of 1, 2, 3, 4 and 7 chunks, each with a padded last
    chunk (T = 3n - 1 frames in chunks of 3 pairs), bit for bit."""
    cfg, video, _ = steps
    frames = _frames(3 * chunks - 1, kind, seed=chunks)
    want = _fresh_video(cfg, video, frames)
    slow = _slowed(video, SHORT)
    got = evaluate_snippet_video(cfg, slow, frames, im_hw=EXTENT)
    assert len(slow.idle) == chunks
    _same(got, want)


@pytest.mark.parametrize("kind", ["uint8", "float32"])
@pytest.mark.parametrize("tau", [1, 2])
def test_staged_pair_driver_equals_the_fresh_loop(steps, tau, kind):
    """13 frames in batches of 2 pairs: 7 batches at τ = 1, 4 at τ = 2,
    the last padded, bit for bit (the evaluated frames too)."""
    cfg, _, pairs = steps
    frames = _frames(13, kind, seed=tau)
    want = _fresh_pairs(cfg, pairs, frames, tau)
    got = evaluate_snippet(cfg, _slowed(pairs, SHORT), frames, tau=tau,
                           im_hw=EXTENT)
    if tau > 1:
        *got, ts = got
        assert ts == list(range(0, 13, tau))
    _same(got, want)


def _echo_step(f: int, device):
    """A step whose outputs are the chunk it was given, as the card
    received it: boxes and scores from frames 0..f-2, tracked from
    1..f-1, in float32 (exact for uint8, float32 and bfloat16)."""
    def step(x, im_hw, scale=1.0):
        y = x.to(device, non_blocking=True).float().reshape(f, 1, -1)
        return PairOutputs(y[:-1].reshape(f - 1, 1, -1, 4), y[:-1],
                           y[:-1] > 0, y[1:].reshape(f - 1, 1, -1, 4))
    step.frames_per_chunk, step.device = f, device
    return step


def test_float_frames_are_cast_to_the_compute_dtype_in_their_slot(steps):
    """Under a bfloat16 model, float32 frames reach the card as the fresh
    loop's cast made them, bit for bit, chunk after chunk of a 7-chunk
    snippet and of the snippet after it (the same slots again)."""
    cfg, _, _ = steps
    cfg = cfg.replace(model=cfg.model.replace(dtype="bfloat16"))
    step = _echo_step(CHUNK, torch.device("cuda"))
    for seed in (0, 1):
        frames = _frames(20, "float32", seed=seed)
        want = _fresh_video(cfg, step, frames)
        got = evaluate_snippet_video(cfg, _slowed(step, SHORT), frames,
                                     im_hw=EXTENT)
        _same(got, want)
        assert torch.from_numpy(frames).to(torch.bfloat16).float().numpy(
        ).tobytes() != frames.tobytes()      # the cast changed the frames


def test_video_driver_keeps_the_card_busy_while_it_gathers(steps):
    """With the card far behind the host, the stream still has work when
    a chunk's call comes from a snippet's fourth chunk on (the fresh
    loop's ``.cpu()`` drained it there); recorded, every chunk went
    through a slot and nothing was pinned to be uploaded."""
    cfg, video, _ = steps
    frames = _frames(20, "uint8")                      # 7 chunks
    evaluate_snippet_video(cfg, video, frames, im_hw=EXTENT)   # captures
    torch.cuda.synchronize()
    slow = _slowed(video, LONG)
    with recording() as rec:
        evaluate_snippet_video(cfg, slow, frames, im_hw=EXTENT)
    assert slow.idle[0] and not any(slow.idle[3:]), slow.idle
    assert len(slow.idle) == 7
    assert rec.counts["video.staged"] == rec.counts["video.chunks"] == 7
    assert rec.counts.get("program.pinned_bytes", 0) == 0
    fetches = rec.named("video.fetch")
    assert len(fetches) == 7
    assert all(rec.spans[s.parent].name == "video.snippet" for s in fetches)

    fresh = _slowed(video, LONG)     # the loop before: drained from 4 on
    _fresh_video(cfg, fresh, frames)
    assert fresh.idle[0] and all(fresh.idle[3:]), fresh.idle
