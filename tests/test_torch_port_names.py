"""dtt_torch's public names against dtt's, and the small pieces that ride
with them, held against dtt on the CPU: ``pool_vote_batched``'s default
pool, the single-class ``link_tubes``, ``read_metrics`` and
``MetricLogger.log(prefix=)``, and the timing helpers on the CPU."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtt.core.config import Config as JConfig
from dtt.eval.linking import link_tubes as j_link_tubes
from dtt.models import dnt as jdnt

from dtt_torch.core import config as tcfg
from dtt_torch.eval.linking import link_tubes
from dtt_torch.models import dnt as tdnt

SUBPACKAGES = ("core", "data", "eval", "models", "ops", "parallel", "train",
               "utils")
# names of a dtt subpackage's __all__ that the port leaves out, and why
EXCEPTIONS = {
    ("ops", "correlation"): "the dispatcher would shadow its module "
                            "dtt_torch.ops.correlation; import it from there",
    ("parallel", "global_mesh"): "a JAX (data, model) Mesh over the devices "
                                 "of one program; a process holds one "
                                 "device here",
    ("parallel", "replicated"): "a JAX NamedSharding; each rank holds its "
                                "own replica (replicate_tree broadcasts it)",
    ("parallel", "data_sharded"): "a JAX NamedSharding; each rank takes its "
                                  "rows (shard_batch)",
}
# and a dtt option the port leaves out: MetricLogger's TensorBoard mirror
# (``use_tensorboard``), which needs a package the card's machine lacks;
# the jsonl log is the record


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_public_names_match_dtt(sub):
    """Every name of each dtt subpackage's ``__all__`` imports from the
    matching dtt_torch subpackage and stands in its ``__all__``, except
    the EXCEPTIONS, each with its reason."""
    want = importlib.import_module(f"dtt.{sub}").__all__
    port = importlib.import_module(f"dtt_torch.{sub}")
    missing = [n for n in want if (sub, n) not in EXCEPTIONS
               and not (hasattr(port, n) and n in port.__all__)]
    assert not missing, missing
    for n in port.__all__:
        assert hasattr(port, n), n
    for (s, n), why in EXCEPTIONS.items():
        if s == sub:
            assert n in want and why


def test_pool_vote_batched_default_matches_dtt():
    """Called without `impl`, the port's ``pool_vote_batched`` pools as
    dtt's does (the gather form, float32 maps) at ``Config()`` (bf16
    compute, k=7), within 1e-5."""
    cfg_j, cfg_t = JConfig().model, tcfg.Config().model
    rng = np.random.RandomState(0)
    k, d, h, w = cfg_t.roi.ps_grid, 5, 12, 20
    maps = rng.randn(2, h, w, k * k * d).astype(np.float32)
    x1 = rng.uniform(0, 200, (2, 6))
    y1 = rng.uniform(0, 120, (2, 6))
    rois = np.stack([x1, y1, x1 + rng.uniform(16, 100, (2, 6)),
                     y1 + rng.uniform(16, 60, (2, 6))], -1).astype(np.float32)
    want = np.asarray(jdnt.pool_vote_batched(cfg_j, jnp.asarray(maps),
                                             jnp.asarray(rois), 1 / 16))
    got = tdnt.pool_vote_batched(cfg_t, torch.from_numpy(maps),
                                 torch.from_numpy(rois), 1 / 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("boost", ["mean_top_half", "mean", "max"])
def test_link_tubes_matches_dtt(boost):
    """One class's tubes: paths, validity and claims equal, path scores
    and rescored scores to 1e-6, with an empty frame bridged."""
    rng = np.random.RandomState(1)
    t, n = 6, 5
    xy = rng.uniform(0, 60, (t, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (t, n, 2))],
                           -1).astype(np.float32)
    tracked = (boxes + rng.randn(t, n, 4) * 2).astype(np.float32)
    scores = rng.uniform(0, 1, (t, n)).astype(np.float32)
    valid = rng.uniform(0, 1, (t, n)) < 0.7
    valid[3] = False
    want = j_link_tubes(jnp.asarray(boxes), jnp.asarray(scores),
                        jnp.asarray(tracked), jnp.asarray(valid),
                        max_tubes=4, score_boost=boost)
    got = link_tubes(*(torch.from_numpy(x) for x in (boxes, scores, tracked,
                                                     valid)),
                     max_tubes=4, score_boost=boost)
    for name in ("det_idx", "tube_valid", "det_in_tube"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("tube_score", "rescored"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert got.tube_valid.any()


def test_metric_log_prefix_and_read_metrics_match_dtt(tmp_path):
    """``log(step, metrics, prefix=)`` writes dtt's row (the wall time
    aside) and ``read_metrics`` reads both packages' files alike."""
    from dtt.utils.logging import MetricLogger as JLogger
    from dtt.utils.logging import read_metrics as j_read
    from dtt_torch.utils import MetricLogger, read_metrics
    rows = {}
    for name, cls in (("dtt", JLogger), ("port", MetricLogger)):
        log = cls(str(tmp_path / name), run_name="exp")
        log.log(1, {"total": 2.5})
        log.log(2, {"total": 1.0}, prefix="eval/")
        with open(log.path, "a") as f:
            f.write("\n")
        rows[name] = read_metrics(log.path)
        assert j_read(log.path) == rows[name]
    for a, b in zip(rows["dtt"], rows["port"]):
        a.pop("wall_time"), b.pop("wall_time")
        assert a == b
    assert rows["port"][1] == {"step": 2, "exp": "exp", "eval/total": 1.0}


def test_timing_helpers_on_the_cpu(tmp_path):
    """The port's timing helpers (dtt.utils.timing and .profiling) run on
    CPU tensors: a round trip, a chained loop, the step timer's summary
    and an annotated block in a trace written for TensorBoard."""
    from dtt_torch.utils import (StepTimer, annotate, chained_time,
                                 device_trace, sync_latency)
    assert sync_latency(device="cpu") >= 0
    x = torch.randn(64, 64)
    per = chained_time(lambda c, m: c + (m @ m).sum() * 0, iters=3,
                       repeats=2, args=(x,), device="cpu")
    assert per >= 0
    timer = StepTimer(warmup=1)
    for _ in range(3):
        with timer.step(x @ x):
            pass
    s = timer.summary()
    assert s["steps"] == 2 and s["p50_s"] >= 0
    assert timer.time_fn(torch.mm, x, x, iters=2) >= 0
    with device_trace(str(tmp_path)):
        with annotate("block"):
            x @ x
    assert any(p.name.endswith(".json") for p in tmp_path.rglob("*"))
