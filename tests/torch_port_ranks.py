"""Run a function on several gloo ranks on the CPU, one process each, for
the data-parallel tests of dtt_torch (tests/test_torch_port_parallel.py).

Imports torch and dtt_torch only, so a spawned rank starts without JAX.
``run_ranks(fn, world, tmp, payload)`` starts `world` spawned processes
that join one gloo group over a ``file://`` store under `tmp` (no port,
so parallel test workers never race), calls ``fn(mesh, payload)`` in
each and returns the ranks' results in rank order.
"""

from __future__ import annotations

import os

import torch
import torch.multiprocessing as mp


def _entry(rank: int, world: int, tmp: str, fn, payload_path: str) -> None:
    import torch.distributed as dist

    from dtt_torch.parallel import data_mesh, initialize_distributed

    torch.set_num_threads(2)
    initialize_distributed(init_method=f"file://{tmp}/store",
                           world_size=world, rank=rank, device="cpu")
    try:
        mesh = data_mesh("cpu")
        out = fn(mesh, torch.load(payload_path, weights_only=False))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp, payload) -> list:
    """``fn(mesh, payload)`` on `world` gloo ranks; their results."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    payload_path = os.path.join(tmp, "payload.pt")
    torch.save(payload, payload_path)
    mp.start_processes(_entry, args=(world, tmp, fn, payload_path),
                       nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------------ jobs

def _train(mesh, p) -> dict:
    """One parallel train step from the payload's tree on this rank's
    rows of the global batch and draws: the decisions of the rank's pairs
    (before the step), the global metrics and the updated state."""
    from dtt_torch.models import dnt
    from dtt_torch.train import losses, trainer

    cfg = p["train_cfg"]
    model, state = trainer.create_train_state(cfg, "cpu", tree=p["tree"])
    state = trainer.replicate_tree(state, mesh)
    batch = trainer.shard_batch(p["batch"], mesh)
    draws = trainer.shard_draws(p["draws"], mesh)
    anchors = torch.from_numpy(p["anchors"])
    with torch.no_grad():
        tb = trainer.batch_to_device(batch, torch.device("cpu"))
        feats, _ = losses.forward_heads(cfg, model, tb)
        asg = losses.assign_targets(cfg, feats, anchors, tb, draws)
        cls, bbox = (dnt.pool_vote_batched(cfg.model, m, asg.rois.rois,
                                           1 / 16, "direct")
                     for m in (feats.cls_maps, feats.bbox_maps))
        sel = losses._rfcn_losses(cfg, cls, bbox, asg.rois)[3]
    decisions = dict(anchor_labels=asg.anchors.labels,
                     proposal_valid=asg.proposals.valid,
                     proposal_rois=asg.proposals.rois,
                     roi_labels=asg.rois.labels, roi_valid=asg.rois.valid,
                     ohem_sel=sel)
    step = trainer.make_parallel_train_step(cfg, model, p["feat_hw"], mesh)
    state, metrics = step(state, batch, draws)
    return dict(decisions=decisions,
                metrics={k: v.item() for k, v in metrics.items()},
                state={k: v.clone() for k, v in model.state_dict().items()},
                step=state.step, allreduce_bytes=step.allreduce_bytes(state))


def _eval(mesh, p) -> dict:
    """Per pooling mode: the parallel video step on one chunk at each
    frames-a-rank, the parallel snippet drivers (tau=1 video, tau=2
    pairs) and the wrapped pair of a 2-a-rank chunk."""
    from dtt_torch.eval import inference as inf

    out = {}
    im_hw = torch.tensor(p["im_hw"], dtype=torch.float32)
    from dtt_torch.utils.params import from_jax_params

    for mode, cfg in p["eval_cfgs"].items():
        model = from_jax_params(p["eval_trees"][mode], cfg.model,
                                device="cpu")
        for fpd in (1, 2):
            step = inf.make_video_step_parallel(cfg, model, mesh, fpd)
            chunk = torch.from_numpy(p["frames"][:step.frames_per_chunk])
            out[mode, "chunk", fpd] = [x.numpy() for x in step(chunk, im_hw)]
            out[mode, "video", fpd] = inf.evaluate_snippet_video(
                cfg, step, p["frames"], im_hw=p["im_hw"])
        pair = inf.make_pair_step_parallel(cfg, model, mesh, 2)
        out[mode, "pair"] = inf.evaluate_snippet(cfg, pair, p["frames"],
                                                 tau=2, im_hw=p["im_hw"])
    return out


def _train_main(mesh, p) -> None:
    """train_torch.main on this rank (the group is the caller's)."""
    import train_torch
    train_torch.main(p["train_argv"], device="cpu")


def record_render_run(argv) -> dict:
    """train_torch.main(argv) on the CPU (a --device-render run),
    recording the global draws of every step (``sample_draws``) and the
    initial seed of the generator each step's canvases came from."""
    import train_torch
    from dtt_torch.data import device_synth
    from dtt_torch.models import targets

    draws, seeds = [], []
    sample, make = targets.sample_draws, device_synth.make_pair_render_fn

    def sample_draws(*a, **k):
        d = sample(*a, **k)
        draws.append([x.clone() for x in d])
        return d

    def make_pair_render_fn(*a, **k):
        fn = make(*a, **k)

        def render(batch, generator):
            seeds.append(generator.initial_seed())
            return fn(batch, generator)
        return render

    targets.sample_draws = sample_draws
    device_synth.make_pair_render_fn = make_pair_render_fn
    try:
        train_torch.main(argv, device="cpu")
    finally:
        targets.sample_draws, device_synth.make_pair_render_fn = sample, make
    return dict(draws=draws, seeds=seeds)


def parallel_jobs(mesh, p) -> dict:
    """Every job the parallel tests hold against their references, in one
    start of the ranks."""
    out = dict(rank=mesh.rank, size=mesh.size, train=_train(mesh, p),
               eval=_eval(mesh, p))
    _train_main(mesh, p)
    out["render"] = record_render_run(p["render_argv"])
    return out
