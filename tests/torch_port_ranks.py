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


def _exact(a, b) -> bool:
    """Bit for bit (float32 by its bits), and the same dtype and shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _train_program(mesh, p) -> dict:
    """The parallel train program over the payload's steps (a rate change
    among them) from the payload's tree, then the same steps by
    ``step.eager`` from the tree again: the program's metrics of each
    step, state and momentum buffers (as flax trees' leaves in order),
    and which metrics, parameters and buffers of the two forms differ."""
    from dtt_torch.train import trainer

    cfg = p["train3_cfg"]
    runs = []
    for form in ("program", "eager"):
        model, state = trainer.create_train_state(cfg, "cpu", tree=p["tree"])
        state = trainer.replicate_tree(state, mesh)
        step = trainer.make_parallel_train_step(cfg, model, p["feat_hw"],
                                                mesh)
        fn = step if form == "program" else step.eager
        metrics = []
        for batch, draws in zip(p["batches3"], p["draws3"]):
            state, m = fn(state, trainer.shard_batch(batch, mesh),
                          trainer.shard_draws(draws, mesh))
            metrics.append(m)
        runs.append((metrics, state))
    (mp, sp), (me, se) = runs
    params = lambda s: list(s.model.state_dict().items())
    bufs = lambda s: [x["momentum_buffer"]
                      for x in s.optimizer.state.values()]
    differ = [f"step {i} {k}" for i, (a, b) in enumerate(zip(mp, me))
              for k in a if not _exact(a[k], b[k])]
    differ += [k for (k, a), (_, b) in zip(params(sp), params(se))
               if not _exact(a, b)]
    differ += [f"momentum {i}" for i, (a, b) in enumerate(zip(bufs(sp),
                                                                 bufs(se)))
               if not _exact(a, b)]
    return dict(metrics=[{k: v.item() for k, v in m.items()} for m in mp],
                state={k: v.clone() for k, v in params(sp)},
                step=sp.step, differ=differ, n_bufs=len(bufs(sp)))


def _eval_grid(mesh, p) -> dict:
    """Per pooling mode, the parallel video program (1 and 2 frames a
    rank) and pair program (the payload's pairs, 2 a rank) at each scale
    and extent of the payload, and whether each call's outputs equal ``step.eager``'s
    bit for bit."""
    from dtt_torch.eval import inference as inf
    from dtt_torch.utils.params import from_jax_params

    out, differ = {}, []
    for mode, cfg in p["eval_cfgs"].items():
        model = from_jax_params(p["eval_trees"][mode], cfg.model,
                                device="cpu")
        steps = {("video", fpd): inf.make_video_step_parallel(cfg, model,
                                                               mesh, fpd)
                 for fpd in (1, 2)}
        steps["pair", 2] = inf.make_pair_step_parallel(cfg, model, mesh, 2)
        for (kind, n), step in steps.items():
            x = torch.from_numpy(p["pairs"] if kind == "pair"
                                 else p["frames"][:mesh.size * n])
            for scale in p["scales"]:
                for hw in p["extents"]:
                    im_hw = torch.tensor(hw, dtype=torch.float32)
                    got = step(x, im_hw, scale)
                    want = step.eager(x, im_hw, scale)
                    out[mode, kind, n, scale, hw] = [a.numpy() for a in got]
                    differ += [(mode, kind, n, scale, hw, i) for i, (a, b)
                               in enumerate(zip(got, want))
                               if not _exact(a, b)]
    return dict(outputs=out, differ=differ)


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
               eval=_eval(mesh, p), train3=_train_program(mesh, p),
               grid=_eval_grid(mesh, p))
    _train_main(mesh, p)
    out["render"] = record_render_run(p["render_argv"])
    return out
