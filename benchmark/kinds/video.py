"""Traffic kind ``video``: whole snippets through the program's video
step and tube linking, a closed loop with one client.

The traffic file gives blocks of snippet lengths; every seed runs the
same blocks, in an order drawn from the seed, each snippet a
contiguous slice of a pool of frames rendered on the device from the
seed (one scene of moving class-textured boxes inside the true image
extent) and held in host memory as decoded uint8 canvases. A snippet goes
through ``evaluate_snippet_video`` over the step of ``make_video_step``
(chunks of ``chunk`` frames overlapping by one, the last padded), then
``link_snippet`` on its detections. The window runs whole snippets until
the clock passes ``--seconds`` and ends on the last one's results.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from benchmark import judge, synth, weights as wts
from benchmark.reference import dnt as ref
from benchmark.reference import linking as rlink


def snippet_plan(traffic: dict, seed: int) -> list:
    """(length, offset in the pool) of every snippet, in run order: the
    traffic's blocks of lengths, ``rounds`` times over, the blocks and the
    lengths in each in an order drawn from the seed (every block holds
    about the same frames and chunks, so where a window ends matters
    little)."""
    rng = np.random.default_rng(seed)
    pool = traffic["pool_frames"]
    blocks = traffic["snippet_blocks"]
    out = []
    for _ in range(traffic["rounds"]):
        for b in rng.permutation(len(blocks)):
            for t in rng.permutation(blocks[b]):
                out.append((int(t), int(rng.integers(0, pool - t + 1))))
    return out


class Video:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.cfg, self.cd = ctx.cfg, ctx.cfg_dict
        self.im_hw = tuple(self.tr["extent"])
        self.spans = ctx.spans
        self.dev = torch.device(getattr(ctx, "device", "cuda"))
        self.cuda = self.dev.type == "cuda"
        self.device_trace = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from dtt_torch.eval.inference import make_video_step
        from dtt_torch.models.dnt import make_model
        seed = self.ctx.seed
        marks = [("start", time.perf_counter())]
        w = wts.make_weights(self.cd["model"], seed, self.dev)
        self.model = make_model(self.cfg.model, self.dev)
        self.model.load_state_dict(w)
        # the reference's copy waits on the host until the check
        self.weights = {k: v.cpu() for k, v in w.items()}
        del w
        marks.append(("weights", time.perf_counter()))
        inp = self.cd["input"]
        gen = torch.Generator(device=self.dev).manual_seed(seed % 2**63)
        self.pool = synth.scene_frames(
            self.tr["pool_frames"], inp["canvas_height"], inp["canvas_width"],
            self.im_hw, self.tr["objects"], tuple(self.tr["object_size"]),
            self.tr["speed"], self.cd["model"]["num_classes"], gen, self.dev)
        marks.append(("frame pool", time.perf_counter()))
        self.plan = snippet_plan(self.tr, seed)
        self.anchors = ref.frame_anchors(self.cd, self.dev)
        self.step = make_video_step(self.cfg, self.model, self.tr["chunk"],
                                    device=self.dev)
        self.timed = self._timed_step(self.step)
        # warm-up: the step's one shape (capture), and linking at the
        # shortest and longest snippet of the traffic
        lengths = [t for b in self.tr["snippet_blocks"] for t in b]
        lo, hi = min(lengths), max(lengths)
        self._snippet(lo, 0, keep=False)
        out = self._snippet(self.tr["chunk"] + 1, 0, keep=True)
        reps = -(-hi // out["frames"])
        self._link(*(np.concatenate([x] * reps, axis=1)[:, :hi]
                     for x in (out["boxes"], out["scores"], out["tracked"],
                               out["valid"])))
        self._sync()
        marks.append(("warm-up and capture", time.perf_counter()))
        self.spans.spans.clear()
        print("set-up: " + ", ".join(
            f"{name} {b - a:.2f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])), file=sys.stderr)

    def _timed_step(self, step):
        spans = self.spans

        def timed(chunk, im_hw, scale=1.0):
            t0 = time.perf_counter()
            out = step(chunk, im_hw, scale)
            spans.add("dispatch", t0, time.perf_counter())
            return out

        timed.frames_per_chunk = step.frames_per_chunk
        timed.device = step.device
        return timed

    def _annotate(self, name: str):
        if self.device_trace is None or self.device_trace.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    def _link(self, boxes, scores, tracked, valid):
        from dtt_torch.eval.inference import link_snippet
        t0 = time.perf_counter()
        with self._annotate("link"):
            rescored, tubes = link_snippet(self.cfg, boxes, scores, tracked,
                                           valid, device=self.dev)
        self.spans.add("link", t0, time.perf_counter())
        return rescored, tubes

    def _snippet(self, length: int, offset: int, keep: bool) -> dict:
        from dtt_torch.eval.inference import evaluate_snippet_video
        frames = self.pool[offset:offset + length]
        with self._annotate("snippet"):
            boxes, scores, valid, tracked = evaluate_snippet_video(
                self.cfg, self.timed, frames, im_hw=self.im_hw)
        rescored, tubes = self._link(boxes, scores, tracked, valid)
        out = {"frames": length, "offset": offset}
        if keep:
            out.update(boxes=boxes, scores=scores, valid=valid,
                       tracked=tracked, rescored=rescored,
                       det_in_tube=tubes.det_in_tube)
        return out

    # ------------------------------------------------------------ window
    def window(self, seconds: float, trace: bool) -> dict:
        from benchmark.trace import DeviceTrace
        self.peak_setup = self._peak()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.done = []
        stretch = self.tr["trace_stretch"]
        t0 = time.perf_counter()
        i = 0
        while True:
            now = time.perf_counter() - t0
            if trace and self.device_trace is None and now >= stretch[0] * seconds:
                self.device_trace = DeviceTrace()
                self.device_trace.start()
            elif (trace and self.device_trace is not None
                  and self.device_trace.prof is not None
                  and time.perf_counter() - self.device_trace.t0
                  >= stretch[1]):
                self.device_trace.stop()
            length, offset = self.plan[i % len(self.plan)]
            s0 = time.perf_counter()
            self.done.append(self._snippet(length, offset, keep=True))
            self.spans.add("snippet", s0, time.perf_counter())
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        if self.device_trace is not None and self.device_trace.prof is not None:
            self.device_trace.stop()
        self.peak_window = self._peak()
        self.peak_bytes = max(self.peak_setup, self.peak_window)
        frames = sum(d["frames"] for d in self.done)
        failed = sum(not self._well_formed(d) for d in self.done)
        self.window_s = window_s
        host = {k: sum(e - s for s, e in self.spans.spans[k])
                for k in ("dispatch", "link")}
        print(f"window: {window_s:.2f} s, {len(self.done)} snippets, "
              f"{len(self.spans.spans['dispatch'])} chunks, host s in the "
              f"step's calls {host['dispatch']:.2f}, in linking "
              f"{host['link']:.2f}", file=sys.stderr)
        return {"window_s": window_s, "attempted": len(self.done),
                "failed": failed, "pairs": frames,
                "chunks": len(self.spans.spans["dispatch"]),
                "end_to_end": {"video_pairs_per_s": frames / window_s}}

    def _peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def _well_formed(self, d: dict) -> bool:
        c = self.cd["model"]["num_classes"] - 1
        m = self.cd["eval"]["max_per_class"]
        t = d["frames"]
        return (d["boxes"].shape == (c, t, m, 4)
                and d["scores"].shape == (c, t, m)
                and d["valid"].shape == (c, t, m)
                and bool(np.isfinite(d["boxes"]).all())
                and bool(np.isfinite(d["scores"]).all()))

    def release(self) -> None:
        """Frees the program: the reference runs on an empty card."""
        del self.timed, self.step, self.model
        self._sync()
        if self.cuda:
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def sample(self) -> tuple:
        """(pairs, snippets) to check, drawn from the seed: ``check_chunks``
        chunks, ``check_pairs_per_chunk`` pairs of each, the longest
        snippet's last chunk always among them; ``check_snippets``
        snippets' linking, the longest always among them."""
        rng = np.random.default_rng(self.ctx.seed + 1)
        f = self.tr["chunk"]
        chunks = [(i, s) for i, d in enumerate(self.done)
                  for s in range(0, d["frames"], f - 1)]
        longest = max(range(len(self.done)),
                      key=lambda i: self.done[i]["frames"])
        last = (longest, max(s for i, s in chunks if i == longest))
        rest = [c for c in chunks if c != last]
        n = min(self.tr["check_chunks"] - 1, len(rest))
        picked = [last] + [rest[j] for j in rng.choice(len(rest), n,
                                                       replace=False)]
        pairs = []
        for i, s in picked:
            real = min(f - 1, self.done[i]["frames"] - s)
            ts = rng.choice(real, min(self.tr["check_pairs_per_chunk"], real),
                            replace=False)
            pairs.append((i, s, sorted(int(t) for t in ts)))
        others = [i for i in range(len(self.done)) if i != longest]
        k = min(self.tr["check_snippets"] - 1, len(others))
        snips = [longest] + [int(j) for j in rng.choice(others, k,
                                                       replace=False)]
        return pairs, snips

    def program_states(self, pairs: list) -> list:
        """The trunk program's outputs (``ref.TRUNK_MAPS``, numpy) for
        each sampled pair's two frames, the chunk run again through the
        step and then through its trunk program, whose buffers hold them;
        and the largest difference of the rerun's outputs from the
        window's."""
        trunk = self.step.programs[0]
        f = self.tr["chunk"]
        hw = torch.tensor(self.im_hw, dtype=torch.float32, device=self.dev)
        states, rerun = [], 0.0
        for i, s, ts in pairs:
            d = self.done[i]
            frames = self.pool[d["offset"]:d["offset"] + d["frames"]]
            idxs = [min(j, len(frames) - 1) for j in range(s, s + f)]
            chunk = torch.from_numpy(np.stack([frames[j] for j in idxs]))
            out = self.step(chunk, hw)
            feats = trunk(chunk, hw)
            maps = {"rpn_cls": feats.rpn_cls, "rpn_bbox": feats.rpn_bbox,
                    "reduced": feats.reduced, "c3": feats.corr_feats["c3"],
                    "c4": feats.corr_feats["c4"]}
            for t in ts:
                # the chunk's frame t + 1 is the pair's second frame (the
                # last frame repeated at a snippet's end)
                states.append([{k: v[j].float().cpu().numpy()
                                for k, v in maps.items()}
                               for j in (t, t + 1)])
                for name, x in zip(("boxes", "scores", "valid", "tracked"),
                                   out):
                    a = x[t].float().cpu().numpy()
                    b = d[name][:, s + t].astype(np.float32)
                    rerun = max(rerun, float(np.abs(a - b).max()))
        return states, rerun

    def check(self) -> dict:
        """The judged numbers of this run (the program freed between the
        rerun of its trunk and the reference), with ``rerun``: the
        largest difference of the sampled chunks' rerun, whose trunk
        state the judge reads, from the window's outputs."""
        self.pairs, self.snips = self.sample()
        states, rerun = self.program_states(self.pairs)
        self.release()
        return dict(self.judge(self.pairs, self.snips, states), rerun=rerun)

    def control(self) -> dict:
        """The control's numbers on the sample that ``check`` judged: the
        plain reference in float8 in the program's place (its own trunk,
        proposals and detections, and its linking in float8 of the
        window's detections). The reference is computed afresh, so it has
        no rerun to differ from (``rerun`` 0)."""
        states, outs = self.control_outputs(self.pairs)
        return dict(self.judge(self.pairs, self.snips, states,
                               outputs=outs, link_q=ref.Precision("fp8")),
                    rerun=0.0)

    def judge(self, pairs: list, snips: list, states: list, outputs=None,
              link_q=None) -> dict:
        """The numbers of ``benchmark/judge.py`` over the sample: the
        window's outputs, or `outputs` (one dict a pair) in their place;
        tube linking judged on the window's detections of the snippets
        `snips`, linked by the program or, with `link_q`, by the
        reference in that precision."""
        w = {k: v.to(self.dev) for k, v in self.weights.items()}
        trunk, gaps = 0.0, {"score": [], "box": [], "missed": []}
        n = 0
        for i, s, ts in pairs:
            d = self.done[i]
            frames = self.pool[d["offset"]:d["offset"] + d["frames"]]
            for t in ts:
                out = (outputs[n] if outputs is not None else
                       {k: d[k][:, s + t] for k in ("boxes", "scores",
                                                    "valid", "tracked")})
                r = self._judge_pair(w, frames, s + t, states[n], out)
                n += 1
                trunk = max(trunk, r["trunk_err"])
                for k, v in gaps.items():
                    v.append(r[k])
        score, box, missed = (np.concatenate(gaps[k]) for k in
                              ("score", "box", "missed"))
        stat = lambda x, f: float(f(x)) if len(x) else 0.0
        return {"trunk_err": trunk, "box_err": stat(box, np.mean),
                "score_err": stat(score, lambda x: np.quantile(x, 0.9)),
                "missed_share": stat(missed, np.mean),
                "link_gap": max([self._judge_link(self.done[i], link_q)
                                 for i in snips], default=0.0)}

    def _judge_pair(self, w, frames, t, state, out) -> dict:
        """One pair's trunk_err and per-detection gaps: `state` is the
        trunk output for the pair's two frames (``ref.TRUNK_MAPS``, numpy)
        of the side judged, which the reference's heads, proposals and
        per-class NMS take in place of its own trunk's."""
        mine, r = ref.pair(self.cd, w, frames, t, self.im_hw,
                           ref.Precision(), self.anchors, given=state)
        r = {k: v.numpy() for k, v in r.items()}
        gaps = judge.pair_gaps(out, r, self.cd["eval"]["nms_thresh"])
        return {"trunk_err": max(judge.trunk_err(g, m)
                                 for g, m in zip(state, mine)), **gaps}

    def _link_ref(self, d: dict, q) -> dict:
        ev = self.cd["eval"]
        args = [torch.from_numpy(d[k]).to(self.dev) for k in
                ("boxes", "scores", "tracked", "valid")]
        out = rlink.link(*args, ev["max_tubes_per_class"],
                         ev["link_iou_weight"], ev["tube_score_boost"], q)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _judge_link(self, d: dict, q=None) -> float:
        """The program's linking of `d` (or, with `q`, the reference's in
        that precision: the control) against the float32 reference's."""
        want = self._link_ref(d, lambda x: x)
        got = d if q is None else self._link_ref(d, q)
        return judge.link_gap(got, want)

    # ------------------------------------------------------------ control
    def control_outputs(self, pairs: list) -> tuple:
        """The control in the program's place: the reference in float8
        (``Precision("fp8")``) on each sampled pair, its own trunk state
        and its detections from it."""
        w = {k: v.to(self.dev) for k, v in self.weights.items()}
        q = ref.Precision("fp8")
        states, outs = [], []
        for i, s, ts in pairs:
            d = self.done[i]
            frames = self.pool[d["offset"]:d["offset"] + d["frames"]]
            for t in ts:
                feats, r = ref.pair(self.cd, w, frames, s + t, self.im_hw,
                                    q, self.anchors)
                states.append(feats)
                outs.append({k: r[k].numpy() for k in
                             ("boxes", "scores", "valid", "tracked")})
        return states, outs


def make(ctx) -> Video:
    return Video(ctx)
