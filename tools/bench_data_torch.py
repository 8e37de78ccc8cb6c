"""Time the port's data path on one card: where ``prepare_frame``'s host
time goes, and what the decode threads cost a loader-fed train step.

Writes a 1280 x 720 JPEG VID/DET tree (``tests/vid_tree.py``, as
``chip_smoke.py``'s data phase does), then prints one JSON line each for:

* ``frame``: one host thread over the val snippet's frames, the decode
  route's stages (PIL decode, the resize's taps, its horizontal and
  vertical gathers and float64 lerps, the mean and the canvas) beside the
  whole ``prepare_frame``;
* ``loader``: ``PairLoader`` alone at 1, 2 and 4 workers, pairs/s;
* ``train``: full-width steps (``Config()``, random weights from numpy
  seed 0) fed through ``device_prefetch`` by, in turn: host-rendered
  synthetic batches; the loader's first batches decoded beforehand
  (``predecoded``: no decode runs during the steps); the same with
  ``prepare_frame`` looping beside the steps in a thread of this process
  (``predecoded+decode_thread``) or in a process of its own
  (``predecoded+decode_process``), or with a second loader of 4 workers
  decoding into nothing (``predecoded+decode4``); and the live loader at
  1, 2 and 4 workers.
  Each: ms/step, the wait for batches, and the loader's host ms per pair
  while the steps ran.

``--dump DIR`` also writes, for two val frames, the JPEG bytes, PIL's
decode and the port's canvas (flipped and not) to ``DIR/decode.npz``;
``--compare DIR`` then holds them, on a machine with ``cv2`` and ``dtt``,
against ``cv2.imdecode`` and ``dtt``'s ``cv2`` route on the same bytes::

    python tools/bench_data_torch.py --dump chiprun_out/data   # the card
    python tools/bench_data_torch.py --compare chiprun_out/data
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12                 # timed steps a source, after one warm-up step
WORKERS = (1, 2, 4)
DET_FRACTION = 0.5


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def frame_split(paths, cfg) -> dict:
    """Host ms a frame by stage of the ``pil`` route, one thread; checks
    that the stages give ``prepare_frame``'s canvas."""
    from dtt_torch.data import transforms as t
    stages = dict.fromkeys(("decode", "taps", "gather_x", "lerp_x",
                            "gather_y", "lerp_y", "mean_canvas"), 0.0)
    means = np.asarray(cfg.pixel_means, np.float32)
    for p in paths:
        c = [time.perf_counter()]
        img = t._read_bgr_u8(p)
        c.append(time.perf_counter())
        h, w = img.shape[:2]
        scale = t.canvas_scale(h, w, cfg)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        x0, x1, fx = t._linear_taps(w, nw)
        y0, y1, fy = t._linear_taps(h, nh)
        c.append(time.perf_counter())
        p0, p1 = np.take(img, x0, axis=1), np.take(img, x1, axis=1)
        c.append(time.perf_counter())
        horiz = t._lerp(p0, p1, fx[None, :, None])
        c.append(time.perf_counter())
        q0, q1 = horiz[y0], horiz[y1]
        c.append(time.perf_counter())
        out = t._lerp(q0, q1, fy[:, None, None])
        c.append(time.perf_counter())
        out -= means
        canvas = np.zeros((cfg.canvas_height, cfg.canvas_width, 3), np.float32)
        canvas[:nh, :nw] = out
        c.append(time.perf_counter())
        for k, a, b in zip(stages, c, c[1:]):
            stages[k] += (b - a) * 1e3
        want, _ = t.prepare_frame(p, cfg)
        if not np.array_equal(canvas, want):
            raise AssertionError(f"the stages differ from prepare_frame: {p}")
    t0 = time.perf_counter()
    for p in paths:
        t.prepare_frame(p, cfg)
    whole = (time.perf_counter() - t0) * 1e3 / len(paths)
    n = len(paths)
    return {"frames": n, "prepare_frame_ms": whole,
            **{f"{k}_ms": v / n for k, v in stages.items()},
            "stages_sum_ms": sum(stages.values()) / n}


def decode_loop(paths, cfg, stop) -> None:
    """``prepare_frame`` over `paths` again and again until `stop` is set
    (a ``threading`` or ``multiprocessing`` event)."""
    from dtt_torch.data import transforms
    while not stop.is_set():
        for p in paths:
            transforms.prepare_frame(p, cfg)


class Beside:
    """``decode_loop`` running in a thread or in a spawned process while a
    run's steps go; ``stop()`` ends it."""

    def __init__(self, paths, cfg, process: bool):
        if process:
            import multiprocessing
            ctx = multiprocessing.get_context("spawn")
            self.event = ctx.Event()
            self.worker = ctx.Process(target=decode_loop,
                                      args=(paths, cfg, self.event))
        else:
            self.event = threading.Event()
            self.worker = threading.Thread(target=decode_loop, daemon=True,
                                           args=(paths, cfg, self.event))
        self.worker.start()
        if process:   # the child's imports and first frame, before timing
            time.sleep(10.0)

    def stop(self) -> None:
        self.event.set()
        self.worker.join(timeout=60)


class TimedPrepare:
    """``prepare_pair`` that adds its wall ms to a total a run can read."""

    def __init__(self):
        from dtt_torch.data.transforms import prepare_pair
        self.fn, self.lock = prepare_pair, threading.Lock()
        self.ms, self.pairs = 0.0, 0

    def __call__(self, entry, cfg):
        t0 = time.perf_counter()
        out = self.fn(entry, cfg)
        with self.lock:
            self.ms += (time.perf_counter() - t0) * 1e3
            self.pairs += 1
        return out

    def read(self) -> tuple[float, int]:
        with self.lock:
            out = self.ms, self.pairs
            self.ms, self.pairs = 0.0, 0
        return out


def card_run(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_data_torch: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import dtt_torch.data.imagenet_vid  # noqa: F401  (registers datasets)
    from dtt_torch.core.config import Config
    from dtt_torch.data import native, transforms
    from dtt_torch.data.imdb import combined_roidb
    from dtt_torch.data.loader import PairLoader, device_prefetch
    from dtt_torch.data.synthetic import synthetic_batch
    from dtt_torch.models.targets import sample_draws
    from dtt_torch.train.trainer import create_train_state, make_train_step
    from dtt_torch.utils.params import init_jax_params
    from chip_smoke import vid_tree_writer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()
    cfg = Config()
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    b, seed = cfg.train.batch_size_per_chip, cfg.train.seed
    emit({"card": card, "cpus": os.cpu_count(), "torch": torch.__version__})
    with tempfile.TemporaryDirectory() as root:
        counts = vid_tree_writer()(root, seed=0)
        val = os.path.join(root, "Data", "VID", "val", "snippet_000")
        paths = sorted(os.path.join(val, f) for f in os.listdir(val))
        route = transforms.frame_route(paths[0])
        transforms.prepare_frame(paths[0], cfg.input)
        emit({"frame": route, "native": native.unavailable_reason() or "built",
              **frame_split(paths, cfg.input)})
        if args.dump:
            dump(args.dump, paths[:2], cfg.input)

        roidb = combined_roidb("imagenet_vid_train+imagenet_det_train",
                               root=root, use_flipped=cfg.input.use_flipped)
        prepare = TimedPrepare()

        def loader(workers):
            return PairLoader(roidb, cfg.input, b, seed=seed,
                              num_workers=workers, prepare_fn=prepare,
                              det_fraction=DET_FRACTION)

        for k in WORKERS:
            ld = loader(k)
            it = iter(ld)
            next(it)
            prepare.read()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                next(it)
            dt = time.perf_counter() - t0
            ld.stop()
            ms, pairs = prepare.read()
            emit({"loader": k, "pairs_per_s": STEPS * b / dt,
                  "prepare_pair_ms": ms / max(pairs, 1), "tree": counts})

        ld = loader(4)
        predecoded = list(itertools.islice(iter(ld), STEPS + 2))
        ld.stop()
        model, state = create_train_state(cfg, "cuda", tree=init_jax_params(
            cfg.model, seed=0))
        step = make_train_step(cfg, model, (h // 16, w // 16))
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        cast = {"images": torch.bfloat16}
        rng = np.random.RandomState(seed)

        def synthetic():
            while True:
                yield synthetic_batch(rng, b, h, w, cfg.model.num_classes,
                                      cfg.input.max_gt_boxes,
                                      cfg.input.pixel_means, uint8=True,
                                      num_objects=cfg.input.synthetic_objects)

        def train(label, source, stop=()):
            nonlocal state
            stream = device_prefetch(source, "cuda", size=2, cast=cast)
            try:   # two warm-up steps: a program captures at the second
                for _ in range(2):
                    state, _ = step(state, next(stream),
                                    sample_draws(cfg, b, gen, "cuda"), gen)
                torch.cuda.synchronize()
                prepare.read()
                wait, losses = 0.0, []
                t0 = time.perf_counter()
                for _ in range(STEPS):
                    tw = time.perf_counter()
                    batch = next(stream)
                    wait += time.perf_counter() - tw
                    state, metrics = step(state, batch,
                                          sample_draws(cfg, b, gen, "cuda"),
                                          gen)
                    losses.append(metrics["total"])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                stream.close()
                for s in stop:
                    s.stop()
            ms, pairs = prepare.read()
            total = torch.stack(losses).float().cpu().numpy()
            if not np.isfinite(total).all():
                raise AssertionError(f"{label}: non-finite losses {total}")
            emit({"train": label, "ms_per_step": dt * 1e3 / STEPS,
                  "wait_ms_per_step": wait * 1e3 / STEPS,
                  "decoded_pairs": pairs,
                  "prepare_pair_ms": ms / pairs if pairs else None,
                  "card": card})

        def drained(workers):
            ld = loader(workers)
            threading.Thread(target=lambda: [None for _ in ld],
                             daemon=True).start()
            return ld

        train("warm-up (synthetic)", synthetic())
        train("synthetic", synthetic())
        train("predecoded", iter(predecoded))
        for process in (False, True):
            bg = Beside(paths, cfg.input, process)
            train("predecoded+decode_" + ("process" if process else "thread"),
                  iter(predecoded), stop=[bg])
        bg = drained(4)
        train("predecoded+decode4", iter(predecoded), stop=[bg])
        for k in WORKERS:
            ld = loader(k)
            train(f"loader{k}", iter(ld), stop=[ld])
        train("predecoded", iter(predecoded))
        train("synthetic", synthetic())
    return 0


def dump(out_dir: str, paths, cfg) -> None:
    """JPEG bytes, PIL's decode and the port's canvas of each frame."""
    from dtt_torch.data import transforms
    os.makedirs(out_dir, exist_ok=True)
    arrays = {}
    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            arrays[f"bytes{i}"] = np.frombuffer(f.read(), np.uint8)
        arrays[f"decode{i}"] = transforms._read_bgr_u8(p)
        for flip in (False, True):
            arrays[f"canvas{i}_{int(flip)}"] = transforms.prepare_frame(
                p, cfg, flip)[0]
    np.savez_compressed(os.path.join(out_dir, "decode.npz"), **arrays)


def compare(in_dir: str) -> int:
    """The card's PIL decode and canvases against cv2 and dtt's cv2 route
    (and this machine's PIL) on the same bytes; max abs differences."""
    import cv2
    from PIL import Image
    sys.path.insert(0, REPO)
    from dtt.core.config import InputConfig as JInputConfig
    from dtt.data import transforms as j_transforms
    data = np.load(os.path.join(in_dir, "decode.npz"))
    with tempfile.TemporaryDirectory() as d:
        for i in itertools.count():
            if f"bytes{i}" not in data:
                break
            path = os.path.join(d, f"{i}.JPEG")
            data[f"bytes{i}"].tofile(path)
            card = data[f"decode{i}"].astype(np.int32)
            with Image.open(path) as im:
                pil = np.asarray(im.convert("RGB"))[:, :, ::-1]
            rec = {"frame": i, "shape": list(card.shape),
                   "card_pil_vs_cv2": int(np.abs(
                       card - cv2.imread(path).astype(np.int32)).max()),
                   "card_pil_vs_local_pil": int(np.abs(
                       card - pil.astype(np.int32)).max()),
                   "cv2": cv2.__version__,
                   "local_pil": Image.__version__}
            for flip in (0, 1):
                want, _ = j_transforms.prepare_frame(
                    path, JInputConfig(), bool(flip), use_native=False)
                rec[f"canvas_vs_dtt_cv2_flip{flip}"] = float(np.abs(
                    data[f"canvas{i}_{flip}"] - want).max())
            emit(rec)
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dump", default=None,
                   help="write two frames' bytes, decode and canvases here")
    p.add_argument("--compare", default=None,
                   help="hold a --dump directory against cv2 and dtt")
    args = p.parse_args()
    if args.compare:
        return compare(args.compare)
    return card_run(args)


if __name__ == "__main__":
    sys.exit(main())
