"""Hard synthetic VID: detector-breaking structure for the linking benchmark
(a copy of ``dtt.data.synthetic_hard``, so the port loads without JAX; the
same numpy seed gives the same snippets).

The clean generator (dtt/data/synthetic.py) saturated the accuracy gate
(flagship mAP 0.9969, linking uplift 0.0 — round-4 VERDICT missing #1): with
fully-visible high-contrast objects and zero clutter there is nothing for
tube rescoring to rescue. This module adds the failure modes the D&T paper's
linking/rescoring stage exists to fix (paper §3.4, Tables 2-3; the
test-path post-processing in SURVEY §3.3):

  * occlusion windows — each object fades to low visibility (alpha-blend
    toward the background) for a K-frame window; ground truth KEEPS the box
    (VID annotates occluded objects), so the detector's low-confidence /
    missed detections there cost recall unless a tube bridges the window
    and rescoring lifts the faint detections back up the ranking;
  * flickering distractors — short-lived (1-2 frame) half-transparent
    class-textured fragments that are NOT ground truth: temporally
    inconsistent false positives that out-rank degraded true detections
    until tube rescoring re-orders them;
  * noise bursts — single whole frames with strong additive Gaussian noise
    (sensor glitch / motion-blur stand-in) that depress every score in the
    frame at once;
  * confusable appearance — each object's texture is blended a random
    amount toward a different class's texture, eroding the >=70-channel
    class separation the clean lattice guarantees;
  * small objects — the size range reaches near the devkit size-adaptive
    IoU threshold scale.

Degradations are EVAL-SIDE only: training stays on the clean generator, so
an existing checkpoint can be evaluated at any hardness without retraining.
Everything that changes detector input leaves ground truth untouched — the
degradations manufacture ranking errors, not label noise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dtt_torch.data.synthetic import (_background, object_texture,
                                      sample_snippet_params)


@dataclass(frozen=True)
class Hardness:
    """Knobs for the hard generator; defaults target the no-link mAP
    0.6-0.85 operating point at flagship config (VERDICT round-4 task 3)."""

    occlusion_prob: float = 0.75        # per object: has a hard window
    occlusion_len: tuple = (2, 5)       # window length (frames, inclusive)
    visibility: tuple = (0.15, 0.45)    # alpha during the window
    noise_frac: float = 0.15            # fraction of frames with a burst
    noise_sigma: float = 30.0           # burst strength (uint8 levels)
    distractors: int = 8                # flickering fragments per snippet
    distractor_life: tuple = (1, 2)     # frames a fragment persists
    distractor_alpha: tuple = (0.5, 0.85)
    confusion_mix: tuple = (0.0, 0.35)  # texture blend toward another class
    size_range: tuple = (0.06, 0.35)    # object size as canvas fraction


def _draw_blended(img: np.ndarray, box, cls: int, alpha: float,
                  mix_cls: int | None = None, mix: float = 0.0):
    """Alpha-blend a (possibly class-blended) texture patch onto the canvas.

    alpha=1, mix=0 reproduces the clean generator's _draw_object exactly
    (same round/clamp/clip rules) — parity-tested."""
    x1, y1, x2, y2 = [int(round(float(v))) for v in box]
    h, w = img.shape[:2]
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, w - 1), min(y2, h - 1)
    if x2 <= x1 or y2 <= y1:
        return
    yy = np.arange(y1, y2 + 1, dtype=np.float32)[:, None]
    xx = np.arange(x1, x2 + 1, dtype=np.float32)[None, :]
    patch = object_texture(cls, yy, xx)
    if mix > 0.0 and mix_cls is not None:
        patch = (1.0 - mix) * patch + mix * object_texture(mix_cls, yy, xx)
    if alpha < 1.0:
        bg = img[y1:y2 + 1, x1:x2 + 1].astype(np.float32)
        patch = alpha * patch + (1.0 - alpha) * bg
    img[y1:y2 + 1, x1:x2 + 1] = np.clip(np.round(patch), 0, 255)


def sample_hard_snippet(rng: np.random.RandomState, num_frames: int,
                        height: int, width: int, num_classes: int,
                        max_gt: int, num_objects: int = 3,
                        max_step: float = 6.0,
                        hard: Hardness = Hardness()):
    """Scene + degradation plan (no pixels). Returns (gt_boxes (T, G, 4),
    gt_labels (G,), gt_valid (T, G), plan dict).

    Geometry/classes come from the clean constant-velocity sampler so the
    motion model matches training; the plan records per-object visibility
    per frame, the confusion blend, distractor tracks, and noise frames.
    """
    t_len = num_frames
    gt_boxes, gt_labels, gt_valid = sample_snippet_params(
        rng, num_frames, height, width, num_classes, max_gt, num_objects,
        max_step)
    n = int(gt_valid[0].sum())

    # re-draw object sizes over the wider hard range (incl. near-threshold
    # small objects) keeping each track's center path
    lo, hi = hard.size_range
    for i in range(n):
        bw = rng.uniform(width * lo, width * hi)
        bh = rng.uniform(height * lo, height * hi)
        cx = (gt_boxes[:, i, 0] + gt_boxes[:, i, 2]) / 2
        cy = (gt_boxes[:, i, 1] + gt_boxes[:, i, 3]) / 2
        gt_boxes[:, i, 0] = np.clip(cx - bw / 2, 0, width - 1)
        gt_boxes[:, i, 2] = np.clip(cx + bw / 2, 0, width - 1)
        gt_boxes[:, i, 1] = np.clip(cy - bh / 2, 0, height - 1)
        gt_boxes[:, i, 3] = np.clip(cy + bh / 2, 0, height - 1)

    visibility = np.ones((t_len, max_gt), np.float32)
    for i in range(n):
        if rng.uniform() < hard.occlusion_prob and t_len > 2:
            length = min(rng.randint(hard.occlusion_len[0],
                                     hard.occlusion_len[1] + 1), t_len - 2)
            t0 = rng.randint(1, t_len - length)   # never frame 0 / last
            visibility[t0:t0 + length, i] = rng.uniform(*hard.visibility)

    confusion = np.zeros((max_gt,), np.float32)
    confuse_cls = np.zeros((max_gt,), np.int32)
    for i in range(n):
        confusion[i] = rng.uniform(*hard.confusion_mix)
        other = rng.randint(1, num_classes - 1)
        confuse_cls[i] = other + (other >= gt_labels[i])  # != own class

    distractors = []                      # (t0, life, box, cls, alpha)
    for _ in range(hard.distractors):
        life = rng.randint(hard.distractor_life[0],
                           hard.distractor_life[1] + 1)
        t0 = rng.randint(0, max(t_len - life, 1))
        dw = rng.uniform(width * 0.04, width * 0.12)
        dh = rng.uniform(height * 0.04, height * 0.12)
        x1 = rng.uniform(0, width - dw - 1)
        y1 = rng.uniform(0, height - dh - 1)
        distractors.append((t0, life,
                            np.array([x1, y1, x1 + dw, y1 + dh], np.float32),
                            rng.randint(1, num_classes),
                            rng.uniform(*hard.distractor_alpha)))

    n_noise = int(round(hard.noise_frac * t_len))
    noise_ts = (rng.choice(t_len, size=n_noise, replace=False)
                if n_noise else np.zeros(0, np.int64))
    noise_seeds = rng.randint(1 << 31, size=n_noise)

    plan = {"visibility": visibility, "confusion": confusion,
            "confuse_cls": confuse_cls, "distractors": distractors,
            "noise_ts": noise_ts, "noise_seeds": noise_seeds}
    return gt_boxes, gt_labels, gt_valid, plan


def render_hard_snippet(rng: np.random.RandomState, gt_boxes, gt_labels,
                        gt_valid, plan, height: int, width: int,
                        hard: Hardness = Hardness(), uint8: bool = True):
    """Render the planned snippet: (T, H, W, 3) uint8 canvases (or their
    exact float32 cast). Draw order: objects (visibility-blended), then
    distractor fragments, then noise bursts — so distractors can partially
    cover objects like real clutter."""
    t_len = gt_boxes.shape[0]
    images = _background(rng, (t_len, height, width, 3))
    vis = plan["visibility"]
    for t in range(t_len):
        for g in range(gt_boxes.shape[1]):
            if gt_valid[t, g]:
                _draw_blended(images[t], gt_boxes[t, g], int(gt_labels[g]),
                              float(vis[t, g]), int(plan["confuse_cls"][g]),
                              float(plan["confusion"][g]))
        for (t0, life, dbox, dcls, dalpha) in plan["distractors"]:
            if t0 <= t < t0 + life:
                _draw_blended(images[t], dbox, int(dcls), float(dalpha))
    for t, seed in zip(plan["noise_ts"], plan["noise_seeds"]):
        gen = np.random.default_rng(int(seed))
        noise = gen.normal(0.0, hard.noise_sigma, images[int(t)].shape)
        images[int(t)] = np.clip(
            images[int(t)].astype(np.float32) + noise.astype(np.float32),
            0, 255).astype(np.uint8)
    if not uint8:
        images = images.astype(np.float32)
    return images


def synthetic_hard_snippet(rng: np.random.RandomState, num_frames: int,
                           height: int, width: int, num_classes: int,
                           max_gt: int, num_objects: int = 3,
                           max_step: float = 6.0,
                           hard: Hardness = Hardness(), uint8: bool = True):
    """One hard snippet: images (T, H, W, 3), gt_boxes (T, G, 4),
    gt_labels (G,), gt_valid (T, G). Same contract as synthetic_snippet."""
    gt_boxes, gt_labels, gt_valid, plan = sample_hard_snippet(
        rng, num_frames, height, width, num_classes, max_gt, num_objects,
        max_step, hard)
    images = render_hard_snippet(rng, gt_boxes, gt_labels, gt_valid, plan,
                                 height, width, hard, uint8)
    return images, gt_boxes, gt_labels, gt_valid
