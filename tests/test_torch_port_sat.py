"""dtt_torch's SAT pools (the ``dtt_psroi_sat`` and ``dtt_psroi_sat_mean``
kernels) on the CPU: the grouped route (1 to 4 tables a launch) against
the per-map plain versions, the per-frame pools of several maps against
one ``psroi_pool`` call each, and the kernel wrapper's argument checks.
``tests/test_torch_port_eval.py`` and ``tests/test_torch_port_frame.py``
hold the same pools against ``dtt``; ``tests/test_torch_port_gpu.py``
holds the kernels against these plain versions on a card.
"""

import numpy as np
import pytest
import torch

from dtt_torch.core.config import Config
from dtt_torch.models import dnt as tdnt
from dtt_torch.ops import psroi as tpsroi

PLAIN = {"mm_sums": tpsroi.psroi_mm_sums_plain,
         "mm_means": tpsroi.psroi_mm_means_plain,
         "sat_means": tpsroi.psroi_sat_means_plain}


def _rois(rng, b, n, h, w):
    """(b, n, 4) RoIs on a (16h, 16w) canvas: the whole map, one past the
    map (empty bins), one on .5 coordinates, and random boxes that may
    cross the map's edges."""
    xy = rng.uniform(-40, w * 16, (b, n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 200, (b, n, 2))], axis=-1)
    rois[:, 0] = [0, 0, w * 16 - 1, h * 16 - 1]
    if n > 2:
        rois[:, 1] = [w * 16 + 60, h * 16 + 40, w * 16 + 200, h * 16 + 90]
        rois[:, 2] = [40.5, 23.5, 72.5, 88.5]
    return torch.from_numpy(rois.astype(np.float32))


def _member(rng, b, h, w, k, d, n):
    """A (table, bounds) member: the SAT of random (b, h, w, k*k*d) maps
    and the bounds of `n` RoIs a frame."""
    maps = torch.from_numpy(rng.randn(b, h, w, k * k * d).astype(np.float32))
    bounds = [t.contiguous() for t in
              tpsroi.roi_bounds(_rois(rng, b, n, h, w), 1 / 16, k, h, w)]
    return tpsroi.sat(maps).contiguous(), bounds


# members that differ in frames, map size, k, D and RoIs, as one launch
# takes them: a frame's cls, bbox and track tables and a pair batch's
GROUP = [(1, 10, 14, 7, 31, 24), (1, 10, 14, 7, 8, 5), (2, 9, 13, 3, 4, 1),
         (3, 6, 7, 3, 43, 9)]


@pytest.mark.parametrize("form", sorted(PLAIN))
def test_sat_group_on_cpu_is_the_plain_version_per_member(form):
    """On CPU tensors the grouped route gives each member its form's plain
    version, to the bit, and counts no kernel launch."""
    rng = np.random.RandomState(0)
    members = [_member(rng, *spec) for spec in GROUP]
    before = (tpsroi.psroi_mm_sums_cuda.launches,
              tpsroi.psroi_sat_means_cuda.launches)
    outs = tpsroi.psroi_sat_group(form, members)
    assert (tpsroi.psroi_mm_sums_cuda.launches,
            tpsroi.psroi_sat_means_cuda.launches) == before
    for (table, bounds), (b, _, _, k, d, n), out in zip(members, GROUP, outs):
        assert out.shape == (b, n, k, k, d) and out.dtype == torch.float32
        assert torch.equal(out, PLAIN[form](table, *bounds))


def test_mm_means_plain_is_bin_means_of_the_plain_sums():
    """The mean mode's plain version is the division every other form does
    outside its sums, so ``psroi_pool_batched_pallas_mm`` keeps its bits."""
    rng = np.random.RandomState(1)
    table, bounds = _member(rng, 2, 10, 14, 7, 9, 24)
    sums = tpsroi.psroi_mm_sums_plain(table, *bounds)
    means = tpsroi.psroi_mm_means_plain(table, *bounds)
    assert torch.equal(means, tpsroi.bin_means(sums, *bounds))
    assert torch.equal(tpsroi.psroi_mm_means(table, *bounds), means)
    assert (means[:, 0] != 0).all() and (means[:, 1] == 0).all()


@pytest.mark.parametrize("impl", ["auto", "xla", "mm", "pallas_mm", "pallas"])
def test_psroi_pool_maps_is_psroi_pool_per_map(impl):
    """``psroi_pool_maps`` of several maps at the same RoIs gives each map
    the bits of its own ``psroi_pool`` call, and its gradient (the kernel
    forms' backward is the ``"xla"`` scatter-add per map; a scatter-add's
    order varies with the CPU's threads, so 1e-5 of the largest)."""
    rng = np.random.RandomState(2)
    h, w, k, n = 10, 14, 7, 24
    rois = _rois(rng, 1, n, h, w)[0]
    maps = [torch.from_numpy(rng.randn(h, w, k * k * d).astype(np.float32))
            for d in (31, 8, 4)]
    xs = [m.clone().requires_grad_() for m in maps]
    got = tpsroi.psroi_pool_maps(xs, rois, 1 / 16, k, impl)
    gos = [torch.from_numpy(rng.randn(*g.shape).astype(np.float32))
           for g in got]
    torch.autograd.backward(got, gos)
    for x, g, go in zip(xs, got, gos):
        y = x.detach().clone().requires_grad_()
        want = tpsroi.psroi_pool(y, rois, 1 / 16, k, impl)
        want.backward(go)
        assert torch.equal(g, want)
        torch.testing.assert_close(x.grad, y.grad, rtol=0,
                                   atol=1e-5 * y.grad.abs().max().item())


@pytest.mark.parametrize("impl", ["xla", "mm", "pallas_mm", "pallas"])
def test_rfcn_head_is_pool_vote_of_each_map(impl):
    """``rfcn_head`` pools its two maps together (one launch on a card
    under the kernel forms) and gives ``pool_vote``'s bits for each."""
    rng = np.random.RandomState(3)
    cfg = Config().model
    h, w, k = 10, 14, cfg.roi.ps_grid
    rois = _rois(rng, 1, 30, h, w)[0]
    cls, bbox = (torch.from_numpy(rng.randn(h, w, k * k * d).astype(
        np.float32)) for d in (cfg.num_classes, 8))
    got = tdnt.rfcn_head(cfg, cls, bbox, rois, 1 / 16, impl)
    want = (tdnt.pool_vote(cfg, cls, rois, 1 / 16, impl),
            tdnt.pool_vote(cfg, bbox, rois, 1 / 16, impl))
    assert len(got) == 2
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def _checked(defect: str):
    """A member (table, bounds) or member list with one defect, and the
    message the wrapper raises for it."""
    rng = np.random.RandomState(4)
    table, bounds = _member(rng, 2, 6, 7, 3, 5, 4)
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    cases = {
        "no member": ([], "1 to 4"),
        "five members": ([(table, bounds)] * 5, "1 to 4"),
        "dtype": ([(table.double(), bounds)], "float32"),
        "table dims": ([(table[0], bounds)], "float32"),
        "three bounds": ([(table, bounds[:3])], r"\(hs, he, ws, we\)"),
        "bounds frames": ([(table, [t[:1] for t in bounds])],
                          r"bounds must be \(B=2, N, k\)"),
        "bounds dtype": ([(table, [bounds[0].long(), *bounds[1:]])],
                         "four int32 tensors"),
        "bounds shapes": ([(table, [bounds[0][:, :2], *bounds[1:]])],
                          "four int32 tensors"),
        "channels": ([(table[..., :-1].contiguous(), bounds)],
                     "not divisible"),
        "k": ([(meta(1, 2, 2, 33 * 33),
                [meta(1, 1, 33, dt=torch.int32)] * 4)], "k=33 > 32"),
        "contiguity": ([(table.transpose(1, 2), bounds)], "contiguous"),
        "frame size": ([(meta(1, 2 ** 16, 2 ** 15, 1),
                         [meta(1, 1, 1, dt=torch.int32)] * 4)],
                       "< 2\\^31 elements"),
        "pairs": ([(meta(2 ** 16, 2, 2, 1),
                    [meta(2 ** 16, 2 ** 15, 1, dt=torch.int32)] * 4)],
                  "pairs in one launch"),
        "cpu": ([(table, bounds)], "one CUDA device"),
    }
    return cases[defect]


@pytest.mark.parametrize("form", sorted(PLAIN))
@pytest.mark.parametrize("defect", [
    "no member", "five members", "dtype", "table dims", "three bounds",
    "bounds frames", "bounds dtype", "bounds shapes", "channels", "k",
    "contiguity", "frame size", "pairs", "cpu"])
def test_sat_kernel_wrapper_checks_raise_by_name(form, defect):
    """Each argument check of the SAT kernel wrapper raises with its
    message before anything is launched, and counts no launch; the size
    limits are what the kernel's indexing holds (32-bit offsets inside a
    frame's table, a block per (frame, RoI) at most)."""
    members, message = _checked(defect)
    before = (tpsroi.psroi_mm_sums_cuda.launches,
              tpsroi.psroi_sat_means_cuda.launches)
    with pytest.raises((ValueError, TypeError), match=message):
        tpsroi.psroi_sat_group_cuda(form, members)
    assert (tpsroi.psroi_mm_sums_cuda.launches,
            tpsroi.psroi_sat_means_cuda.launches) == before
