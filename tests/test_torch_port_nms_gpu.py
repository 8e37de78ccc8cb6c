"""The NMS kernel ``dtt_nms_select`` held against both plain forms on a
CUDA card, bit for bit: the four problem shapes of the port's paths (a
video chunk's and a train step's proposals, a chunk's per-class NMS,
OHEM) and the crafted cases of ``tests/nms_cases.py``, at select_block 1,
16, 32 and 48 (wider than a step of the kernel); walks past the first
1,024 positions (proposals at IoU 0.1, near-duplicate anchors); unsorted
proposals, the scratch layout (12,000 boxes and the most the kernel
takes), +0.0 against -0.0 in both orders (ranked first for
``nms_padded_fast``, tied for ``nms_padded``) and a score threshold below
-1e10; one launch a call; a call that cannot launch raises. Marked ``gpu``: they skip without a card. This file imports no
JAX:

    python -m pytest --noconftest -q tests/test_torch_port_nms_gpu.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from dtt_torch.ops import nms as tnms

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from nms_cases import (PATH_SHAPES, below_masked_problem,  # noqa: E402
                       crafted_cases, long_walk_problems, path_problem,
                       permuted, signed_zero_problem, walk_end)

pytestmark = pytest.mark.gpu

BLOCKS = (1, 16, 32, 48)
CASES = {c["name"]: c for c in crafted_cases()}
LONG = {c["name"]: c for c in long_walk_problems()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(c, device):
    return (torch.from_numpy(c["boxes"]).to(device),
            torch.from_numpy(c["scores"]).to(device), c["iou"], c["m"],
            torch.from_numpy(c["valid"]).to(device), c["score"])


def _check(c, block, device):
    """The kernel at width `block` in each order of the zeros against the
    plain form of that order: the total order against the block loop, the
    tied zeros against the one-at-a-time loop. Returns the first."""
    args = _on(c, device)
    before = tnms.nms_cuda.launches
    got = tnms.nms_padded_fast(*args, select_block=block)
    torch.cuda.synchronize()
    assert tnms.nms_cuda.launches == before + 1
    tied = tnms.nms_cuda(*args, select_block=block, total_order=False)
    fast = tnms.nms_padded_fast_plain(*args, select_block=block)
    slow = tnms.nms_padded_plain(*args)
    for have, want, form in ((got, fast, "nms_padded_fast"),
                             (tied, slow, "nms_padded")):
        assert torch.equal(have[1], want[1]), (c["name"], block, form,
                                               "valid")
        assert torch.equal(have[0], want[0]), (c["name"], block, form, "idx")
    return got


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("shape", PATH_SHAPES, ids=[s[0] for s in PATH_SHAPES])
def test_nms_kernel_matches_plain_at_path_shapes(cuda, shape, block):
    _check(path_problem(*shape, seed=0), block, cuda)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_nms_kernel_matches_plain_on_crafted_cases(cuda, name, block):
    _check(CASES[name], block, cuda)


def test_nms_padded_launches_the_kernel_once(cuda):
    """The one-at-a-time form, the gather form and the per-class form each
    make one launch a call on the card."""
    c = path_problem("ohem", 2, 330, 128, 0.7, -0.5, seed=1)
    args = _on(c, cuda)
    before = tnms.nms_cuda.launches
    idx, keep = tnms.nms_padded(*args)
    tnms.nms_gather(*args)
    scores = torch.rand(3, 40, 5, device=cuda)
    tnms.multiclass_nms(args[0][0, :40], scores, 0.3, 6, 1e-3,
                        valid=torch.ones(3, 40, dtype=torch.bool, device=cuda))
    torch.cuda.synchronize()
    assert tnms.nms_cuda.launches == before + 3
    want = tnms.nms_padded_plain(*args)
    assert torch.equal(idx, want[0]) and torch.equal(keep, want[1])


def test_nms_kernel_takes_the_train_budget(cuda):
    """pre_nms_top_n = 12000 (the lineage's train budget) runs, bit-equal
    to the plain block loop; past the kernel's limit the wrapper raises
    with the limit."""
    c = path_problem("train_proposals", 2, 12000, 300, 0.7, -0.5, seed=2)
    _check(c, 32, cuda)
    _, max_k = tnms._entry()
    boxes = torch.zeros(1, max_k + 1, 4, device=cuda)
    with pytest.raises(ValueError, match=str(max_k)):
        tnms.nms_cuda(boxes, torch.zeros(1, max_k + 1, device=cuda), 0.5, 4)


def test_nms_kernel_reports_its_steps(cuda):
    """The steps a problem ran: about max_outputs / select_block where few
    boxes overlap, max_outputs at width 1 with the budget filled, 0 with
    no valid box."""
    c = CASES["budget_in_first_step"]
    args = _on(c, cuda)
    for block, want in ((1, 5), (4, 2), (32, 1)):
        *_, steps = tnms.nms_cuda(*args, select_block=block,
                                  return_steps=True)
        assert steps.tolist() == [want], block
    *_, steps = tnms.nms_cuda(*_on(CASES["no_valid"], cuda),
                              return_steps=True)
    assert steps.tolist() == [0]


def test_nms_cuda_call_that_cannot_launch_raises(cuda, monkeypatch):
    """A launch error raises and never returns the plain result; a build
    failure raises too; so does a box dtype the kernel does not take."""
    args = _on(CASES["ties"], cuda)
    fn, max_k = tnms._entry()
    monkeypatch.setattr(tnms, "_entry",
                        lambda: (lambda *a: 98, max_k))   # invalid device fn
    before = tnms.nms_cuda.launches
    with pytest.raises(RuntimeError, match="cudaError 98"):
        tnms.nms_padded_fast(*args)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        tnms.nms_padded(*args)

    def no_build():
        raise RuntimeError("nvcc failed for nms")
    monkeypatch.setattr(tnms, "_entry", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tnms.nms_padded(*args)
    assert tnms.nms_cuda.launches == before
    monkeypatch.undo()
    with pytest.raises(TypeError, match="float32"):
        tnms.nms_padded(args[0].to(torch.bfloat16), *args[1:])


def test_nms_kernel_orders_unsorted_proposals(cuda):
    """A video chunk's proposals (16 x 6000 -> 300) with their boxes in
    random order, as no caller hands them: the kernel orders them itself,
    bit for bit against both plain forms at every width, and keeps the
    same boxes in the same number of steps as on the sorted input."""
    c = path_problem(*PATH_SHAPES[0], seed=4)
    # distinct live scores (in float32 the drawn ones tie now and then),
    # so the order, and with it every decision, is the same in both inputs
    c["scores"] = np.where(c["valid"], np.linspace(1, 0.01, 6000,
                                                   dtype=np.float32), -1.0
                           ).astype(np.float32)
    u, perm = permuted(c, seed=5)
    for block in BLOCKS:
        got = _check(u, block, cuda)
        *want, steps = tnms.nms_cuda(*_on(c, cuda), select_block=block,
                                     return_steps=True)
        *_, usteps = tnms.nms_cuda(*_on(u, cuda), select_block=block,
                                   return_steps=True)
        assert torch.equal(usteps, steps), block
        idx = torch.gather(torch.from_numpy(perm).to(cuda), 1, got[0])
        assert torch.equal(got[1], want[1]), block
        assert torch.equal(torch.where(got[1], idx, 0), want[0]), block


@pytest.mark.parametrize("block", BLOCKS)
def test_nms_kernel_ties_signed_zeros(cuda, block):
    """+0.0 ranks above -0.0 in the total order, as in the plain block
    loop, and ties it in the other, as in the one-at-a-time loop; the two
    orders decide differently on the case."""
    c = signed_zero_problem()
    got = _check(c, block, cuda)
    tied = tnms.nms_cuda(*_on(c, cuda), select_block=block,
                         total_order=False)
    assert not torch.equal(got[0], tied[0]), block


def test_nms_dispatchers_order_signed_zeros_as_their_dtt_forms(cuda):
    """On the card `nms_padded_fast` ranks +0.0 first and `nms_padded`
    ties the zeros, each bit for bit as its plain form on the CPU."""
    c = signed_zero_problem()
    cpu = _on(c, torch.device("cpu"))
    for form, plain in ((tnms.nms_padded_fast, tnms.nms_padded_fast_plain),
                        (tnms.nms_padded, tnms.nms_padded_plain)):
        got = form(*_on(c, cuda))
        want = plain(*cpu)
        assert torch.equal(got[1].cpu(), want[1]), form.__name__
        assert torch.equal(got[0].cpu(), want[0]), form.__name__


def test_nms_kernel_below_the_masked_score_follows_the_block_loop(cuda):
    """Below a score threshold of -1e10 every box at -1e10 is live again
    and a step's width changes the decisions: the kernel gives the plain
    block loop's at widths 1, 4, 16 and 32, and `nms_padded` on the card
    the one-at-a-time loop's, bit for bit."""
    c = below_masked_problem()
    args = _on(c, cuda)
    for block in (1, 4, 16, 32):
        got = tnms.nms_cuda(*args, select_block=block)
        want = tnms.nms_padded_fast_plain(*args, select_block=block)
        assert torch.equal(got[1], want[1]), block
        assert torch.equal(got[0], want[0]), block
    got = tnms.nms_padded(*args)
    want = tnms.nms_padded_plain(*args)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_nms_kernel_takes_the_most_boxes(cuda):
    """A problem at dtt_nms_max_boxes() (49,152), in random order: the
    scratch layout and the bitonic sort in it, bit for bit against both
    plain forms."""
    _, max_k = tnms._entry()
    assert tnms.nms_layout(max_k).body == "scratch"
    c = path_problem("train_proposals", 1, max_k, 300, 0.7, -0.5, seed=6)
    _check(permuted(c, seed=7)[0], 32, cuda)


def test_nms_kernel_scratch_layout_at_12000(cuda):
    """The train budget (12,000 boxes) is past the shared layout: sorted
    and in random order, bit for bit against both plain forms at every
    width."""
    assert tnms.nms_layout(12000).body == "scratch"
    c = path_problem("train_proposals", 2, 12000, 300, 0.7, -0.5, seed=8)
    for block in BLOCKS:
        _check(c, block, cuda)
        _check(permuted(c, seed=9)[0], block, cuda)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(LONG))
def test_nms_kernel_walks_past_a_block(cuda, name, block):
    """Walks that go past the first 1,024 positions, more than a block
    has threads, so each thread masks several positions a step (proposals
    at IoU 0.1; near-duplicate anchors, where a hundred kept boxes
    suppress all 6,000): bit for bit against both plain forms at every
    width."""
    c = LONG[name]
    idx, val = _check(c, block, cuda)
    assert min(walk_end(c, idx.cpu().numpy(), val.cpu().numpy())) > 1024


def test_nms_padded_takes_a_tensor_threshold_below_the_masked_score(cuda):
    """A score threshold below -1e10 given as a tensor picks the same
    width as a Python number: `nms_padded` on the card gives the
    one-at-a-time loop's decisions."""
    c = below_masked_problem()
    args = _on(c, cuda)
    thr = torch.tensor(c["score"], device=cuda)
    got = tnms.nms_padded(*args[:5], thr)
    want = tnms.nms_padded_plain(*args)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
