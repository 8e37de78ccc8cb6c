"""The NMS kernel ``dtt_nms_select`` held against both plain forms on a
CUDA card, bit for bit: the four problem shapes of the port's paths (a
video chunk's and a train step's proposals, a chunk's per-class NMS,
OHEM) and the crafted cases of ``tests/nms_cases.py``, at select_block 1,
16, 32 and 48 (wider than a step of the kernel); one launch a call; a call
that cannot launch raises. Marked ``gpu``: they skip without a card. This
file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_port_nms_gpu.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from dtt_torch.ops import nms as tnms

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from nms_cases import PATH_SHAPES, crafted_cases, path_problem  # noqa: E402

pytestmark = pytest.mark.gpu

BLOCKS = (1, 16, 32, 48)
CASES = {c["name"]: c for c in crafted_cases()}


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
    args = _on(c, device)
    before = tnms.nms_cuda.launches
    got = tnms.nms_padded_fast(*args, select_block=block)
    torch.cuda.synchronize()
    assert tnms.nms_cuda.launches == before + 1
    fast = tnms.nms_padded_fast_plain(*args, select_block=block)
    slow = tnms.nms_padded_plain(*args)
    for want, form in ((fast, "nms_padded_fast"), (slow, "nms_padded")):
        assert torch.equal(got[1], want[1]), (c["name"], block, form, "valid")
        assert torch.equal(got[0], want[0]), (c["name"], block, form, "idx")
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
