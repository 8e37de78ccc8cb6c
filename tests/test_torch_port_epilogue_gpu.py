"""The conv epilogue kernels ``dtt_conv_epilogue`` and
``dtt_conv_epilogue_bwd`` (kernel 10) held against their plain PyTorch
versions on a CUDA card, bit for bit: every form in float32 and bfloat16
at each distinct shape of a ResNet-101 trunk call on one 608x1088 frame,
at odd channel counts, with NaN, +-inf and +-0.0 among the inputs; the
edges of the vector loop's chunks (a tensor shorter than one chunk, a
last partial chunk, blocks walking several chunks); a launch on a
non-default stream; buffers changed in place and replaced; three runs
bit-equal; one launch a call; autograd through both kernels; calls that
cannot launch raise; and a full-width ``Config()`` train step with
the kernels against the eager form, whose losses and gradients must lie
within the spread of two eager runs measured here (cuDNN's weight
gradients need not be deterministic). Marked ``gpu``: they skip without a
card. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_port_epilogue_gpu.py
"""

from unittest import mock

import numpy as np
import pytest
import torch

from dtt_torch.models.resnet import ResNetBackbone
from dtt_torch.ops import epilogue as tepi

pytestmark = pytest.mark.gpu

DTYPES = (torch.float32, torch.bfloat16)
TRUNK = (3, 4, 23, 3)                   # ResNet-101
SPECIALS = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0)
ODD_C = (1, 3, 12, 36, 100)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ints(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_ints(a), _ints(b))


def _tensor(shape, dtype, gen, special=0.05):
    """A channels-last (N, C, H, W) tensor, a share `special` of SPECIALS."""
    x = torch.randn(shape, device="cuda", generator=gen) * 2
    pick = torch.rand(shape, device="cuda", generator=gen)
    table = torch.tensor(SPECIALS, device="cuda")
    idx = (pick * 1e6).long() % len(SPECIALS)
    x = torch.where(pick < special, table[idx], x)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _buffers(c, gen):
    s = torch.randn(c, device="cuda", generator=gen) * 0.7
    b = torch.randn(c, device="cuda", generator=gen)
    b = torch.where(torch.rand(c, device="cuda", generator=gen) < 0.3,
                    torch.full_like(b, -0.0), b)
    return s, b


def _case(form, shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _tensor(shape, dtype, gen)
    s, b = _buffers(shape[1], gen)
    z = None if form == "A" else _tensor(shape, dtype, gen)
    t, c = _buffers(shape[1], gen) if form == "C" else (None, None)
    return x, s, b, z, t, c


def _trunk_shapes():
    """Each distinct (form, shape) of one frame's ResNet-101 trunk call,
    recorded through the dispatcher on the meta device."""
    with torch.device("meta"):
        bb = ResNetBackbone(TRUNK)
    seen = set()

    def record(x, scale, bias, z=None, scale_z=None, bias_z=None):
        seen.add((tepi.form_of(z, scale_z), tuple(x.shape)))
        return tepi.conv_epilogue_plain(x, scale, bias, z, scale_z, bias_z)

    with mock.patch.object(tepi, "conv_epilogue", record), torch.no_grad():
        bb(torch.empty(1, 3, 608, 1088, device="meta", dtype=torch.bfloat16))
    return sorted(seen)


def _check_forward(form, shape, dtype, seed):
    args = _case(form, shape, dtype, seed)
    got = tepi.conv_epilogue_cuda(*args)
    torch.cuda.synchronize()
    want = tepi.conv_epilogue_plain(*args)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _same(got, want), (form, shape, dtype)


def _check_backward(form, shape, dtype, seed, want_gz=True):
    x, s, b, z, t, c = _case(form, shape, dtype, seed)
    y = tepi.conv_epilogue_plain(x, s, b, z, t, c)
    g = _tensor(shape, dtype, torch.Generator(device="cuda").manual_seed(
        seed + 1))
    gx, gz = tepi.conv_epilogue_bwd_cuda(g, y, s, form, t, want_gz)
    torch.cuda.synchronize()
    wx, wz = tepi.conv_epilogue_bwd_plain(g, y, s, form, t)
    assert _same(gx, wx), (form, shape, dtype)
    if form == "A" or not want_gz:
        assert gz is None
    else:
        assert _same(gz, wz), (form, shape, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_at_trunk_shapes(cuda, dtype):
    shapes = _trunk_shapes()
    assert len(shapes) >= 14
    for i, (form, shape) in enumerate(shapes):
        _check_forward(form, shape, dtype, seed=i)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bwd_kernel_matches_plain_at_trunk_shapes(cuda, dtype):
    for i, (form, shape) in enumerate(_trunk_shapes()):
        _check_backward(form, shape, dtype, seed=100 + i)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", tepi.FORMS)
@pytest.mark.parametrize("c", ODD_C)
def test_kernel_matches_plain_at_odd_channels(cuda, dtype, form, c):
    shape = (2, c, 7, 9)
    _check_forward(form, shape, dtype, seed=c)
    _check_backward(form, shape, dtype, seed=c + 1)
    _check_backward(form, shape, dtype, seed=c + 2, want_gz=False)


def test_kernel_takes_nan_inf_and_signed_zeros_exactly(cuda):
    """Inputs made of SPECIALS and a few numbers only, every form and
    dtype, forward and backward."""
    for dtype in DTYPES:
        for form in tepi.FORMS:
            gen = torch.Generator(device="cuda").manual_seed(7)
            shape = (1, 64, 5, 6)
            x = _tensor(shape, dtype, gen, special=0.8)
            z = _tensor(shape, dtype, gen, special=0.8)
            s, b = _buffers(64, gen)
            t, c = _buffers(64, gen)
            args = (x, s, b, *((z,) if form == "B" else
                               (z, t, c) if form == "C" else ()))
            y = tepi.conv_epilogue_cuda(*args)
            assert _same(y, tepi.conv_epilogue_plain(*args))
            gx, gz = tepi.conv_epilogue_bwd_cuda(x, y, s, form, t)
            wx, wz = tepi.conv_epilogue_bwd_plain(x, y, s, form, t)
            assert _same(gx, wx)
            assert form == "A" or _same(gz, wz)


def test_kernel_is_deterministic(cuda):
    for form in tepi.FORMS:
        args = _case(form, (2, 256, 38, 68), torch.bfloat16, seed=3)
        ys = [tepi.conv_epilogue_cuda(*args) for _ in range(3)]
        gs = [tepi.conv_epilogue_bwd_cuda(args[0], ys[0], args[1], form,
                                          args[4]) for _ in range(3)]
        assert all(_same(y, ys[0]) for y in ys)
        for gx, gz in gs:
            assert _same(gx, gs[0][0])
            assert gz is None or _same(gz, gs[0][1])


def test_one_launch_a_call(cuda):
    args = _case("C", (1, 512, 38, 68), torch.bfloat16, seed=4)
    fwd, bwd = tepi.conv_epilogue_cuda.launches, \
        tepi.conv_epilogue_bwd_cuda.launches
    y = tepi.conv_epilogue_cuda(*args)
    assert tepi.conv_epilogue_cuda.launches == fwd + 1
    tepi.conv_epilogue_bwd_cuda(args[0], y, args[1], "C", args[4])
    assert tepi.conv_epilogue_bwd_cuda.launches == bwd + 1
    assert tepi.conv_epilogue_cuda.launches == fwd + 1


@pytest.mark.parametrize("form", tepi.FORMS)
def test_autograd_launches_both_kernels(cuda, form):
    """The dispatcher under autograd: one forward and one backward launch,
    output and gradients the bits of autograd through the eager ops, also
    for a gradient that is not channels-last."""
    x, s, b, z, t, c = _case(form, (2, 64, 19, 34), torch.bfloat16, seed=5)
    g = torch.randn(x.shape, device="cuda").to(torch.bfloat16)   # NCHW
    runs = []
    for fn in (tepi.conv_epilogue, tepi.conv_epilogue_plain):
        xr = x.clone().requires_grad_()
        zr = None if z is None else z.clone().requires_grad_()
        before = (tepi.conv_epilogue_cuda.launches,
                  tepi.conv_epilogue_bwd_cuda.launches)
        y = fn(xr, s, b, zr, t, c)
        grads = torch.autograd.grad(y, [xr] + ([] if zr is None else [zr]),
                                    g)
        launched = (tepi.conv_epilogue_cuda.launches - before[0],
                    tepi.conv_epilogue_bwd_cuda.launches - before[1])
        runs.append((launched, y, *grads))
    assert runs[0][0] == (1, 1) and runs[1][0] == (0, 0)
    for a, b_ in zip(runs[0][1:], runs[1][1:]):
        assert _same(a, b_)


def test_raises_where_it_cannot_launch(cuda):
    s, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    nchw = torch.zeros(2, 64, 5, 6, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last"):
        tepi.conv_epilogue_cuda(nchw, s, b)
    buf = torch.zeros(2 * 64 * 30 + 1, device=cuda, dtype=torch.bfloat16)
    odd = buf[1:].view(2, 5, 6, 64).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tepi.conv_epilogue_cuda(odd, s, b)
    x = nchw.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="buffers"):
        tepi.conv_epilogue_cuda(x, s.cpu(), b)
    with pytest.raises(ValueError, match="every tensor"):
        tepi.conv_epilogue_bwd_cuda(x.float(), x, s, "A")
    tepi.conv_epilogue_cuda(x, s, b)
    with pytest.raises(ValueError, match="buffers"):
        tepi.conv_epilogue_cuda(x, s.view(torch.int32), b)
    with pytest.raises(ValueError, match="buffers"):
        tepi.conv_epilogue_cuda(x, s, b.to(torch.bfloat16))
    if torch.cuda.device_count() > 1:
        with pytest.raises(ValueError, match="current device"):
            tepi.conv_epilogue_cuda(x.to("cuda:1"), s.to("cuda:1"),
                                    b.to("cuda:1"))


def _edge_shapes(dtype):
    """(N, C, H, W) shapes at the edges of the vector loop's chunks (a
    block's chunk of one tensor: 256 threads x 2 loads of 16 bytes): a
    tensor shorter than one chunk, a chunk and a part, and at C = 1,024
    and 2,048, where a block walks 2 to 8 chunks, 15 positions (a last
    partial chunk but in float32 at C = 2,048)."""
    chunk = 256 * 2 * 16 // (torch.finfo(dtype).bits // 8)
    short = (1, 64, 1, chunk // 64 // 2)
    partial = (1, 64, 1, chunk // 64 + chunk // 128 + 1)  # 1.5 chunks + 64
    assert 64 * short[3] < chunk < 64 * partial[3] and 64 * partial[3] % chunk
    return short, partial, (1, 1024, 3, 5), (1, 2048, 3, 5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", tepi.FORMS)
def test_kernels_match_plain_at_the_chunk_edges(cuda, dtype, form):
    for i, shape in enumerate(_edge_shapes(dtype)):
        _check_forward(form, shape, dtype, seed=200 + i)
        for want_gz in (True, False):
            _check_backward(form, shape, dtype, seed=210 + i,
                            want_gz=want_gz)


def test_launches_on_the_current_stream(cuda):
    """Both wrappers launch on a non-default current stream: their input
    is written on that stream after a sleep, so a launch elsewhere would
    read it before it is there."""
    x, s, b, z, t, c = _case("C", (2, 256, 19, 34), torch.bfloat16, seed=9)
    want = tepi.conv_epilogue_plain(x, s, b, z, t, c)
    g = _tensor(x.shape, torch.bfloat16, torch.Generator(
        device="cuda").manual_seed(10))
    wx, wz = tepi.conv_epilogue_bwd_plain(g, want, s, "C", t)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        late = torch.empty_like(x)
        torch.cuda._sleep(50_000_000)
        late.copy_(x)
        y = tepi.conv_epilogue_cuda(late, s, b, z, t, c)
        late_g = torch.empty_like(g)
        torch.cuda._sleep(50_000_000)
        late_g.copy_(g)
        gx, gz = tepi.conv_epilogue_bwd_cuda(late_g, y, s, "C", t)
    side.synchronize()
    assert _same(y, want) and _same(gx, wx) and _same(gz, wz)


def test_sees_buffers_changed_in_place_and_replaced(cuda):
    """A trunk's ``FrozenAffine`` buffers changed in place, loaded by
    ``load_state_dict`` and moved by ``.to()`` after the kernel has used
    them: every call computes with their values of the moment."""
    from dtt_torch.models.resnet import FrozenAffine
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = _tensor((2, 128, 9, 13), torch.bfloat16, gen, special=0.0)
    aff = FrozenAffine(128, device="cuda")
    down = FrozenAffine(128, device="cuda")
    z = _tensor(x.shape, torch.bfloat16, gen, special=0.0)

    def check():
        args = (x, aff.scale, aff.bias, z, down.scale, down.bias)
        y = tepi.conv_epilogue_cuda(*args)
        assert _same(y, tepi.conv_epilogue_plain(*args))
        g = _tensor(x.shape, torch.bfloat16, gen, special=0.0)
        gx, gz = tepi.conv_epilogue_bwd_cuda(g, y, aff.scale, "C",
                                             down.scale)
        wx, wz = tepi.conv_epilogue_bwd_plain(g, y, aff.scale, "C",
                                              down.scale)
        assert _same(gx, wx) and _same(gz, wz)
        return y

    before = check()
    aff.scale.mul_(-1.5)
    down.bias.add_(2.0)
    changed = check()
    assert not _same(changed, before)
    aff.load_state_dict({"scale": torch.rand(128, device="cuda") + 0.5,
                         "bias": torch.randn(128, device="cuda")})
    down.load_state_dict({"scale": torch.rand(128, device="cuda") - 2.0,
                          "bias": torch.randn(128, device="cuda")})
    loaded = check()
    assert not _same(loaded, changed)
    aff.to("cpu")
    aff.scale.mul_(3.0)
    aff.to("cuda")
    moved = check()
    assert not _same(moved, loaded)


def _spread_ok(f, e1, e2) -> bool:
    """`f` within [min(e1, e2) - d, max(e1, e2) + d], d = max |e1 - e2|."""
    d = (e1 - e2).abs().max()
    return bool(((f >= torch.minimum(e1, e2) - d)
                 & (f <= torch.maximum(e1, e2) + d)).all())


def test_train_step_matches_the_eager_form(cuda, monkeypatch):
    """One full-width ``Config()`` train step through the kernels against
    two through the eager ops (the plain version patched in), from the
    same weights, batch and draws: the losses and every trainable leaf's
    clipped gradient within the eager runs' spread, and the kernels
    launched (the backward at every trained block: layer2-4 at
    ``frozen_stages=2``)."""
    from dtt_torch.core.config import Config
    from dtt_torch.data.synthetic import synthetic_batch
    from dtt_torch.models.targets import sample_draws
    from dtt_torch.train.trainer import create_train_state, make_train_step
    from dtt_torch.utils.params import init_jax_params
    cfg = Config()
    m, h, w = cfg.model, cfg.input.canvas_height, cfg.input.canvas_width
    b = cfg.train.batch_size_per_chip
    tree = init_jax_params(m, seed=0)
    batch = synthetic_batch(np.random.RandomState(1), b, h, w, m.num_classes,
                            cfg.input.max_gt_boxes, cfg.input.pixel_means,
                            uint8=True,
                            num_objects=cfg.input.synthetic_objects)
    draws = sample_draws(cfg, b, torch.Generator(cuda).manual_seed(2), cuda)
    runs = {}
    for label in ("eager1", "kernel", "eager2"):
        with monkeypatch.context() as mp:
            if label != "kernel":
                mp.setattr(tepi, "conv_epilogue", tepi.conv_epilogue_plain)
            model, state = create_train_state(cfg, cuda, tree=tree)
            step = make_train_step(cfg, model, (h // 16, w // 16))
            before = (tepi.conv_epilogue_cuda.launches,
                      tepi.conv_epilogue_bwd_cuda.launches)
            state, metrics = step(state, batch, draws)
            torch.cuda.synchronize()
            launched = (tepi.conv_epilogue_cuda.launches - before[0],
                        tepi.conv_epilogue_bwd_cuda.launches - before[1])
            runs[label] = (launched,
                           {k: v.detach().double() for k, v in
                            metrics.items()},
                           {k: p.grad.detach().clone() for k, p in
                            model.named_parameters() if p.requires_grad})
            del model, state, step
    blocks = sum(TRUNK[1:])
    assert runs["kernel"][0][1] == 3 * blocks
    assert runs["kernel"][0][0] >= 1 + 3 * sum(TRUNK)
    assert runs["eager1"][0] == (0, 0) and runs["eager2"][0] == (0, 0)
    (_, l1, g1), (_, lk, gk), (_, l2, g2) = (runs["eager1"], runs["kernel"],
                                              runs["eager2"])
    for k in l1:
        assert _spread_ok(lk[k], l1[k], l2[k]), (k, lk[k], l1[k], l2[k])
    assert g1.keys() == gk.keys() and len(gk) > 100
    bad = [k for k in g1 if not _spread_ok(gk[k], g1[k], g2[k])]
    assert not bad, bad[:5]
