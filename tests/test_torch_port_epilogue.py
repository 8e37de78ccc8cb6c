"""The trunk's conv epilogue (``dtt_torch.ops.epilogue``, kernel 10) on the
CPU: its plain version against ``dtt``'s ``FrozenAffine`` + ``nn.relu``
(+ the residual, + ``downsample_bn``) run eagerly, forward and
``jax.vjp``; the autograd path against the eager ops; ``Bottleneck`` and
``ResNetBackbone`` through the dispatcher against the trunk's unfused
expressions; the backward kernel's reference against eager autograd; the
BN calibration's bits and its hooks; the CUDA wrappers' checks and the C
entries' codes and constants; and the
epilogue calls a full-size trunk makes (recorded on the meta device, also
by the host-split tool).

Inputs are seeded numpy arrays with NaN, +-inf and +-0.0 among them. Bits
are compared: bf16 inputs reach JAX as the same bits (not rounded twice).
Two differences between the frameworks are allowed and each is named
where it is: a NaN's payload (torch and XLA give different quiet NaNs),
and ``F.relu(-0.0)``, which torch's CPU kernel returns as -0.0 where
``jax.nn.relu`` returns +0.0 (the port follows ``F.relu``); and the
gradient where the ReLU's input is NaN, which torch passes
(``threshold_backward`` on the output) and JAX zeroes (``x > 0``).
"""

import copy
import os
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dtt.models.resnet import FrozenAffine as JFrozenAffine

from dtt_torch.models import resnet as tresnet
from dtt_torch.models.dnt import is_frozen
from dtt_torch.ops import epilogue as tepi
from dtt_torch.utils import calibrate as tcal

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)


def _inputs(rng, n, c, h, w, special=0.1):
    """(N, H, W, C) float32 with a share `special` of SPECIALS."""
    x = rng.randn(n, h, w, c).astype(np.float32) * 2
    mask = rng.rand(*x.shape) < special
    x[mask] = rng.choice(SPECIALS, mask.sum())
    return x


def _buffers(rng, c):
    """Per-channel (scale, bias) float32, negative and -0.0 among them."""
    scale = (rng.randn(c) * 0.7).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    bias[rng.rand(c) < 0.3] = -0.0
    return scale, bias


def _to_torch(x_nhwc, dtype):
    """NHWC float32 -> NCHW channels-last in `dtype`."""
    return torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)


def _to_jax(t, jdtype):
    """NCHW torch tensor -> NHWC jax array of the same bits."""
    a = t.detach().permute(0, 2, 3, 1).contiguous()
    if t.dtype == torch.bfloat16:
        return jnp.asarray(a.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(a.numpy())


def _bits(a):
    """float32 values and integer bits of an NHWC array or NCHW tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().permute(0, 2, 3, 1).contiguous()
        ints = a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32).numpy()
        return a.float().numpy(), ints
    a = np.asarray(a)
    ints = a.view(np.int16 if a.dtype == jnp.bfloat16 else np.int32)
    return a.astype(np.float32), ints


def _assert_bits(got, want, relu_in=None):
    """Bit for bit, but a NaN's payload and, where the ReLU's input
    `relu_in` is -0.0, the sign of the zero."""
    g, gi = _bits(got)
    w, wi = _bits(want)
    nan = np.isnan(w)
    assert (np.isnan(g) == nan).all()
    ok = (gi == wi) | nan
    if relu_in is not None:
        r = np.asarray(relu_in).astype(np.float32)
        ok |= (r == 0) & np.signbit(r) & (g == 0) & (w == 0)
    assert ok.all(), np.argwhere(~ok)[:5]


def _jax_epilogue(form, jdtype, x, s, b, z=None, t=None, c=None):
    """dtt's eager ops: the pre-ReLU value and the output (NHWC)."""
    affine = JFrozenAffine(x.shape[-1], jdtype)
    out = affine.apply({"params": {"scale": s, "bias": b}}, x)
    if form == "C":
        z = affine.apply({"params": {"scale": t, "bias": c}}, z)
    if form != "A":
        out = out + z
    return out, nn.relu(out)


def _case(form, dtype, seed, n=2, c=24, h=5, w=7, special=0.1,
          z_special=None):
    rng = np.random.RandomState(seed)
    tdt, jdt = DTYPES[dtype]
    x = _to_torch(_inputs(rng, n, c, h, w, special), tdt)
    s, b = _buffers(rng, c)
    z = t = cc = None
    if form != "A":
        z = _to_torch(_inputs(rng, n, c, h, w, special if z_special is None
                              else z_special), tdt)
    if form == "C":
        t, cc = _buffers(rng, c)
    bufs = [None if v is None else torch.from_numpy(v) for v in (s, b, t, cc)]
    return x, z, bufs, (tdt, jdt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", tepi.FORMS)
def test_plain_matches_dtt_eager(form, dtype):
    """``conv_epilogue_plain`` (and the dispatcher on the CPU) against dtt's
    ``FrozenAffine`` + ``nn.relu`` run op by op, bit for bit."""
    x, z, (s, b, t, c), (tdt, jdt) = _case(form, dtype, seed=1)
    got = tepi.conv_epilogue_plain(x, s, b, z, t, c)
    same = tepi.conv_epilogue(x, s, b, z, t, c)
    jz = None if z is None else _to_jax(z, jdt)
    pre, want = _jax_epilogue(
        form, jdt, _to_jax(x, jdt), jnp.asarray(s.numpy()),
        jnp.asarray(b.numpy()), jz,
        *(() if t is None else (jnp.asarray(t.numpy()),
                                jnp.asarray(c.numpy()))))
    _assert_bits(got, want, relu_in=pre)
    assert torch.equal(got.view(torch.int16 if tdt == torch.bfloat16
                                else torch.int32),
                       same.view(torch.int16 if tdt == torch.bfloat16
                                 else torch.int32))
    assert np.isnan(_bits(got)[0]).any() and (_bits(got)[0] == 0).any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", tepi.FORMS)
def test_plain_is_the_port_eager_form(form, dtype):
    """The plain version is the trunk's unfused ops (the port's
    ``FrozenAffine`` modules and ``F.relu``) bit for bit, NaN payloads and
    signed zeros included."""
    x, z, (s, b, t, c), (tdt, _) = _case(form, dtype, seed=2)
    cch = x.shape[1]
    bn, ds = tresnet.FrozenAffine(cch), tresnet.FrozenAffine(cch)
    bn.scale.copy_(s)
    bn.bias.copy_(b)
    want = bn(x)
    if form == "C":
        ds.scale.copy_(t)
        ds.bias.copy_(c)
        want = want + ds(z)
    elif form == "B":
        want = want + z
    want = F.relu(want)
    got = tepi.conv_epilogue_plain(x, s, b, z, t, c)
    ints = torch.int16 if tdt == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(ints), want.view(ints))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", tepi.FORMS)
def test_gradients_match_jax_vjp(form, dtype):
    """The dispatcher's autograd gradients (``_ConvEpilogue`` with the plain
    backward on the CPU) against ``jax.vjp`` of dtt's eager ops, bit for
    bit, with +-inf and +-0.0 in x and +-0.0 in z (a NaN at the ReLU's
    input is left to the next test: the frameworks differ there); the
    buffers take no gradient, as dtt's ``stop_gradient``."""
    x, z, (s, b, t, c), (tdt, jdt) = _case(form, dtype, seed=3,
                                           z_special=0.0)
    keep = ~torch.isnan(x.float())
    x = torch.where(keep, x, torch.zeros((), dtype=tdt))
    if z is not None:
        zn = z.permute(0, 2, 3, 1).contiguous()
        zn.view(-1)[::7] = 0.0
        zn.view(-1)[::11] = -0.0
        z = zn.permute(0, 3, 1, 2)
    rng = np.random.RandomState(4)
    g = _to_torch(rng.randn(*x.permute(0, 2, 3, 1).shape)
                  .astype(np.float32), tdt)
    xr = x.clone().requires_grad_()
    zr = None if z is None else z.clone().requires_grad_()
    sr = s.clone().requires_grad_()
    y = tepi.conv_epilogue(xr, sr, b, zr, t, c)
    got = torch.autograd.grad(y, [xr, sr] + ([] if zr is None else [zr]), g,
                              allow_unused=True)
    assert got[1] is None

    js, jb = jnp.asarray(s.numpy()), jnp.asarray(b.numpy())
    jtc = () if t is None else (jnp.asarray(t.numpy()),
                                jnp.asarray(c.numpy()))
    if z is None:
        _, vjp = jax.vjp(lambda a: _jax_epilogue(form, jdt, a, js, jb)[1],
                         _to_jax(x, jdt))
        want = vjp(_to_jax(g, jdt))
    else:
        _, vjp = jax.vjp(
            lambda a, zz: _jax_epilogue(form, jdt, a, js, jb, zz, *jtc)[1],
            _to_jax(x, jdt), _to_jax(z, jdt))
        want = vjp(_to_jax(g, jdt))
    _assert_bits(got[0], want[0])
    if z is not None:
        _assert_bits(got[2], want[1])
    _, s_vjp = jax.vjp(lambda ss: _jax_epilogue(form, jdt, _to_jax(x, jdt),
                                                ss, jb, None if z is None
                                                else _to_jax(z, jdt), *jtc)[1],
                       js)
    assert not np.asarray(s_vjp(_to_jax(g, jdt))[0]).any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", tepi.FORMS)
def test_autograd_matches_eager_ops(form, dtype):
    """With NaN, +-inf and +-0.0 everywhere: ``conv_epilogue_bwd_plain``
    (the backward kernel's reference) equals autograd through the eager
    ops bit for bit (a NaN output passes its gradient, as
    ``threshold_backward`` does), and the dispatcher's CPU path, forward
    and backward, is those eager ops and launches no kernel."""
    x, z, (s, b, t, c), (tdt, _) = _case(form, dtype, seed=5)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).to(
        tdt).contiguous(memory_format=torch.channels_last)
    before = (tepi.conv_epilogue_cuda.launches,
              tepi.conv_epilogue_bwd_cuda.launches)
    runs = []
    for fn in (tepi.conv_epilogue, tepi.conv_epilogue_plain):
        xr = x.clone().requires_grad_()
        zr = None if z is None else z.clone().requires_grad_()
        y = fn(xr, s, b, zr, t, c)
        runs.append((y, *torch.autograd.grad(
            y, [xr] + ([] if zr is None else [zr]), g)))
    ints = torch.int16 if tdt == torch.bfloat16 else torch.int32
    for got, want in zip(*runs):
        assert torch.equal(got.view(ints), want.view(ints))
    y, gx, *gz = runs[1]
    ref = tepi.conv_epilogue_bwd_plain(g, y.detach(), s, form, t)
    assert torch.equal(ref[0].view(ints), gx.view(ints))
    if form == "A":
        assert ref[1] is None
    else:
        assert torch.equal(ref[1].view(ints), gz[0].view(ints))
    assert (tepi.conv_epilogue_cuda.launches,
            tepi.conv_epilogue_bwd_cuda.launches) == before


def _old_block(block, x):
    """``Bottleneck.forward`` as it was: each op on its own."""
    out = F.relu(block.bn1(block.conv1(x)))
    out = F.relu(block.bn2(block.conv2(out)))
    out = block.bn3(block.conv3(out))
    if block.downsample_conv is not None:
        x = block.downsample_bn(block.downsample_conv(x))
    return F.relu(out + x)


def _old_backbone(bb, x):
    """``ResNetBackbone.forward`` as it was."""
    x = F.relu(bb.bn1(bb.conv1(x)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    if bb.frozen_stages >= 1:
        x = x.detach()
    x = bb.layer1(x)
    if bb.frozen_stages >= 2:
        x = x.detach()
    c3 = bb.layer2(x)
    if bb.frozen_stages >= 3:
        c3 = c3.detach()
    c4 = bb.layer3(c3)
    return c3, c4, bb.layer4(c4)


def _random_backbone(layers, frozen, remat, seed):
    torch.manual_seed(seed)
    bb = tresnet.ResNetBackbone(layers, frozen, remat).to(
        memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(seed)
    for name, buf in bb.named_buffers():
        buf.copy_(torch.randn(buf.shape, generator=gen) * 0.3
                  + (1.0 if name.endswith("scale") else 0.0))
    return bb


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frozen,remat", [(0, False), (2, True)])
def test_backbone_matches_unfused_trunk(dtype, frozen, remat, monkeypatch):
    """``ResNetBackbone`` (every ``Bottleneck`` and the stem through the
    dispatcher) against the same modules run with the old, unfused
    forwards: c3, c4, c5, the input's and every parameter's gradient bit
    for bit, under ``frozen_stages`` 0 and 2 (with remat)."""
    tdt = DTYPES[dtype][0]
    bb = _random_backbone((1, 2, 1, 1), frozen, remat, seed=7)
    x0 = torch.randn(2, 3, 37, 45, generator=torch.Generator().manual_seed(8)
                     ).to(tdt).contiguous(memory_format=torch.channels_last)
    results = []
    for old in (False, True):
        if old:
            monkeypatch.setattr(tresnet.Bottleneck, "forward", _old_block)
            monkeypatch.setattr(tresnet.ResNetBackbone, "forward",
                                _old_backbone)
        x = x0.clone().requires_grad_()
        outs = bb(x)
        gen = torch.Generator().manual_seed(9)
        gs = [torch.randn(o.shape, generator=gen).to(tdt) for o in outs]
        params = [p for p in bb.parameters() if p.requires_grad]
        grads = torch.autograd.grad(outs, [x] + params, gs, allow_unused=True)
        results.append((outs, grads))
    (outs, grads), (want_outs, want_grads) = results
    for a, b in zip(outs, want_outs):
        assert torch.equal(a, b)
    assert len(grads) == len(want_grads)
    for a, b in zip(grads, want_grads):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("downsample", [False, True])
def test_bottleneck_matches_unfused_block(dtype, downsample):
    """One ``Bottleneck`` (forms A, B or A, C) against its old forward,
    forward and backward, bit for bit."""
    tdt = DTYPES[dtype][0]
    torch.manual_seed(10)
    inplanes = 12 if downsample else 32
    block = tresnet.Bottleneck(inplanes, 8, 2 if downsample else 1, 1,
                               downsample).to(
        memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(11)
    for name, buf in block.named_buffers():
        buf.copy_(torch.randn(buf.shape, generator=gen))
    x0 = torch.randn(2, inplanes, 9, 11, generator=gen).to(tdt).contiguous(
        memory_format=torch.channels_last)
    runs = []
    for fwd in (block.forward, lambda x: _old_block(block, x)):
        x = x0.clone().requires_grad_()
        y = fwd(x)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(12)
                        ).to(tdt)
        runs.append((y, *torch.autograd.grad(y, [x, *block.parameters()],
                                             g)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _old_affine_stats(backbone, images, names):
    """``calibrate.affine_stats`` as it was: hooks on the ``FrozenAffine``
    modules of the unfused trunk."""
    modules = dict(backbone.named_modules())
    stats = {}

    def hook(name):
        def fn(_module, _inputs, y):
            var, mean = torch.var_mean(y.float(), dim=(0, 2, 3),
                                       unbiased=False)
            stats[name] = (mean, var)
            if len(stats) == len(names):
                raise tcal._Captured
        return fn

    handles = [modules[n].register_forward_hook(hook(n)) for n in names]
    try:
        with torch.no_grad():
            backbone(images)
    except tcal._Captured:
        pass
    finally:
        for h in handles:
            h.remove()
    return stats


def _old_calibration(monkeypatch):
    """The unfused trunk and its hook-on-``FrozenAffine`` calibration."""
    monkeypatch.setattr(tresnet.Bottleneck, "forward", _old_block)
    monkeypatch.setattr(tresnet.ResNetBackbone, "forward", _old_backbone)
    monkeypatch.setattr(tcal, "affine_stats", _old_affine_stats)


def test_calibration_bits_unchanged(monkeypatch):
    """``calibrate_backbone`` sets every affine's scale and bias to the
    bits the unfused trunk's hooks gave before the fusion, in bf16."""
    bb = _random_backbone((1, 2, 1, 1), 2, False, seed=13)
    images = torch.randn(4, 3, 41, 53,
                         generator=torch.Generator().manual_seed(14)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    old = copy.deepcopy(bb)
    tcal.calibrate_backbone(bb, images)
    _old_calibration(monkeypatch)
    tcal.calibrate_backbone(old, images)
    bufs, want = dict(bb.named_buffers()), dict(old.named_buffers())
    assert len(bufs) == 2 * (1 + 3 * 5 + 4)
    for name, v in want.items():
        assert torch.equal(bufs[name], v), name
    assert not torch.equal(bufs["layer4.block0.bn3.scale"],
                           torch.ones_like(want["layer4.block0.bn3.scale"]))


@pytest.mark.parametrize("group", [
    ["bn1"], ["layer1.block0.bn2"],
    ["layer2.block0.bn3", "layer2.block0.downsample_bn"],
    ["layer4.block0.bn3", "layer4.block0.downsample_bn"]])
def test_affine_stats_hook_the_convs(group, monkeypatch):
    """``affine_stats`` through the fused trunk: each affine's statistics
    bit for bit those of its own output in the unfused trunk, and the
    forward stops at the group (no later conv runs)."""
    bb = _random_backbone((1, 2, 1, 1), 2, False, seed=15)
    x = torch.randn(2, 3, 33, 47, generator=torch.Generator().manual_seed(16)
                    ).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    ran = []
    handles = [m.register_forward_hook(lambda m, i, o, n=n: ran.append(n))
               for n, m in bb.named_modules()
               if isinstance(m, torch.nn.Conv2d)]
    got = tcal.affine_stats(bb, x, group)
    for h in handles:
        h.remove()
    assert ran[-1] == max((tcal._conv_of(n) for n in group), key=ran.index)
    with monkeypatch.context() as mp:
        _old_calibration(mp)
        want = tcal.affine_stats(bb, x, group)
    assert sorted(got) == sorted(want) == sorted(group)
    for name in group:
        for a, b in zip(got[name], want[name]):
            assert torch.equal(a, b), name


def _record_calls(layers, frames, hw, monkeypatch):
    """(records a gradient, form, shape) of each epilogue call of one
    ``ResNetBackbone`` call (``frozen_stages`` 2, its parameters frozen as
    ``DnT`` freezes them) on meta tensors, in order."""
    with torch.device("meta"):
        bb = tresnet.ResNetBackbone(layers, 2)
    for name, p in bb.named_parameters():
        p.requires_grad_(not is_frozen("backbone." + name, 2))
    seen = []

    def record(x, scale, bias, z=None, scale_z=None, bias_z=None):
        seen.append((x.requires_grad, tepi.form_of(z, scale_z),
                     tuple(x.shape)))
        return tepi.conv_epilogue_plain(x, scale, bias, z, scale_z, bias_z)

    monkeypatch.setattr(tepi, "conv_epilogue", record)
    bb(torch.empty(frames, 3, *hw, device="meta", dtype=torch.bfloat16))
    return seen


@pytest.mark.parametrize("layers,frames", [((3, 4, 23, 3), 17),
                                           ((3, 4, 6, 3), 16)])
def test_trunk_calls_match_a_recorded_trunk(layers, frames, monkeypatch):
    """A full-size trunk call at 608x1088 goes through the dispatcher once
    a conv that feeds an affine: the stem (A), then each block's A, A and
    C (a stage's first block) or B, at the widths and strides of the
    dilated ResNet; the stages a train step trains (layer2-4 at
    ``frozen_stages`` 2) record a gradient, so a ResNet-101 train step
    runs the backward 90 times."""
    calls = _record_calls(layers, frames, (608, 1088), monkeypatch)
    assert len(calls) == 1 + 3 * sum(layers)
    assert calls[0] == (False, "A", (frames, 64, 304, 544))
    forms = ["A"]
    for blocks in layers:
        forms += ["A", "A", "C"] + ["A", "A", "B"] * (blocks - 1)
    assert [c[1] for c in calls] == forms
    assert sum(c[0] for c in calls) == 3 * sum(layers[1:])
    assert all(c[0] == (i > 3 * layers[0]) for i, c in enumerate(calls))
    assert calls[3 * layers[0]][2] == (frames, 256, 152, 272)
    assert calls[-1][2] == (frames, 2048, 38, 68)
    assert calls[-3 * layers[3] - 1][2] == (frames, 1024, 38, 68)


def _cl(shape, dtype=torch.bfloat16, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device).contiguous(
        memory_format=torch.channels_last)


def test_cuda_wrappers_check_and_raise():
    """The CUDA wrappers raise on CPU tensors (after their shape, layout,
    alignment and buffer checks, which meta tensors reach at trunk size),
    on tensors that are not channels-last, on misaligned data, on wrong
    buffers and on an unknown form; nothing is launched."""
    before = (tepi.conv_epilogue_cuda.launches,
              tepi.conv_epilogue_bwd_cuda.launches)
    s, b = torch.ones(8), torch.zeros(8)
    x = _cl((2, 8, 3, 5))
    with pytest.raises(ValueError, match="CUDA device"):
        tepi.conv_epilogue_cuda(x, s, b)
    with pytest.raises(ValueError, match="CUDA device"):
        tepi.conv_epilogue_bwd_cuda(x, x, s, "B")
    with pytest.raises(ValueError, match="channels-last"):
        tepi.conv_epilogue_cuda(torch.zeros(2, 8, 3, 5,
                                            dtype=torch.bfloat16), s, b)
    buf = torch.zeros(2 * 8 * 3 * 5 + 1, dtype=torch.bfloat16)
    odd = buf[1:].view(2, 3, 5, 8).permute(0, 3, 1, 2)
    assert odd.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tepi.conv_epilogue_cuda(odd, s, b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tepi.conv_epilogue_bwd_cuda(odd, x, s, "A")
    with pytest.raises(ValueError, match="every tensor"):
        tepi.conv_epilogue_cuda(x, s, b, _cl((2, 8, 3, 4)))
    with pytest.raises(ValueError, match="every tensor"):
        tepi.conv_epilogue_cuda(x, s, b, _cl((2, 8, 3, 5), torch.float32))
    with pytest.raises(ValueError, match="buffers"):
        tepi.conv_epilogue_cuda(x, s.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="buffers"):
        tepi.conv_epilogue_cuda(x, s, b, x, torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError, match="form"):
        tepi.conv_epilogue_bwd_cuda(x, x, s, "D")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tepi.conv_epilogue_cuda(x.half(), s, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tepi.conv_epilogue_cuda(x[0], s, b)
    meta = _cl((17, 2048, 38, 68), device="meta")
    ms, mb = torch.ones(2048, device="meta"), torch.zeros(2048, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tepi.conv_epilogue_cuda(meta, ms, mb, meta, ms, mb)
    with pytest.raises(ValueError, match="CUDA device"):
        tepi.conv_epilogue_bwd_cuda(meta, meta, ms, "C", ms)
    with pytest.raises(ValueError, match="channels-last"):
        tepi.conv_epilogue_cuda(torch.zeros(17, 2048, 38, 68,
                                            device="meta"), ms, mb)
    # a wrong buffer beside right ones, after the right set was used: a
    # view of another dtype, another dtype, another device, a stride, a
    # wrong length
    with pytest.raises(ValueError, match="CUDA device"):
        tepi.conv_epilogue_cuda(x, s, b)
    for bad in (s.view(torch.int32), s.to(torch.bfloat16),
                s.to("meta"), torch.ones(16)[::2]):
        with pytest.raises(ValueError, match="buffers"):
            tepi.conv_epilogue_cuda(x, bad, b)
    with pytest.raises(ValueError, match="buffers"):
        tepi.conv_epilogue_cuda(meta, ms, torch.zeros(2048), meta, ms, mb)
    with pytest.raises(ValueError, match="buffers"):
        tepi.conv_epilogue_bwd_cuda(x, x, s, "C", torch.ones(9))
    assert (tepi.conv_epilogue_cuda.launches,
            tepi.conv_epilogue_bwd_cuda.launches) == before


def test_codes_match_the_source():
    """The wrappers' codes are the C entries' own: the form in bits 0-1,
    bfloat16 in bit 2, and no other bit."""
    src = os.path.join(os.path.dirname(tepi.__file__), "csrc",
                       "epilogue.cu")
    with open(src) as f:
        text = f.read()
    assert "form = code & 3;" in text and "bf16 = (code >> 2) & 1;" in text
    assert "(code >> 3) == 0" in text
    assert tepi._CODES == {("A", torch.float32): 0, ("B", torch.float32): 1,
                           ("C", torch.float32): 2, ("A", torch.bfloat16): 4,
                           ("B", torch.bfloat16): 5, ("C", torch.bfloat16): 6}


def test_host_tool_records_the_trunk_calls(monkeypatch):
    """``tools/epilogue_host_torch.trunk_calls`` (the calls the host split
    and the kernel timings run) is the dispatcher's record of a
    ResNet-101 trunk call."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import epilogue_device_torch
    import epilogue_host_torch
    for frames in (1, 2):
        got = epilogue_host_torch.trunk_calls(frames)
        with monkeypatch.context() as mp:
            want = _record_calls((3, 4, 23, 3), frames, (608, 1088), mp)
        assert got == want
    calls = epilogue_host_torch.trunk_calls(17)
    ms, nbytes = epilogue_device_torch.bound_ms(calls, 2, False)
    assert nbytes == sum(
        2 * np.prod(sh) * (2 if f == "A" else 3) + 4 * sh[1] * (
            4 if f == "C" else 2) for _, f, sh in calls)
    assert 5.5 < ms < 5.7            # a 17-frame chunk's 5.5994 ms bound
