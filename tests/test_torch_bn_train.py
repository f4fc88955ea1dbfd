"""The training ConvBN's BatchNorm + ReLU6 + cast (``kernels/bn_train.py``).

On the CPU: the kernel's closed-form forward and backward, mirrored in
float64, against autograd of the plain graph (``TrainBatchNorm``, ``relu6``
and the cast, as ``ConvBN`` ran them before the kernel); ``ConvBN``'s
dispatch and the channels-last layout every training form hands it; the
tiling and the wrapper's refusals.  The cases that need a card
hold ``csrc/bn_train.cu`` against ``plain_bn_act`` and skip here;
``chip_smoke.py`` holds it at every site of the batch-16 480x640 step."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tod_tpu_torch.kernels.bn_train import (
    BN_EPS,
    BN_MOMENTUM,
    THREADS,
    _check,
    bn_act,
    bn_tiling,
    plain_bn_act,
    relu6,
    vector_bytes,
)
from tod_tpu_torch.models.conv import Training
from tod_tpu_torch.models.mobilenetv2 import ConvBN
from tod_tpu_torch.models.resnet import TrainBatchNorm
from tod_tpu_torch.runtime.profiler import SPANS

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def inputs(shape, dtype, seed=0, device="cpu", fmt=torch.contiguous_format):
    """x (N, C, H, W) with per-channel offsets and spreads, dy (both in
    memory format ``fmt``), and the parameters and running statistics a
    trained site might hold."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 3, (1, c, 1, 1))
         + rng.uniform(-2, 2, (1, c, 1, 1)))
    dy = rng.standard_normal(shape)
    scale = rng.uniform(0.5, 2.5, c)
    bias = rng.uniform(-1, 4, c)
    mean, var = rng.uniform(-1, 1, c), rng.uniform(0.5, 2, c)
    t = lambda a, d=torch.float32: torch.tensor(a, dtype=d, device=device)  # noqa: E731
    return (t(x, dtype).contiguous(memory_format=fmt), t(dy, dtype).contiguous(memory_format=fmt),
            t(scale), t(bias), t(mean), t(var))


def old_graph(x, scale, bias, mean, var, act):
    """``ConvBN``'s training form before the kernel: ``TrainBatchNorm``,
    ``relu6``, the cast -> (y, the BatchNorm module)."""
    bn = TrainBatchNorm(x.shape[1]).to(x.device)
    with torch.no_grad():
        for name, v in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
            getattr(bn, name).copy_(v)
    bn.train()
    y = bn(x)
    return (relu6(y) if act else y).to(x.dtype), bn


def closed_form(x, dy, scale, bias, mean, var, act):
    """The kernel's arithmetic (``csrc/bn_train.cu``) in float64: y before
    the cast, dx, dscale, dbias and the running statistics."""
    xd, g, sc, b = x.double(), dy.double(), scale.double(), bias.double()
    m = x.shape[0] * x.shape[2] * x.shape[3]
    dims = (0, 2, 3)
    mu = xd.mean(dims)
    raw = (xd * xd).mean(dims) - mu * mu
    keep = raw >= 0
    v = raw.clamp_min(0)
    r = 1 / torch.sqrt(v + BN_EPS)
    mul = r * sc
    pre = (xd - mu.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    y = pre
    if act:
        y = torch.where(pre > 0, torch.where(pre < 6, pre, 6.0), torch.where(pre <= 0, 0.0, pre))
        g = torch.where((pre > 0) & (pre < 6), g, 0.0)
    xh = (xd - mu.view(1, -1, 1, 1)) * r.view(1, -1, 1, 1)
    sg, sgx = g.sum(dims), (g * xh).sum(dims)
    t2 = torch.where(keep, sgx / m, 0.0)
    dx = mul.view(1, -1, 1, 1) * (g - (sg / m).view(1, -1, 1, 1) - xh * t2.view(1, -1, 1, 1))
    run_mean = BN_MOMENTUM * mean.double() + (1 - BN_MOMENTUM) * mu
    run_var = BN_MOMENTUM * var.double() + (1 - BN_MOMENTUM) * v
    return y, dx, sgx, sg, run_mean, run_var


def old_graph_grads(x, dy, scale, bias, mean, var, act):
    """The old graph's y, dx, dscale, dbias, running mean and var."""
    x = x.clone().requires_grad_(True)
    y, bn = old_graph(x, scale, bias, mean, var, act)
    grads = torch.autograd.grad((y.float() * dy.float()).sum(), (x, bn.scale, bn.bias))
    return y.detach(), *grads, bn.mean, bn.var


def assert_near(got, want, rel: float, atol: float) -> None:
    """|got - want| <= rel * |want| + atol, element by element."""
    gap = (got.detach().double() - want.detach().double()).abs()
    worst = float((gap - rel * want.detach().double().abs()).max())
    assert worst <= atol, (worst, atol)


# bf16 values rounded from f32 on one side and from float64 (or from other
# f32 sums) on the other differ by at most one bf16 step, 2**-7 of the value
BF16_STEP = 2.0**-7


def hold(shape, dtype, act, x=None, seed=0):
    """The closed form against the old graph's autograd.  f32: 2e-5 of the
    largest magnitude (f32 sums of a few thousand terms in another order
    than float64's, and the cancellations in y and dx).  bf16: y and dx
    within one bf16 step (f32 and float64 round to bf16 differently where a
    value sits near a rounding boundary) and that same 2e-5; the f32
    parameter gradients within 2e-5 of their largest."""
    xs, dy, scale, bias, mean, var = inputs(shape, dtype, seed)
    if x is not None:
        xs = x.to(dtype)
    y, dx, dscale, dbias, run_mean, run_var = old_graph_grads(xs, dy, scale, bias, mean, var, act)
    cy, cdx, cdscale, cdbias, cmean, cvar = closed_form(xs, dy, scale, bias, mean, var, act)
    rel = BF16_STEP if dtype == torch.bfloat16 else 0.0
    for got, want in ((y, cy), (dx, cdx)):
        assert_near(got, want, rel, 2e-5 * float(want.abs().max()))
    for got, want in ((dscale, cdscale), (dbias, cdbias)):
        torch.testing.assert_close(got.double(), want, atol=2e-5 * float(want.abs().max()) + 1e-6,
                                   rtol=0)
    torch.testing.assert_close(run_mean.double(), cmean, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(run_var.double(), cvar, atol=1e-6, rtol=1e-6)


class TestClosedForm:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    @pytest.mark.parametrize("act", [True, False], ids=["relu6", "linear"])
    def test_against_the_old_graph(self, dtype, act):
        hold((4, 6, 8, 10), dtype, act)

    @pytest.mark.parametrize("shape", [(3, 5, 5, 7), (1, 1, 9, 11), (2, 960, 5, 7)],
                             ids=["hw35", "c1", "c960"])
    def test_shapes(self, shape):
        """N * H * W not a multiple of 8 (nor H * W), C = 1, C = 960."""
        hold(shape, torch.float32, True, seed=1)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    def test_constant_channel(self, dtype):
        """Channel 0 constant: its variance is E[x^2] - E[x]^2 of equal
        values, 0 up to rounding and clipped where that is negative; y is
        the bias there and dx the centred dy times mul."""
        xs = inputs((4, 3, 6, 5), torch.float32, 2)[0]
        xs[:, 0] = 0.1
        hold(xs.shape, dtype, True, x=xs, seed=2)

    def test_pre_activations_at_0_and_6(self):
        """Channels whose mean is exactly 0 (values -2, 0, 2, summed exactly
        in f32) and whose bias is 0 or 6 put y exactly on relu6's bounds
        where x is 0: the gradient stops there in both."""
        n, c, h, w = 2, 2, 4, 6
        vals = torch.tensor([-2.0, 0.0, 2.0, 0.0]).repeat(n * h * w // 4)
        x = vals.view(n, 1, h, w).expand(n, c, h, w).contiguous()
        dy = torch.ones(n, c, h, w)
        scale, bias = torch.ones(c), torch.tensor([0.0, 6.0])
        mean, var = torch.zeros(c), torch.ones(c)
        y, dx, *_ = old_graph_grads(x, dy, scale, bias, mean, var, True)
        cy, cdx, *_ = closed_form(x, dy, scale, bias, mean, var, True)
        at = x == 0
        assert bool((y[:, 0][at[:, 0]] == 0).all()) and bool((y[:, 1][at[:, 1]] == 6).all())
        assert bool((cy[:, 0][at[:, 0]] == 0).all()) and bool((cy[:, 1][at[:, 1]] == 6).all())
        torch.testing.assert_close(dx.double(), cdx, atol=1e-6, rtol=0)

    def test_plain_bn_act_is_the_old_graph_bit_for_bit(self):
        x, _, scale, bias, mean, var = inputs((2, 4, 5, 6), torch.bfloat16, 3)
        want, bn = old_graph(x, scale, bias, mean, var, True)
        m, v = mean.clone(), var.clone()
        got = plain_bn_act(x, scale, bias, m, v, True)
        assert torch.equal(got, want) and torch.equal(m, bn.mean) and torch.equal(v, bn.var)


def site(act=True, dtype=torch.float32):
    torch.manual_seed(0)
    m = ConvBN(4, 6, kernel=3, act=act, quantized=Training(dtype))
    with torch.no_grad():
        m.Conv_0.weight.normal_(0, 0.3)
        m.BatchNorm_0.scale.uniform_(0.5, 2)
        m.BatchNorm_0.bias.uniform_(-1, 3)
    return m


class TestConvBNDispatch:
    def counts(self):
        return SPANS.counter("train/bn_sites"), SPANS.counter("train/bn_fused")

    @pytest.mark.parametrize("act", [True, False], ids=["relu6", "linear"])
    def test_cpu_takes_the_plain_graph(self, act):
        m, x = site(act), torch.randn(2, 4, 9, 7).contiguous(memory_format=torch.channels_last)
        ref = site(act)
        sites, fused = self.counts()
        launches = bn_act.launches
        got = m(x)
        want = plain_bn_act(ref.Conv_0(x), ref.BatchNorm_0.scale, ref.BatchNorm_0.bias,
                            ref.BatchNorm_0.mean, ref.BatchNorm_0.var, act)
        assert torch.equal(got, want)
        assert torch.equal(m.BatchNorm_0.mean, ref.BatchNorm_0.mean)
        assert self.counts() == (sites + 1, fused) and bn_act.launches == launches

    def test_moments_over_keeps_the_old_graph(self, monkeypatch):
        from tod_tpu_torch.kernels import bn_train

        def refuse(*_):
            raise AssertionError("the dp path must not take the kernel pair")

        monkeypatch.setattr(bn_train._BNAct, "apply", refuse)
        m, x = site(), torch.randn(2, 4, 9, 7).contiguous(memory_format=torch.channels_last)
        seen = []

        def moments(xf):
            seen.append(xf.shape)
            return xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))

        m.BatchNorm_0.moments_over = moments
        ref = site()
        sites, fused = self.counts()
        got = m(x)
        want, _ = old_graph(ref.Conv_0(x), ref.BatchNorm_0.scale, ref.BatchNorm_0.bias,
                            ref.BatchNorm_0.mean, ref.BatchNorm_0.var, True)
        assert seen == [(2, 6, 9, 7)] and not got.isnan().any() and torch.equal(got, want)
        assert self.counts() == (sites + 1, fused)

    def test_eval_takes_the_running_statistics(self):
        m, x = site(), torch.randn(2, 4, 9, 7)
        m.eval()
        sites, fused = self.counts()
        bn = m.BatchNorm_0
        y = m(x)
        conv = m.Conv_0(x)
        want = relu6((conv.float() - bn.mean.view(1, -1, 1, 1))
                     * (torch.rsqrt(bn.var + BN_EPS) * bn.scale).view(1, -1, 1, 1)
                     + bn.bias.view(1, -1, 1, 1))
        assert torch.equal(y, want.to(conv.dtype)) and self.counts() == (sites, fused)

    @pytest.mark.parametrize("form", ["plain", "s2d_stem", "depthwise_shifted", "qat"])
    def test_every_training_form_hands_channels_last(self, form, monkeypatch):
        """The s2d stem and the shifted depthwise compute NCHW, the plain
        and QAT convs keep the NHWC input's channels last: every site of
        each form hands ``bn_act`` a channels-last tensor, the one layout
        the kernel pair takes."""
        import tod_tpu_torch.models.mobilenetv2 as mnv2
        from tod_tpu_torch.core.config import ModelConfig
        from tod_tpu_torch.models.yolact import Yolact

        flags = {"plain": {}, "qat": dict(qat=True, quantized=True)}.get(form, {form: True})
        cfg = ModelConfig(input_size=(48, 64), fpn_channels=16, proto_channels=16,
                          head_channels=16, width_mult=0.35, num_prototypes=8, **flags)
        torch.manual_seed(0)
        model = Yolact(cfg, train=True).train()
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0, 0.1)
        seen = []

        def record(x, *args):
            seen.append(x.is_contiguous(memory_format=torch.channels_last))
            return bn_act(x, *args)

        monkeypatch.setattr(mnv2, "bn_act", record)
        model(torch.randn(2, 48, 64, 3))
        sites = sum(isinstance(m, ConvBN) for m in model.modules())
        assert len(seen) == sites > 0 and all(seen)


class TestTiling:
    # every BatchNorm site of the batch-16 480x640 step: (C, H, W)
    SITES = [(32, 240, 320), (16, 240, 320), (96, 240, 320), (96, 120, 160), (24, 120, 160),
             (144, 120, 160), (144, 60, 80), (32, 60, 80), (192, 60, 80), (192, 30, 40),
             (64, 30, 40), (384, 30, 40), (96, 30, 40), (576, 30, 40), (576, 15, 20),
             (160, 15, 20), (960, 15, 20), (320, 15, 20)]

    @pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
    @pytest.mark.parametrize("c,h,w", SITES)
    def test_cell_sites_fill_the_card(self, c, h, w, itemsize):
        """Every row in exactly one block of each pass, no block empty;
        16-byte loads; groups of at most 32 vectors of a row, the statistics
        pass a block an SM and the apply pass eight, or no block with fewer
        rows than it takes at once."""
        t = bn_tiling((16, c, h, w), itemsize, 0, 132)
        assert t.bytes == 16 and t.rows == 16 * h * w
        vectors = c * itemsize // t.bytes
        for per, slices in ((t.per, t.slices), (t.apply_per, t.apply_slices)):
            assert per * slices >= t.rows > per * (slices - 1)
        assert t.group <= 32 and t.group * t.tickets >= vectors > t.group * (t.tickets - 1)
        rows = THREADS // t.group
        assert t.slices * t.tickets >= 132 or t.per >= rows
        assert t.apply_slices * t.tickets >= 132 * 8 or t.apply_per >= rows

    def test_alignment_narrows_the_loads(self):
        assert bn_tiling((2, 64, 4, 4), 2, 8, 132).bytes == 8
        assert bn_tiling((2, 64, 4, 4), 2, 2, 132).bytes == 2

    @pytest.mark.parametrize("elems,itemsize,align,want", [
        (35, 2, 0, 2), (35, 4, 0, 4), (300, 2, 0, 8), (300, 4, 0, 16), (64, 2, 8, 8),
        (64, 2, 2, 2), (64, 4, 4, 4)])
    def test_vector_bytes(self, elems, itemsize, align, want):
        assert vector_bytes(elems, itemsize, align) == want

    def test_small_channel_is_one_slice(self):
        assert bn_tiling((1, 3, 5, 7), 4, 0, 132).slices == 1
        assert bn_tiling((1, 3, 5, 7), 2, 0, 132).slices == 1


class TestBinding:
    @pytest.mark.parametrize("name", ["tod_bn_forward", "tod_bn_backward"])
    def test_signature_matches_the_source(self, name):
        """The ctypes argument types, one for each parameter that the
        ``extern "C"`` function in ``csrc/bn_train.cu`` declares."""
        import ctypes
        import pathlib
        import re

        from tod_tpu_torch.kernels.bn_train import SIGNATURES

        src = (pathlib.Path(__file__).parents[1] / "tod_tpu_torch/csrc/bn_train.cu").read_text()
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1).split(",")
        kinds = {"float": ctypes.c_float, "int": ctypes.c_int}
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]] for p in params]
        assert SIGNATURES[name] == (want, ctypes.c_int)


class TestRefusals:
    """What the wrapper takes on the card, checked before any launch; on
    the CPU ``bn_act`` runs the plain graph on anything."""

    BAD = ["float16", "nchw", "strided", "3d", "param_dtype", "param_shape"]

    def case(self, bad, device):
        x = torch.randn(2, 4, 6, 8, device=device).contiguous(memory_format=torch.channels_last)
        c = x.shape[1]
        params = [torch.ones(c, device=device), torch.zeros(c, device=device),
                  torch.zeros(c, device=device), torch.ones(c, device=device)]
        if bad == "float16":
            x = x.half()
        elif bad == "nchw":
            x = x.contiguous()
        elif bad == "strided":
            x = x[..., ::2]
        elif bad == "3d":
            x = x[0]
        elif bad == "param_dtype":
            params[0] = params[0].double()
        elif bad == "param_shape":
            params[1] = params[1][:3]
        return x, params

    @pytest.mark.parametrize("bad", BAD)
    def test_checks(self, bad):
        x, params = self.case(bad, "cpu")
        with pytest.raises(ValueError):
            _check(x, params)

    def test_layouts_taken(self):
        """Channels last, which an (N, C, 1, 1) tensor is in either layout."""
        x, params = self.case(None, "cpu")
        _check(x, params)
        _check(torch.randn(2, 4, 1, 1), params)

    @pytest.mark.parametrize("bad", BAD)
    def test_cuda_refuses(self, bad):
        require_cuda()
        x, params = self.case(bad, "cuda")
        launches = bn_act.launches
        with pytest.raises(ValueError):
            bn_act(x, *params, True)
        assert bn_act.launches == launches


class TestOnCard:
    @pytest.mark.parametrize("shape", [(4, 6, 8, 10), (3, 5, 5, 7), (2, 960, 15, 20),
                                       (1, 1, 9, 11)], ids=["8x10", "5x7", "c960", "c1"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    def test_kernel_against_plain(self, shape, dtype):
        """y and the running statistics bit for bit (torch's reductions for
        the statistics, each step rounded as the plain graph rounds it); dx
        within one bf16 step where the rounding flips and 2e-5 of its
        largest, the f32 parameter gradients within 1e-5 of their largest
        (the backward's f32 sums in another order); twice the same bits."""
        require_cuda()
        for act in (True, False):
            runs = []
            for _ in range(2):
                x, dy, scale, bias, mean, var = inputs(shape, dtype, 4, "cuda", torch.channels_last)
                x.requires_grad_(True)
                scale.requires_grad_(True)
                bias.requires_grad_(True)
                launches = bn_act.launches
                y = bn_act(x, scale, bias, mean, var, act)
                grads = torch.autograd.grad((y.float() * dy.float()).sum(), (x, scale, bias))
                assert bn_act.launches == launches + 3
                runs.append((y, *grads, mean, var))
            for a, b in zip(*runs):
                assert torch.equal(a, b)
            x, dy, scale, bias, mean, var = inputs(shape, dtype, 4, "cuda", torch.channels_last)
            want = old_graph_grads(x, dy, scale, bias, mean, var, act)
            y, dx, dscale, dbias, rmean, rvar = runs[0]
            assert torch.equal(y, want[0])
            assert torch.equal(rmean, want[4]) and torch.equal(rvar, want[5])
            rel = BF16_STEP if dtype == torch.bfloat16 else 0.0
            assert_near(dx, want[1], rel, 2e-5 * float(want[1].float().abs().max()))
            for got, ref in ((dscale, want[2]), (dbias, want[3])):
                torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()) + 1e-6,
                                           rtol=0)
