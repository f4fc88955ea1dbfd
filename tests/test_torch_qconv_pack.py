"""The int8 convolution kernel's layout on the CPU: ``pack_kernel`` (the
weights in the kernel's K order, N tiles and stages, in the 128-byte
swizzle) and ``qconv_tiling`` (M tiles, N tiles, K split by stages).

The kernel itself runs only on the card (``chip_smoke.py`` holds it bit for
bit against ``plain_qconv`` there).  Here an int64 GEMM reads the packed
bytes as the kernel does, block by block: each split of K that
``qconv_tiling`` picks is summed apart, over the activations quantized and
gathered in the packed K order, and the splits are added; the result must
equal ``plain_qconv`` exactly, at every dense conv site of the default
256x320 forward and at the shapes that the tiling makes risky.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from tod_tpu_torch.kernels import qconv as qk
from tod_tpu_torch.models.conv import same_pads
from tod_tpu_torch.models.qconv import QConv, load_prepared

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

SMS = 132  # an H100 SXM's SMs

# Every distinct dense conv site of the default 256x320 forward (batch 1):
# (Cin, H, W, Cout, k, stride, ConvBN site); test_forward_sites_are_the_models
# holds this list against the model.
FORWARD = [
    (3, 256, 320, 32, 3, 2, True),
    (32, 128, 160, 16, 1, 1, True),
    (16, 128, 160, 96, 1, 1, True),
    (96, 64, 80, 24, 1, 1, True),
    (24, 64, 80, 144, 1, 1, True),
    (144, 64, 80, 24, 1, 1, True),
    (144, 32, 40, 32, 1, 1, True),
    (32, 32, 40, 192, 1, 1, True),
    (192, 32, 40, 32, 1, 1, True),
    (192, 16, 20, 64, 1, 1, True),
    (64, 16, 20, 384, 1, 1, True),
    (384, 16, 20, 64, 1, 1, True),
    (384, 16, 20, 96, 1, 1, True),
    (96, 16, 20, 576, 1, 1, True),
    (576, 16, 20, 96, 1, 1, True),
    (576, 8, 10, 160, 1, 1, True),
    (160, 8, 10, 960, 1, 1, True),
    (960, 8, 10, 160, 1, 1, True),
    (960, 8, 10, 320, 1, 1, True),
    (320, 8, 10, 128, 1, 1, False),
    (96, 16, 20, 128, 1, 1, False),
    (32, 32, 40, 128, 1, 1, False),
    (128, 32, 40, 128, 3, 1, False),
    (128, 16, 20, 128, 3, 1, False),
    (128, 8, 10, 128, 3, 1, False),
    (128, 8, 10, 128, 3, 2, False),
    (128, 4, 5, 128, 3, 2, False),
    (128, 64, 80, 128, 3, 1, False),
    (128, 64, 80, 32, 1, 1, False),
    (128, 32, 40, 36, 3, 1, False),
    (128, 32, 40, 288, 3, 1, False),
    (128, 16, 20, 36, 3, 1, False),
    (128, 16, 20, 288, 3, 1, False),
    (128, 8, 10, 36, 3, 1, False),
    (128, 8, 10, 288, 3, 1, False),
    (128, 4, 5, 128, 3, 1, False),
    (128, 4, 5, 36, 3, 1, False),
    (128, 4, 5, 288, 3, 1, False),
    (128, 2, 3, 128, 3, 1, False),
    (128, 2, 3, 36, 3, 1, False),
    (128, 2, 3, 288, 3, 1, False),
    (128, 32, 40, 81, 1, 1, False),
]

# (batch, Cin, H, W, Cout, k, stride, ConvBN site): the shapes the tiling
# makes risky
EDGES = {
    "m_below_one_tile": (1, 128, 2, 3, 128, 3, 1, False),
    "k_not_a_stage_1x1": (1, 144, 9, 11, 24, 1, 1, True),
    "k_not_a_stage_3x3": (1, 40, 6, 7, 64, 3, 1, False),
    "cout_not_an_n_tile": (1, 128, 5, 6, 300, 3, 1, False),
    "stride2_odd": (1, 128, 5, 7, 128, 3, 2, False),
    "stride2_odd_1x1": (2, 64, 9, 7, 96, 1, 2, True),
    "cin_below_32_stem": (2, 3, 17, 23, 32, 3, 2, True),
    "cin_below_32_3x3": (1, 16, 7, 9, 40, 3, 1, False),
    "cin_below_32_1x1": (1, 24, 9, 10, 144, 1, 1, True),
    "largest_split": (1, 224, 4, 5, 128, 3, 1, False),
    "tiles_across_batch": (3, 32, 7, 9, 64, 3, 1, False),
    "batch16": (16, 128, 8, 10, 288, 3, 1, False),
    # the ResNet stem: 7x7 stride 2 from RGB, flat K = 147, a ConvBN site
    "resnet_stem_7x7": (1, 3, 30, 41, 64, 7, 2, True),
    "resnet_stem_7x7_batch2": (2, 3, 16, 16, 64, 7, 2, True),
    "dense_7x7_cin_40": (1, 40, 9, 11, 72, 7, 1, False),
}

CASES = {f"forward_{c}x{h}x{w}_to_{o}_k{k}s{s}": (1, c, h, w, o, k, s, bn)
         for c, h, w, o, k, s, bn in FORWARD}
CASES.update(EDGES)


def site_tensors(b, cin, h, w, cout, k, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((b, cin, h, w)) * 3).astype(np.float32))
    kq = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k)).astype(np.int8))
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32))
    sx = torch.from_numpy(rng.uniform(0.005, 0.055, b).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return x, kq, ws, sx, bias


def im2col_packed_order(xq: torch.Tensor, k: int, stride: int, t: qk.QConvTiling):
    """(B * Ho * Wo, n_stages * 128) int64: each output pixel's quantized
    im2col row in the packed K order, zeros past K."""
    b, cin, h, w = xq.shape
    (pt, pb), (pl, pr) = same_pads(h, k, stride), same_pads(w, k, stride)
    # (B, cin * k * k, L) in (ci, ky, kx) order
    cols = F.unfold(F.pad(xq, (pl, pr, pt, pb)), k, stride=stride)
    if not t.flat:  # (ky, kx, ci) with ci padded
        cols = cols.view(b, cin, k * k, -1).permute(0, 2, 1, 3)
        cols = F.pad(cols, (0, 0, 0, t.cin_pad - cin)).reshape(b, k * k * t.cin_pad, -1)
    assert cols.shape[1] == t.k_len
    rows = cols.permute(0, 2, 1).reshape(-1, t.k_len)
    return F.pad(rows, (0, t.n_stages * qk.STAGE_K - t.k_len)).round().long()


def unpack_tile(packed: torch.Tensor, tile: int, s0: int, s1: int) -> torch.Tensor:
    """(BN, (s1 - s0) * 128) int64: an N tile's stages s0..s1 un-swizzled."""
    part = packed[tile, s0:s1]
    part = torch.gather(part, 2, qk.swizzle_index(part.shape[1]).expand(part.shape))
    return part.permute(1, 0, 2).reshape(part.shape[1], -1).long()


def blocks(t: qk.QConvTiling):
    """Every block of the grid: (M tile, N tile, first stage, end stage)."""
    for mt in range(t.m_tiles):
        for nt in range(t.n_tiles):
            for sp in range(t.splits):
                s0 = sp * t.stages_per_split
                yield mt, nt, s0, min(t.n_stages, s0 + t.stages_per_split)


def packed_gemm(x, sx, packed, k, stride, t: qk.QConvTiling, cout) -> torch.Tensor:
    """(B, Cout, Ho, Wo) int64: the sums as the kernel forms them, each
    block's (N tile, K split) part over the packed bytes apart, then added."""
    b, _, h, w = x.shape
    a = im2col_packed_order(qk.quantize_activations(x, sx, divide=False), k, stride, t)
    acc = torch.zeros((a.shape[0], t.n_tiles * t.bn), dtype=torch.int64)
    for nt, s0, s1 in sorted({(nt, s0, s1) for _, nt, s0, s1 in blocks(t)}):
        part = a[:, s0 * qk.STAGE_K:s1 * qk.STAGE_K] @ unpack_tile(packed, nt, s0, s1).T
        acc[:, nt * t.bn:(nt + 1) * t.bn] += part
    ho, wo = -(-h // stride), -(-w // stride)
    return acc[:, :cout].reshape(b, ho, wo, cout).permute(0, 3, 1, 2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_gemm_equals_plain_qconv(case):
    """The packed weights, read tile by tile and split by split as the
    kernel reads them, times the quantized activations in the packed K
    order, summed in int64 and rescaled: equal to ``plain_qconv`` bit for
    bit in f32 and bf16 (and the sums to the float64 convolution's)."""
    b, cin, h, w, cout, k, stride, bn = CASES[case]
    x, kq, ws, sx, bias = site_tensors(b, cin, h, w, cout, k, seed=len(case))
    t = qk.qconv_tiling(b, cin, h, w, cout, k, stride, SMS)
    packed = qk.pack_kernel(kq)
    assert packed.dtype == torch.int8 and tuple(packed.shape) == qk.packed_shape(cin, cout, k)
    (pt, pb), (pl, pr) = same_pads(h, k, stride), same_pads(w, k, stride)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        acc = packed_gemm(xd, sx, packed, k, stride, t, cout)
        assert acc.abs().max() < 2 ** 31
        xq = F.pad(qk.quantize_activations(xd, sx, divide=False), (pl, pr, pt, pb))
        assert torch.equal(acc.double(), F.conv2d(xq.double(), kq.double(), None, stride))
        got = qk.epilogue(acc, sx, ws, bias, dtype, bn)
        assert torch.equal(got, qk.plain_qconv(xd, kq, ws, sx, bias, stride, 1, bn)), dtype


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiling_covers_each_tile_and_stage_once(case):
    """Every (M tile, N tile, K stage) belongs to exactly one block, no
    block is empty, the N tiles hold Cout with less than a tile to spare,
    a tile's splits fit one cluster, and the grid has no more blocks than
    SMs where the tiles alone leave half the SMs idle or more."""
    b, cin, h, w, cout, k, stride, _ = CASES[case]
    t = qk.qconv_tiling(b, cin, h, w, cout, k, stride, SMS)
    seen: dict = {}
    for mt, nt, s0, s1 in blocks(t):
        assert s1 > s0
        for s in range(s0, s1):
            seen[mt, nt, s] = seen.get((mt, nt, s), 0) + 1
    assert len(seen) == t.m_tiles * t.n_tiles * t.n_stages
    assert set(seen.values()) == {1}
    ho, wo = -(-h // stride), -(-w // stride)
    assert (t.m_tiles - 1) * qk.BM < b * ho * wo <= t.m_tiles * qk.BM
    assert (t.n_tiles - 1) * t.bn < cout <= t.n_tiles * t.bn and t.bn in qk.N_TILES
    assert t.n_tiles == 1 or cout > 256
    assert (t.k_steps - 1) * qk.STEP_K < t.k_len <= t.k_steps * qk.STEP_K
    assert (t.n_stages - 1) * 4 < t.k_steps <= t.n_stages * 4
    tiles = t.m_tiles * t.n_tiles
    assert t.blocks <= max(SMS, tiles) and t.splits <= qk.MAX_SPLITS
    if 2 * tiles <= SMS and t.n_stages > 1:
        assert t.splits > 1
    if t.flat:
        assert k in (3, 7) and cin < 32 and t.k_len == cin * k * k
    else:
        assert t.cin_pad % 32 == 0 and t.cin_pad - 32 < cin <= t.cin_pad


def test_largest_split_is_an_edge_case():
    """``EDGES['largest_split']`` reaches ``MAX_SPLITS`` (a cluster of 8
    blocks, 2 stages each, K not a whole number of stages), at least as many
    splits as any site of the forward, so the card's check reaches the
    deepest split."""
    def tiling(c, h, w, o, k, s):
        return qk.qconv_tiling(1, c, h, w, o, k, s, SMS)

    most = max(tiling(*site[:6]).splits for site in FORWARD)
    _, c, h, w, o, k, s, _ = EDGES["largest_split"]
    t = tiling(c, h, w, o, k, s)
    assert t.splits == qk.MAX_SPLITS >= most > 1
    assert t.stages_per_split == 2 and t.k_steps % 4


@pytest.mark.parametrize("shape", [(32, 3, 3, 3), (300, 40, 3, 3), (36, 16, 3, 3),
                                   (24, 144, 1, 1)])
def test_pack_kernel_swizzles_each_stage(shape):
    """Byte j of K chunk c in row r of a stage sits at chunk c ^ (r % 8),
    against the K order built with loops."""
    cout, cin, k, _ = shape
    rng = np.random.default_rng(cout + cin)
    kq = rng.integers(-127, 128, shape).astype(np.int8)
    packed = qk.pack_kernel(torch.from_numpy(kq)).numpy()
    n_tiles, n_stages, bn, row = packed.shape
    flat = k == 3 and cin < 32
    cin_pad = cin if flat else -(-cin // 32) * 32
    kmat = np.zeros((n_tiles * bn, n_stages * row), np.int8)
    for n in range(cout):
        for ci in range(cin):
            for ky in range(k):
                for kx in range(k):
                    col = (ci * k + ky) * k + kx if flat else (ky * k + kx) * cin_pad + ci
                    kmat[n, col] = kq[n, ci, ky, kx]
    for tile in range(n_tiles):
        for st in range(n_stages):
            for r in range(bn):
                for c in range(8):
                    phys = (c ^ (r % 8)) * 16
                    logical = st * 128 + c * 16
                    np.testing.assert_array_equal(packed[tile, st, r, phys:phys + 16],
                                                  kmat[tile * bn + r, logical:logical + 16])


def test_forward_sites_are_the_models():
    """``FORWARD`` is the set of dense conv sites of the default model's
    256x320 forward."""
    from tod_tpu_torch.core.config import ModelConfig
    from tod_tpu_torch.models.conv import Conv
    from tod_tpu_torch.models.yolact import Yolact

    cfg = ModelConfig()
    model = Yolact(cfg).eval()
    sites, hooks = set(), []
    for name, m in model.named_modules():
        if isinstance(m, Conv) and m.groups == 1:
            def hook(mod, inp, out, bn=name.endswith("Conv_0")):
                c, h, w = inp[0].shape[1:]
                o, _, k, _ = mod.weight.shape
                sites.add((c, h, w, o, k, mod.stride, bn))
            hooks.append(m.register_forward_hook(hook))
    with torch.inference_mode():
        model(torch.zeros((1, *cfg.input_size, 3)))
    assert sites == set(FORWARD)


def test_qconv_packed_buffer_follows_load_prepared_and_to():
    """A static dense site's packed kernel is made by ``load_prepared``,
    stays out of the state dict, moves with ``.to()`` and keeps its type;
    a depthwise site has none; ``qconv`` refuses a packed kernel of
    another shape."""
    model = nn.Sequential(QConv(16, 40, 3), QConv(40, 40, 3, groups=40, bn=True))
    rng = np.random.default_rng(3)
    state = {}
    for i, (cout, cpg) in enumerate(((40, 16), (40, 1))):
        state[f"{i}.kernel_q"] = torch.from_numpy(
            rng.integers(-127, 128, (cout, cpg, 3, 3)).astype(np.int8))
        state[f"{i}.w_scale"] = torch.full((cout,), 1e-3)
        state[f"{i}.act_scale"] = torch.tensor(0.05)
        state[f"{i}.bias"] = torch.zeros(cout)
    load_prepared(model, state)
    dense, depthwise = model[0], model[1]
    assert torch.equal(dense.packed, qk.pack_kernel(state["0.kernel_q"]))
    assert depthwise.packed is None
    assert set(model.state_dict()) == set(state)
    x = torch.from_numpy(rng.standard_normal((1, 16, 6, 7)).astype(np.float32))
    with torch.inference_mode():
        y = model(x)
    want = qk.plain_qconv(x, state["0.kernel_q"], state["0.w_scale"], state["0.act_scale"],
                          state["0.bias"])
    assert torch.equal(model[0](x), want) and y.shape == (1, 40, 6, 7)
    model.to(dtype=torch.bfloat16)
    assert dense.packed.dtype == torch.int8
    model.to("meta")
    assert dense.packed.device.type == "meta" and dense.kernel_q.device.type == "meta"
    with pytest.raises(ValueError):
        qk.qconv(x, state["0.kernel_q"], state["0.w_scale"], state["0.act_scale"],
                 state["0.bias"], packed=qk.pack_kernel(state["0.kernel_q"][:, :8].contiguous()))
    with pytest.raises(ValueError):
        qk.qconv(x[:, :1].expand(1, 40, 6, 7).contiguous(), state["1.kernel_q"],
                 state["1.w_scale"], state["1.act_scale"], state["1.bias"], groups=40,
                 packed=qk.pack_kernel(state["0.kernel_q"]))
    assert qk.qconv.launches == 0


def test_qconv_packed_buffer_follows_load_state_dict():
    """Loading another prepared state dict into a prepared model, as a whole
    or into one site, packs the new kernel: the card never reads the old
    weights' bytes."""
    model = nn.Sequential(QConv(40, 72, 3), QConv(72, 24, 1, bn=True))
    rng = np.random.default_rng(5)

    def prepared():
        state = {}
        for i, (cout, cin, k) in enumerate(((72, 40, 3), (24, 72, 1))):
            state[f"{i}.kernel_q"] = torch.from_numpy(
                rng.integers(-127, 128, (cout, cin, k, k)).astype(np.int8))
            state[f"{i}.w_scale"] = torch.full((cout,), 2e-3)
            state[f"{i}.act_scale"] = torch.tensor(0.03)
            state[f"{i}.bias"] = torch.zeros(cout)
        return state

    first, second = prepared(), prepared()
    load_prepared(model, first)
    model.load_state_dict(second)
    for i, m in enumerate(model):
        assert torch.equal(m.packed, qk.pack_kernel(second[f"{i}.kernel_q"]))
        assert not torch.equal(m.packed, qk.pack_kernel(first[f"{i}.kernel_q"]))
    model[1].load_state_dict({k[2:]: v for k, v in first.items() if k.startswith("1.")})
    assert torch.equal(model[1].packed, qk.pack_kernel(first["1.kernel_q"]))
    assert torch.equal(model[0].packed, qk.pack_kernel(second["0.kernel_q"]))
    assert set(model.state_dict()) == set(first)
