"""Weight-only int8 quantization and kernel K5: the port's ``ops/quantize.py``
against the JAX package's on the CPU.  The deterministic path and the tree
transforms are exact; the stochastic path's plain Philox is held against a
pure-Python one and by the properties of stochastic rounding (the JAX
package's K5 draws from the TPU's generator, which has no interpret mode).
The CUDA kernel is held bit for bit against the plain version on the card
(``chip_smoke.py``, and the case below that skips without CUDA)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import CAM, MODEL, PLANNER, assert_plans_close, frame, nest
from tod_tpu.core import config as jcfg
from tod_tpu.ops import quantize as jq
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.ops import ieee
from tod_tpu_torch.ops import quantize as tq

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

MASK = 0xFFFFFFFF


def philox_reference(counter: tuple[int, int, int, int], key: tuple[int, int]) -> list[int]:
    """Philox4x32-10 in Python integers (Salmon et al., SC'11)."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & MASK, (p0 >> 32) ^ c[3] ^ k[1], p0 & MASK]
        k = [(k[0] + 0x9E3779B9) & MASK, (k[1] + 0xBB67AE85) & MASK]
    return c


def weights(seed: int, n: int, c: int) -> np.ndarray:
    x = np.random.default_rng(seed).normal(0, 0.1, (n, c)).astype(np.float32)
    x[:, 3] = 0.0  # an all-zero column: scale 1e-12
    return x


def small_tree() -> dict[str, np.ndarray]:
    """A flat Flax tree: conv and dense kernels, a 1-D 'kernel' that stays
    float, biases and batch-norm leaves."""
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)  # noqa: E731
    return {
        "params/Conv_0/kernel": f(3, 3, 4, 8),
        "params/Conv_0/bias": f(8),
        "params/block_1/BatchNorm_0/scale": f(8),
        "params/block_1/Conv_0/kernel": f(1, 1, 8, 16),
        "params/block_1/odd/kernel": f(5),
        "params/block_10/Dense_0/kernel": f(16, 6),
        "params/block_1.x/Conv_0/kernel": f(3, 3, 1, 16),
        "batch_stats/block_1/BatchNorm_0/mean": f(8),
    }


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


class TestTensor:
    def test_deterministic_matches_jax(self):
        x = weights(0, 300, 37)
        q, scale = tq.quantize_tensor(torch.from_numpy(x))
        jqv, jscale = jq.quantize_tensor(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        assert q.dtype == torch.int8 and scale.shape == (1, 37)
        assert scale[0, 3].item() == np.float32(1e-12) and not q[:, 3].any()

    def test_plain_philox_matches_python_integers(self):
        # known answers of Random123's philox4x32_10
        assert philox_reference((0, 0, 0, 0), (0, 0)) == [
            0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
        assert philox_reference((MASK,) * 4, (MASK, MASK)) == [
            0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
        counters = [0, 1, 2, 3, 12345, 2**31 - 1, 2**31 + 5, MASK]
        for seed in (0, 7, MASK):
            got = tq.philox4x32(torch.tensor(counters), seed).numpy()
            want = np.array([philox_reference((c, 0, 0, 0), (seed, 0)) for c in counters])
            np.testing.assert_array_equal(got, want)
        u = tq.uniforms(10, 3)
        words = [w for c in range(3) for w in philox_reference((c, 0, 0, 0), (3, 0))][:10]
        np.testing.assert_array_equal(u.numpy(), np.float32([(w >> 8) * 2.0**-24 for w in words]))

    def test_stochastic_properties(self):
        """Scales exact; q is the floor or the ceiling of x/scale; one seed
        gives one q, another seed another; the rounding error over 64 seeds
        has a mean within 3 standard errors of 0."""
        x = torch.from_numpy(weights(1, 200, 24))
        _, det_scale = tq.quantize_tensor(x)
        q, scale = tq.quantize_tensor(x, stochastic=True, seed=5)
        assert torch.equal(scale, det_scale)
        r = (x / scale).double()
        qd = q.double()
        assert ((qd - r).abs() < 1).all()
        assert ((qd == torch.floor(r)) | (qd == torch.ceil(r))).all()
        assert torch.equal(tq.quantize_tensor(x, stochastic=True, seed=5)[0], q)
        assert not torch.equal(tq.quantize_tensor(x, stochastic=True, seed=6)[0], q)
        errs = torch.stack([tq.quantize_tensor(x, stochastic=True, seed=s)[0].double() - r
                            for s in range(64)])
        errs = errs[:, :, torch.arange(24) != 3]  # the zero column rounds exactly
        sem = errs.std() / errs.numel() ** 0.5
        assert abs(errs.mean().item()) < 3 * sem.item()

    def test_wrapper_on_cpu_runs_the_plain_version(self):
        x = torch.from_numpy(weights(2, 17, 5))
        before = tq.quantize_tensor_pallas.launches
        q, scale = tq.quantize_tensor_pallas(x, seed=9)
        pq, pscale = tq.plain_quantize_tensor_stochastic(x, seed=9)
        assert torch.equal(q, pq) and torch.equal(scale, pscale)
        assert tq.quantize_tensor_pallas.launches == before
        with pytest.raises(ValueError):
            tq.quantize_tensor_pallas(x.reshape(-1))

    @pytest.mark.parametrize("n,c", [(8, 6), (3, 7), (3, 6), (7, 5), (1, 5)])
    def test_flat_by_four_emulation_matches_plain(self, n, c):
        """csrc/quantize.cu's rule, emulated: column maxima as the int bits
        of |x| (the atomicMax route), then a thread a Philox counter g for
        the flat indices 4g .. 4g + 3, word k for index 4g + k, its column
        (4g + k) % C; numel % 4 is 0, 1, 2, 3 and 1 here."""
        x = weights(5, n, c)
        x[0, 0] = -x[0, 0] * 40  # a column whose maximum is a negative value's magnitude
        numel = n * c
        bits = np.abs(x).view(np.int32).max(axis=0)  # order as the floats, NaN last
        scale = ieee.div(torch.from_numpy(bits.view(np.float32)[None]), 127.0).clamp_min(1e-12)
        flat = torch.from_numpy(x.reshape(-1))
        q = torch.empty(numel, dtype=torch.int8)
        for g in range(-(-numel // 4)):
            words = tq.philox4x32(torch.tensor([g]), 9)[0]
            for k in range(4):
                i = 4 * g + k
                if i < numel:
                    u = (words[k] >> 8).to(torch.float32) * 2.0**-24
                    v = torch.floor(flat[i] / scale[0, i % c] + u)
                    q[i] = torch.clamp(v, -127, 127).to(torch.int8)
        pq, pscale = tq.plain_quantize_tensor_stochastic(torch.from_numpy(x), seed=9)
        assert torch.equal(scale, pscale)
        assert torch.equal(q.reshape(n, c), pq)

    def test_magnitude_bits_order_as_the_floats(self):
        """The atomicMax route's premise: for |x|, the int32 bits order as
        the float values do, through 0, subnormals, normals and +inf, and a
        NaN (sign cleared) orders above +inf, so a column's NaN wins as in
        torch.amax."""
        f32 = np.float32
        tiny = np.finfo(np.float32).smallest_subnormal
        vals = np.array([0.0, -0.0, tiny, -3 * tiny, f32(1e-39), np.finfo(np.float32).tiny,
                         f32(1e-12), -0.5, 1.0, f32(126.99), -3.4e38, np.inf, -np.inf],
                        np.float32)
        mag = np.abs(vals)
        bits = mag.view(np.int32)
        assert (bits >= 0).all()
        order = np.argsort(bits, kind="stable")
        assert (mag[order][1:] >= mag[order][:-1]).all()
        for a in mag:
            for b in mag:
                assert (a.view(np.int32) > b.view(np.int32)) == (a > b)
        nan_bits = np.abs(np.array([np.nan, -np.nan], np.float32)).view(np.int32)
        assert (nan_bits > np.float32(np.inf).view(np.int32)).all()
        col = np.array([1.0, np.nan, 5.0], np.float32)
        assert np.isnan(np.abs(col).view(np.int32).max().view(np.float32))
        assert np.isnan(torch.from_numpy(col).abs().amax().item())

    @pytest.mark.parametrize("n,c", [(1152, 288), (37, 53)])
    def test_kernel_matches_plain_on_cuda(self, n, c):
        require_cuda()
        x = torch.from_numpy(weights(3, n, c)).cuda()
        q, scale = tq.quantize_tensor_pallas(x, seed=4)
        pq, pscale = tq.plain_quantize_tensor_stochastic(x, seed=4)
        assert torch.equal(q, pq) and torch.equal(scale, pscale)


class TestTree:
    def test_params_round_trip_matches_jax(self):
        tree = small_tree()
        qt = tq.quantize_params(tree, device="cpu")
        jqt = jq.quantize_params(nest(tree))
        quantized = {k for k, v in qt.items() if isinstance(v, dict)}
        assert quantized == {k for k in tree if k.endswith("kernel") and tree[k].ndim >= 2}
        for key in quantized:
            leaf = jqt
            for part in key.split("/"):
                leaf = leaf[part]
            np.testing.assert_array_equal(qt[key]["q"].numpy(), np.asarray(leaf["q"]))
            np.testing.assert_array_equal(qt[key]["scale"].numpy(), np.asarray(leaf["scale"]))
            assert qt[key]["shape"] == leaf["shape"]
        assert tq.quantized_size_bytes(qt) == jq.quantized_size_bytes(jqt)
        back = tq.dequantize_params(qt)
        jback = jq.dequantize_params(jqt)
        flat = {"/".join(p.key for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(jback)[0]}
        assert set(back) == set(flat) == set(tree)
        for key in tree:
            np.testing.assert_array_equal(back[key], flat[key])
            assert back[key].dtype == np.float32

    def test_stochastic_seeds_follow_the_flattening_order(self):
        """Leaf i of the nested tree's flattening gets seed ``seed + i``."""
        tree = small_tree()
        qt = tq.quantize_params(tree, stochastic=True, seed=3, device="cpu")
        order = [("/".join(p.key for p in path))
                 for path, _ in jax.tree_util.tree_flatten_with_path(nest(tree))[0]]
        for i, key in enumerate(order):
            if isinstance(qt[key], dict):
                x2d = torch.from_numpy(tree[key]).reshape(-1, tree[key].shape[-1])
                q, _ = tq.plain_quantize_tensor_stochastic(x2d, seed=3 + i)
                assert torch.equal(qt[key]["q"], q), key


@pytest.fixture(scope="module")
def dequantized_engines():
    """The JAX engine and the port's CPU engine on the same tree: the pinned
    weights quantized (round to nearest) and dequantized by the port."""
    from tod_tpu.runtime.engine import Engine as JaxEngine
    from tod_tpu_torch.core.weights import carry_across, read_tree
    from tod_tpu_torch.runtime.engine import Engine

    tree = tq.dequantize_params(tq.quantize_params(read_tree(), device="cpu"))
    jax_engine = JaxEngine(
        jcfg.PipelineConfig(camera=jcfg.CameraConfig(**CAM), model=jcfg.ModelConfig(**MODEL),
                            planner=jcfg.PlannerConfig(**PLANNER)),
        nest(tree), use_pallas=False,
    )
    port = Engine(
        tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM), model=tcfg.ModelConfig(**MODEL),
                            planner=tcfg.PlannerConfig(**PLANNER)),
        carry_across(tree), device="cpu",
    )
    return jax_engine, port, tree


def test_engine_on_dequantized_weights_matches_jax(dequantized_engines):
    """One frame through ``serve_step_plan`` on the int8-rounded pinned
    weights, within the tolerances of the f32 engines' comparison."""
    from tod_tpu_torch.core.weights import read_tree
    from tod_tpu_torch.ops.preprocess import pack_frame

    jax_engine, port, tree = dequantized_engines
    key = "params/PredictionHead_0/coeff/kernel"
    assert not np.array_equal(tree[key], read_tree()[key])  # the weights were rounded
    f = frame(0)
    packed = pack_frame(f.rgb, f.depth)
    want = np.asarray(jax_engine._serve_step_plan_fn(jax_engine.params, jnp.asarray(packed)))
    got = port.serve_step_plan(torch.from_numpy(packed))
    assert int(want[0, 0]) > 5
    assert_plans_close(got.numpy(), want)
