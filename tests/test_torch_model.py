"""The port's YOLACT forward against ``Yolact.apply`` of the JAX package, in
float32 on the CPU, with the same pinned weights folded on both sides."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.core.config import ModelConfig as JaxModelConfig
from tod_tpu.models.prepare import fold_batchnorm
from tod_tpu.models.yolact import Yolact as JaxYolact
from tod_tpu_torch.core.config import ModelConfig
from tod_tpu_torch.core.weights import carry_across, read_tree
from tod_tpu_torch.models.conv import same_pads
from tod_tpu_torch.models.yolact import Yolact

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)


def nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        d = out
        *parts, last = key.split("/")
        for p in parts:
            d = d.setdefault(p, {})
        d[last] = v
    return out


@pytest.fixture(scope="module")
def weights():
    flat = read_tree()
    return flat, fold_batchnorm(nest(flat))


@pytest.mark.parametrize("size,k,s", [(s, k, st) for s in (5, 8, 9, 64) for k in (1, 3) for st in (1, 2)])
def test_same_pads_match_flax(size, k, s):
    want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert same_pads(size, k, s) == tuple(want)


# (64, 80) keeps every level even; (72, 88) gives odd levels (9x11, 5x6,
# 3x3, 2x2, 1x1), where SAME padding is symmetric at stride 2.
@pytest.mark.parametrize("input_hw", [(64, 80), (72, 88)])
def test_forward_matches_flax(weights, input_hw):
    flat, folded = weights
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, *input_hw, 3)).astype(np.float32)

    want = JaxYolact(JaxModelConfig(input_size=input_hw, dtype="float32")).apply(
        folded, jnp.asarray(x), train=False
    )
    model = Yolact(ModelConfig(input_size=input_hw, dtype="float32"))
    model.load_state_dict(carry_across(flat, model))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))

    for field in ("loc", "conf", "coeff", "prototypes", "sem_logits"):
        a = getattr(got, field).numpy()
        b = np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        # f32 convolutions summed in another order through ~60 layers; the
        # outputs are O(1-10), so 2e-4 absolute is a few hundred ulps
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4, err_msg=field)
