"""The port's weights: the committed npz against the JAX checkpoint, and the
carry-across (BatchNorm fold + layout) against ``fold_batchnorm``.

Run ``python tests/test_torch_weights.py --write`` to rewrite
``tod_tpu_torch/weights/yolact_dr.npz`` from ``checkpoints/yolact_dr``, and
``python tests/test_torch_weights.py --write CKPT_DIR OUT.npz`` to convert
another checkpoint of the JAX package for the port's ``--checkpoint``.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_LEAVES = 291  # batch_stats + params of the pinned yolact_mnv2_fpn tree


def flat_checkpoint_tree(path=ROOT / "checkpoints" / "yolact_dr") -> dict[str, np.ndarray]:
    """A checkpoint (``checkpoints/yolact_dr`` by default) through the JAX
    package's loader, flattened to ``params/...`` / ``batch_stats/...``
    keys."""
    import jax

    from tod_tpu.train.checkpoint import load_checkpoint

    tree = load_checkpoint(path)
    return {
        "/".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def write_npz(ckpt=ROOT / "checkpoints" / "yolact_dr", out=None) -> pathlib.Path:
    """Write the flat tree of ``ckpt`` to ``out`` (the pinned npz by
    default)."""
    from tod_tpu_torch.core.weights import PINNED

    out = pathlib.Path(out or PINNED)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flat_checkpoint_tree(ckpt))
    return out


@pytest.fixture(scope="module")
def pinned_tree():
    from tod_tpu_torch.core.weights import read_tree

    return read_tree()


@pytest.fixture(scope="module")
def model():
    from tod_tpu_torch.core.config import ModelConfig
    from tod_tpu_torch.models.yolact import Yolact

    return Yolact(ModelConfig())


class TestPinnedWeights:
    def test_npz_equals_checkpoint_bitwise(self, pinned_tree):
        ref = flat_checkpoint_tree()
        assert sorted(pinned_tree) == sorted(ref)
        for key, want in ref.items():
            got = pinned_tree[key]
            assert got.dtype == np.float32 and want.dtype == np.float32, key
            assert got.shape == want.shape, key
            assert got.tobytes() == want.tobytes(), key

    def test_carry_across_consumes_every_leaf(self, pinned_tree, model):
        from tod_tpu_torch.core.weights import carry_across

        assert len(pinned_tree) == N_LEAVES
        state = carry_across(pinned_tree, model)
        assert set(state) == set(model.state_dict())
        # every conv site yields a weight and a bias
        n_kernels = sum(k.endswith("/kernel") for k in pinned_tree)
        assert len(state) == 2 * n_kernels

    def test_load_pinned_fills_default_model(self, model):
        from tod_tpu_torch.core.weights import check_state, load_pinned

        state = load_pinned()
        check_state(model, state)
        assert all(t.dtype.is_floating_point and t.device.type == "cpu" for t in state.values())

    def test_fold_and_layout_match_fold_batchnorm(self, pinned_tree):
        """Exact: the same float64 fold, then a pure transpose HWIO -> OIHW."""
        from tod_tpu.models.prepare import fold_batchnorm
        from tod_tpu_torch.core.weights import carry_across

        nested: dict = {}
        for key, v in pinned_tree.items():
            d = nested
            *parts, last = key.split("/")
            for p in parts:
                d = d.setdefault(p, {})
            d[last] = v
        folded = fold_batchnorm(nested)["params"]
        state = carry_across(pinned_tree)

        def site(path):
            d = folded
            for p in path.split("."):
                d = d[p]
            return d

        for name, tensor in state.items():
            path, kind = name.rsplit(".", 1)
            if kind == "weight":
                want = np.asarray(site(path)["kernel"]).transpose(3, 2, 0, 1)
            elif path.endswith("Conv_0"):
                want = np.asarray(site(path.rsplit(".", 1)[0])["BatchNorm_0"]["bias"])
            else:
                want = np.asarray(site(path)["bias"])
            np.testing.assert_array_equal(tensor.numpy(), want, err_msg=name)


class TestCarryAcrossRaises:
    def test_missing_leaf(self, pinned_tree, model):
        from tod_tpu_torch.core.weights import carry_across

        tree = dict(pinned_tree)
        del tree["batch_stats/MobileNetV2_0/ConvBN_0/BatchNorm_0/var"]
        with pytest.raises(KeyError, match="missing"):
            carry_across(tree, model)

    def test_missing_conv_site(self, pinned_tree, model):
        from tod_tpu_torch.core.weights import carry_across

        tree = {k: v for k, v in pinned_tree.items() if "/lat3/" not in k}
        with pytest.raises(ValueError, match="missing"):
            carry_across(tree, model)

    def test_extra_leaf(self, pinned_tree, model):
        from tod_tpu_torch.core.weights import carry_across

        tree = dict(pinned_tree)
        tree["params/FPN_0/lat3/extra"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="not consumed"):
            carry_across(tree, model)

    def test_misshaped_leaf(self, pinned_tree, model):
        from tod_tpu_torch.core.weights import carry_across

        tree = dict(pinned_tree)
        tree["params/FPN_0/lat3/kernel"] = np.zeros((1, 1, 32, 64), np.float32)
        tree["params/FPN_0/lat3/bias"] = np.zeros((64,), np.float32)
        with pytest.raises(ValueError, match="shape"):
            carry_across(tree, model)

    def test_missing_file(self, tmp_path):
        from tod_tpu_torch.core.weights import load_pinned

        with pytest.raises(FileNotFoundError):
            load_pinned(tmp_path / "absent.npz")


if __name__ == "__main__":
    args = sys.argv[1:]
    if not args or args[0] != "--write" or len(args) not in (1, 3):
        sys.exit("usage: python tests/test_torch_weights.py --write [CKPT_DIR OUT.npz]")
    sys.path.insert(0, str(ROOT))
    print("wrote", write_npz(*args[1:]))
