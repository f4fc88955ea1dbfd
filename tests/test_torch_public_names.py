"""The public names the port keeps beside its JAX counterparts' modules:
``planner/api.py`` ``dispatch_plan_device`` / ``plan_directions_device``,
``core/types.py`` ``empty_scene``, ``ops/masks.py`` ``threshold_masks``,
``ops/nms.py`` ``greedy_nms_reference``, ``track/tracker.py``
``track_update_oracle`` and ``bench/profiling.py``
``profile_flagship_forward``, each against the JAX package's on the CPU."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import assert_plans_close, planner_scene
from test_torch_track import step_balls
from tod_tpu.core import config as jcfg
from tod_tpu_torch.core import config as tcfg

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)


@pytest.mark.parametrize("signed", [False, True])
def test_device_plan_matches_jax(signed):
    """The plan buffer and the Path, at the JAX planner's tolerances
    (``test_torch_pipeline.py``), from the config's start node and from a
    given one."""
    from tod_tpu.planner import api as japi
    from tod_tpu_torch.planner import api as tapi

    hm, balls = planner_scene()
    for start in (None, (40, 20)):
        jc = jcfg.PlannerConfig(max_path_steps=256, signed_turns=signed)
        tc = tcfg.PlannerConfig(max_path_steps=256, signed_turns=signed)
        want = np.asarray(japi.dispatch_plan_device(jnp.asarray(hm), jnp.asarray(balls), jc,
                                                    start))
        got = tapi.dispatch_plan_device(torch.from_numpy(hm), torch.from_numpy(balls), tc, start)
        assert isinstance(got, torch.Tensor) and got.shape == (257, 2)
        assert int(want[0, 0]) > 3
        assert_plans_close(got.numpy(), want)
        wpath = japi.plan_directions_device(jnp.asarray(hm), jnp.asarray(balls), jc, start)
        gpath = tapi.plan_directions_device(torch.from_numpy(hm), torch.from_numpy(balls), tc,
                                            start)
        assert len(gpath.directions) == len(wpath.directions)
        assert gpath.truncated == wpath.truncated
        np.testing.assert_allclose(np.asarray(gpath.directions)[:, 1],
                                   np.asarray(wpath.directions)[:, 1], atol=1e-4, rtol=0)


def test_empty_scene_matches_jax():
    from tod_tpu.core.types import empty_scene as jax_empty
    from tod_tpu_torch.core.types import empty_scene

    for args in ((4, 6), (3, 5, 7)):
        got, want = empty_scene(*args), jax_empty(*args)
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)


def test_threshold_masks_matches_jax():
    from tod_tpu.ops.masks import threshold_masks as jax_threshold
    from tod_tpu_torch.ops.masks import threshold_masks

    m = np.random.default_rng(0).uniform(0, 1, (3, 9, 11)).astype(np.float32)
    m[0, 0, :3] = [0.5, np.nextafter(np.float32(0.5), np.float32(1)), 0.25]
    for thr in (0.5, 0.25):
        got = threshold_masks(torch.from_numpy(m), thr)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_threshold(jnp.asarray(m), thr)))


def test_greedy_nms_reference_matches_jax():
    from tod_tpu.ops.nms import greedy_nms_reference as jax_greedy
    from tod_tpu_torch.ops.nms import greedy_nms_reference

    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 40):
        yx = rng.uniform(0, 0.8, (n, 2))
        boxes = np.concatenate([yx, yx + rng.uniform(0.05, 0.3, (n, 2))], axis=1)
        scores = rng.uniform(0, 1, n)
        for thr in (0.3, 0.5):
            assert greedy_nms_reference(boxes, scores, thr) == jax_greedy(boxes, scores, thr)


def test_track_update_oracle_matches_jax():
    """200 steps of both oracles from the same banks and balls: bit for bit."""
    from tod_tpu.track import track_update_oracle as jax_oracle
    from tod_tpu_torch.track.tracker import track_update_oracle

    jc, tc = jcfg.TrackerConfig(enabled=True), tcfg.TrackerConfig(enabled=True)
    rng = np.random.default_rng(7)
    bank = np.zeros((8, 10), np.float32)
    for step in range(200):
        balls = step_balls(rng, 8, clustered=step % 2 == 0)
        got = track_update_oracle(bank, balls, tc)
        want = jax_oracle(bank, balls, jc)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        bank = want
    assert bank[:, 9].any()


def test_profile_flagship_forward_is_profile_forward(monkeypatch):
    from tod_tpu_torch.bench import profiling

    calls = []
    monkeypatch.setattr(profiling, "profile_forward",
                        lambda batch, device=None: calls.append((batch, device)) or {"ok": 1})
    assert profiling.profile_flagship_forward(4, device="cpu") == {"ok": 1}
    assert profiling.profile_flagship_forward() == {"ok": 1}
    assert calls == [(4, "cpu"), (16, None)]
    with pytest.raises(ValueError, match="480x640"):
        profiling.profile_flagship_forward(hw=(240, 320))
