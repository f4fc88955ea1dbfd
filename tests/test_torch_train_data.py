"""The port's training data and evaluation pieces against the JAX package's
on the CPU: the procedural, domain-randomized and hard-eval generators, the
scene pool (and its cache), the prefetch order, the host augmentation and
the on-disk dataset, each bit for bit for the same seed; the evaluator's
``box_iou``, ``average_precision``, ``_greedy_match`` and
``perturbed_fixture_scenes`` exactly; ``evaluate_engines``' report on the
CPU; and the sim-based evaluations' refusal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tod_tpu.train import augment as jax_augment
from tod_tpu.train import dataset as jax_dataset
from tod_tpu.train import domainrand as jax_domainrand
from tod_tpu.train import evaluate as jax_evaluate
from tod_tpu.train import pool as jax_pool
from tod_tpu.train import prefetch as jax_prefetch
from tod_tpu.train import synthetic_data as jax_synthetic
from tod_tpu_torch.train import augment, dataset, domainrand, evaluate, pool, prefetch
from tod_tpu_torch.train import synthetic_data

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

HW = (48, 64)


def assert_batches_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["SyntheticDetectionData", "DomainRandomizedData",
                                  "HardEvalData"])
def test_generators_equal_jax_bit_for_bit(name):
    mods = {"SyntheticDetectionData": (synthetic_data, jax_synthetic)}
    ours, theirs = mods.get(name, (domainrand, jax_domainrand))
    a = getattr(ours, name)(HW, batch_size=3, seed=4)
    b = getattr(theirs, name)(HW, batch_size=3, seed=4)
    for _ in range(2):
        assert_batches_equal(a.next_batch(), b.next_batch())


def test_scene_pool_and_its_cache_equal_jax(tmp_path):
    src = synthetic_data.SyntheticDetectionData(HW, batch_size=2, seed=1)
    jsrc = jax_synthetic.SyntheticDetectionData(HW, batch_size=2, seed=1)
    ours = pool.ScenePool(src, 5, seed=3, cache=tmp_path / "pool.npz", log_fn=lambda *_: None)
    theirs = jax_pool.ScenePool(jsrc, 5, seed=3, log_fn=lambda *_: None)
    assert len(ours) == len(theirs) == 5
    for _ in range(3):
        assert_batches_equal(ours.next_batch(), theirs.next_batch())
    again = pool.ScenePool(src, 5, seed=3, cache=tmp_path / "pool.npz")
    assert_batches_equal(again.next_batch(), jax_pool.ScenePool(
        jax_synthetic.SyntheticDetectionData(HW, batch_size=2, seed=1), 5, seed=3,
        log_fn=lambda *_: None).next_batch())
    with pytest.raises(ValueError, match="holds 5 scenes"):
        pool.ScenePool(src, 6, cache=tmp_path / "pool.npz")


def test_prefetch_keeps_the_serial_order():
    for steps, chunk in ((7, 3), (8, 4), (3, 1)):
        assert prefetch.chunk_schedule(steps, chunk) == jax_prefetch.chunk_schedule(steps, chunk)
    serial = synthetic_data.SyntheticDetectionData(HW, batch_size=2, seed=8)
    want = [serial.next_batch() for _ in range(7)]
    pf = prefetch.PrefetchChunks(synthetic_data.SyntheticDetectionData(HW, batch_size=2, seed=8),
                                 prefetch.chunk_schedule(7, 3))
    try:
        got = [{k: v[i] for k, v in chunk.items()} for chunk in pf
               for i in range(chunk["image"].shape[0])]
    finally:
        pf.close()
    assert len(got) == 7
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


def test_host_augmentation_equals_jax():
    a = augment.Augmented(synthetic_data.SyntheticDetectionData(HW, batch_size=4, seed=2), seed=6)
    b = jax_augment.Augmented(jax_synthetic.SyntheticDetectionData(HW, batch_size=4, seed=2),
                              seed=6)
    for _ in range(2):
        assert_batches_equal(a.next_batch(), b.next_batch())


def test_disk_dataset_round_trip_equals_jax(tmp_path):
    """The port's exporter writes the procedural scenes; the port's and the
    JAX package's loaders read the same batches (annotation order), and the
    boxes come back as exported."""
    root = dataset.export_dataset(synthetic_data.SyntheticDetectionData(HW, seed=3), tmp_path, 4)
    ours = dataset.DiskDetectionData(root, HW, batch_size=2, shuffle=False)
    theirs = jax_dataset.DiskDetectionData(root, HW, batch_size=2, shuffle=False)
    assert len(ours) == 4
    for _ in range(3):
        assert_batches_equal(ours.next_batch(), theirs.next_batch())
    shuffled = dataset.DiskDetectionData(root, HW, batch_size=4, seed=1)
    jshuffled = jax_dataset.DiskDetectionData(root, HW, batch_size=4, seed=1)
    assert_batches_equal(shuffled.next_batch(), jshuffled.next_batch())
    scene = synthetic_data.SyntheticDetectionData(HW, seed=3)._scene()
    got = ours._load_example(ours.images[0])
    np.testing.assert_array_equal(got[0], scene[0])
    np.testing.assert_allclose(got[1], scene[1], atol=1e-6)


class TestEvaluate:
    def test_box_iou_average_precision_and_greedy_match_equal_jax(self):
        rng = np.random.default_rng(0)
        for _ in range(20):
            a, b = (np.sort(rng.uniform(0, 1, (2, 2)), axis=0).reshape(4) for _ in range(2))
            assert evaluate.box_iou(a, b) == jax_evaluate.box_iou(a, b)
            n_det, n_gt = rng.integers(0, 6, 2)
            scores = np.round(rng.uniform(0, 1, n_det), 1)  # ties in score order
            mat = rng.uniform(0, 1, (n_det, n_gt))
            for thr in (0.3, 0.5, 0.75):
                tp = evaluate._greedy_match(mat, scores, thr)
                np.testing.assert_array_equal(tp, jax_evaluate._greedy_match(mat, scores, thr))
            for n in (0, int(n_gt), 9):
                assert (evaluate.average_precision(scores, tp, n)
                        == jax_evaluate.average_precision(scores, tp, n))

    def test_perturbed_fixture_scenes_equal_jax(self, tmp_path):
        root = dataset.export_dataset(synthetic_data.SyntheticDetectionData(HW, seed=5),
                                      tmp_path, 2)
        ours = list(evaluate.perturbed_fixture_scenes(str(root), HW))
        theirs = list(jax_evaluate.perturbed_fixture_scenes(str(root), HW))
        assert len(ours) == len(theirs) == 2 * len(evaluate.PERTURBATIONS)
        for got, want in zip(ours, theirs):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)

    def test_hard_eval_scenes_equal_jax(self):
        for got, want in zip(evaluate.hard_eval_scenes(HW, 2, seed=77),
                             jax_evaluate.hard_eval_scenes(HW, 2, seed=77)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)

    def test_evaluate_engines_reports_the_jax_keys(self):
        """The report's keys are the JAX evaluator's (plus ``plans_found``
        with ``plan``), its rates in [0, 1], on TINY engines on the CPU."""
        from tod_tpu_torch.core.config import ModelConfig
        from tod_tpu_torch.core.weights import carry_across, train_state_to_tree
        from tod_tpu_torch.models.yolact import Yolact
        from tod_tpu_torch.train.trainer import init_params

        mcfg = ModelConfig(input_size=HW, fpn_channels=16, proto_channels=16, head_channels=16,
                           width_mult=0.35, num_prototypes=8, nms_top_k=8, max_detections=4)
        train = Yolact(mcfg, train=True)
        init_params(train, torch.Generator().manual_seed(0))
        state = carry_across(train_state_to_tree(train.state_dict()), Yolact(mcfg))
        eng, eng_sem = evaluate.make_eval_engines(HW, mcfg, params=state, device="cpu")
        out = evaluate.evaluate_engines(eng, eng_sem, n_scenes=2, hw=HW, plan=True)
        assert set(out) == {"n_scenes", "ap50_per_class", "map50", "map50_95", "sem_iou",
                            "det_best_box_iou_mean", "det_recall_iou30", "det_recall_iou50",
                            "mean_score", "detections_per_gt", "inst_mask_iou_mean",
                            "plans_found"}
        assert out["n_scenes"] == 2 and 0.0 <= out["plans_found"] <= 1.0
        assert set(out["ap50_per_class"]) == set(out["sem_iou"]) == {1, 2, 3}
