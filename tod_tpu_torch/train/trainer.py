"""The training loop on the card (counterpart of the JAX package's
``train/trainer.py``).

A step: the batch's images to ``(u8 / 127.5 - 1)`` in bfloat16 (after the
device augmentation, with ``TrainConfig.device_augment``), the forward of
the training graph (``Yolact(cfg, train=True)``: f32 parameters, convs in
``ModelConfig.dtype``, BatchNorms on the batch's statistics), the YOLACT
loss, its gradients, and the optimizer: ``AdamW``, which is optax's
``chain(clip_by_global_norm(10), adamw(warmup_cosine_decay_schedule,
weight_decay))`` step for step.  The convolutions and their backward are
cuDNN's, chosen among its deterministic algorithms; the loss, the matcher
and the optimizer are torch operations, and the upsample's backward is a
deterministic one (``models/fpn.py``), so a step on the same state and
batch gives the same bits.  A step reads nothing back to the host;
``Trainer.train`` reads the loss on its logging steps only.

``Trainer`` keeps the JAX trainer's surface: ``train`` (with ``chunk``, the
prefetch thread staging ``chunk`` batches at a time in the same strict data
order, run as a loop of steps; the in-training evaluation, best-checkpoint
keeping, the metrics file and periodic full-state saves), ``evaluate``,
``save`` / ``load`` (the serving tree) and ``save_state`` / ``load_state``
(the full state, ``train/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Callable

import numpy as np
import torch

from tod_tpu_torch.core.config import ModelConfig, TrainConfig
from tod_tpu_torch.core.device import resolve_device
from tod_tpu_torch.ops.anchors import generate_anchors
from tod_tpu_torch.train.losses import yolact_loss

CLIP_NORM = 10.0
BATCH_KEYS = ("image", "gt_boxes", "gt_classes", "gt_valid", "gt_masks", "sem_target")


def learning_rate(tcfg: TrainConfig, count: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup_steps,
    max(total_steps, warmup_steps + 1))`` at ``count``, in float32 as optax
    computes it: linear from 0 over the warmup, then a cosine to 0."""
    f32 = np.float32
    peak, warm = f32(tcfg.learning_rate), tcfg.warmup_steps
    decay = max(tcfg.total_steps, warm + 1) - warm
    if count < warm:
        frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
        return float((f32(0) - peak) * frac + peak)
    c = f32(min(count - warm, decay))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
    return float(peak * cosine)


class AdamW:
    """optax's clipped AdamW over ``params``, step for step.

    - The gradients are scaled by ``10 / ||g||`` when the global norm
      ``||g|| >= 10`` (``clip_by_global_norm``: no epsilon, no change
      below).
    - Adam's moments (b1 0.9, b2 0.999, eps 1e-8) with bias correction at
      the incremented count.
    - Decoupled weight decay ``u + wd * p`` on every parameter, BatchNorm
      scales and biases too, then ``p - lr * u`` with the schedule read at
      the count before the increment: the first update has lr = 0 and leaves
      the parameters as they were (only the moments move).

    The step runs on the parameters' device with ``torch._foreach_*``
    operations and reads nothing back.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, tcfg: TrainConfig):
        self.params = list(params)
        self.tcfg = tcfg
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @property
    def n_leaves(self) -> int:
        """optax's leaf count for this state: Adam's count and moments and
        the schedule's count."""
        return 2 + len(self.mu) + len(self.nu)

    @torch.no_grad()
    def step(self, grads) -> None:
        grads = list(grads)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        torch._foreach_mul_(grads, torch.where(norm < CLIP_NORM, one, CLIP_NORM / norm))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        lr = learning_rate(self.tcfg, self.count)
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.params, alpha=self.tcfg.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)


def init_params(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Flax's initialisers from ``generator``: each conv kernel LeCun normal
    (a normal truncated at two deviations, scaled so its variance is
    1 / fan-in), each bias zero; BatchNorms as ``TrainBatchNorm`` makes
    them (scale and var one, bias and mean zero)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight"):
                std = math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978
                torch.nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                            generator=generator)
            elif name.endswith(".bias"):
                p.zero_()


def device_batch(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A numpy batch -> tensors on ``device``, copied from pinned memory
    without waiting on the card (the int fields as int64)."""
    out = {}
    for k in BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if t.dtype == torch.int32:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms, its other settings
    kept, for the span of a train step."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark, benchmark_limit=c.benchmark_limit,
                   deterministic=True, allow_tf32=c.allow_tf32)


def make_train_step(model, anchors: torch.Tensor, opt: AdamW, tcfg: TrainConfig) -> Callable:
    """``step(batch, index, mark=None) -> metrics``: one optimizer step of
    ``model`` on ``batch`` (tensors on the model's device) as step number
    ``index``; ``metrics`` are 0-dim tensors (``loss``, ``cls``, ``box``,
    ``mask``, ``sem``) of the loss before the update.  ``mark(phase)``, when
    given, is called as each phase ends (``augment``, ``forward``,
    ``loss``, ``backward``, ``optimizer``): the profiler's hook."""
    from tod_tpu_torch.train.augment import apply_augment, draw_augment, step_generator

    def step(batch: dict, index: int, mark=None) -> dict[str, torch.Tensor]:
        with deterministic_cudnn():
            return run(batch, index, mark or (lambda _: None))

    def run(batch: dict, index: int, mark) -> dict[str, torch.Tensor]:
        if tcfg.device_augment:
            img = batch["image"]
            gen = step_generator(tcfg.seed, index, img.device)
            batch = apply_augment(batch, draw_augment(gen, img.shape[0], tuple(img.shape[1:3])))
        imgs = (batch["image"].float() / 127.5 - 1.0).to(torch.bfloat16)
        mark("augment")
        out = model(imgs)
        mark("forward")
        total, comps = yolact_loss(out, anchors, batch, tcfg.loss_weights,
                                   cls_loss=tcfg.cls_loss)
        mark("loss")
        grads = torch.autograd.grad(total, opt.params)
        mark("backward")
        opt.step(grads)
        mark("optimizer")
        return {"loss": total.detach(), **{k: v.detach() for k, v in comps.items()}}

    return step


@dataclasses.dataclass
class TrainState:
    """What a full-state checkpoint holds: the parameters and BatchNorm
    statistics by state-dict name, the optimizer's count and moments by
    parameter name, and the step."""

    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    opt_state: dict
    step: int


class Trainer:
    """Trains ``Yolact(mcfg, train=True)`` on ``device`` (the card unless
    the caller asks for the CPU) from Flax's initialisers seeded with
    ``tcfg.seed``."""

    def __init__(self, mcfg: ModelConfig | None = None, tcfg: TrainConfig | None = None,
                 device=None):
        from tod_tpu_torch.models.yolact import Yolact

        self.mcfg = mcfg or ModelConfig()
        self.tcfg = tcfg or TrainConfig()
        self.device = resolve_device(device)
        self.model = Yolact(self.mcfg, train=True)
        init_params(self.model, torch.Generator().manual_seed(self.tcfg.seed))
        self.model.to(self.device).train()
        self.anchors = torch.from_numpy(generate_anchors(self.mcfg)).to(self.device)
        self.opt = AdamW(self.model.parameters(), self.tcfg)
        self.step = 0
        self._step = make_train_step(self.model, self.anchors, self.opt, self.tcfg)
        self._eval_engines = None  # built by the first evaluate()
        self._best_eval = float("-inf")

    @property
    def param_names(self) -> list[str]:
        return [name for name, _ in self.model.named_parameters()]

    def train_step(self, batch: dict, mark=None) -> dict[str, torch.Tensor]:
        """One step on a batch of tensors on the device."""
        metrics = self._step(batch, self.step, mark)
        self.step += 1
        return metrics

    def train(self, data, steps: int, log_every: int = 50, log_fn=print, chunk: int = 1,
              eval_every: int = 0, eval_scenes: int = 8, eval_seed: int = 9999,
              best_path: str | None = None, metrics_path: str | None = None,
              state_path: str | None = None, state_every: int = 0) -> dict:
        """Run ``steps`` optimizer steps on ``data`` (``next_batch()``).

        ``chunk > 1`` stages ``chunk`` batches at a time on the prefetch
        thread (``train/prefetch.py``), in the same order as ``chunk == 1``
        reads them, and runs them as a loop of steps.  ``eval_every > 0``
        runs :meth:`evaluate` every ``eval_every`` steps and at the end,
        keeping the best mAP@.5's serving tree at ``best_path``;
        ``metrics_path`` appends one JSON line a log, eval or state event;
        ``state_path`` with ``state_every > 0`` saves the full state every
        ``state_every`` steps (crash-safe).  Returns the last logged
        metrics (with ``eval_map50`` / ``eval_best_map50`` when evaluating).
        """
        last: dict = {}
        t0 = time.perf_counter()
        mfile = open(metrics_path, "a") if metrics_path else None

        def _record(kind: str, payload: dict) -> None:
            if mfile is None:
                return
            row = {"kind": kind, "step": self.step,
                   "wall_s": round(time.perf_counter() - t0, 3), **payload}
            mfile.write(json.dumps(row) + "\n")
            mfile.flush()

        prefetcher = None
        if chunk > 1:
            from tod_tpu_torch.train.prefetch import PrefetchChunks, chunk_schedule

            prefetcher = PrefetchChunks(data, chunk_schedule(steps, chunk))
            staged = iter(prefetcher)
        done = 0
        try:
            while done < steps:
                if chunk > 1:
                    stacked = device_batch(next(staged), self.device)
                    n = stacked["image"].shape[0]
                    for i in range(n):
                        metrics = self.train_step({k: v[i] for k, v in stacked.items()})
                else:
                    n = 1
                    metrics = self.train_step(device_batch(data.next_batch(), self.device))
                done += n
                if done % log_every < n or done >= steps:
                    last = {k: float(v) for k, v in metrics.items()}
                    rate = done / (time.perf_counter() - t0)
                    log_fn(f"step {self.step}: "
                           + " ".join(f"{k}={v:.4f}" for k, v in last.items())
                           + f" ({rate:.2f} steps/s)")
                    _record("train", {**last, "steps_per_s": round(rate, 3)})
                if state_path and state_every and (done % state_every < n and done < steps):
                    self.save_state(state_path)
                    _record("state", {"path": state_path})
                if eval_every and (done % eval_every < n or done >= steps):
                    ev = self.evaluate(n_scenes=eval_scenes, seed=eval_seed)
                    m50 = ev.get("map50")
                    # no detection above the score threshold (early training):
                    # NaN, and never the best-checkpoint slot
                    score = float("-inf") if m50 is None else float(m50)
                    last["eval_map50"] = float("nan") if m50 is None else float(m50)
                    if score > self._best_eval:
                        self._best_eval = score
                        if best_path is not None:
                            self.save(best_path)
                    best = None if self._best_eval == float("-inf") else self._best_eval
                    last["eval_best_map50"] = float("nan") if best is None else best
                    log_fn(f"eval @ step {self.step}: map50={m50} "
                           f"recall50={ev['det_recall_iou50']} sem_iou={ev['sem_iou']} "
                           f"best={best}")
                    _record("eval", {**ev, "best_map50": best})
        finally:
            if prefetcher is not None:
                prefetcher.close()
            if mfile is not None:
                mfile.close()
        return last

    # --- serving weights ---------------------------------------------------
    def serving_state(self) -> dict[str, torch.Tensor]:
        """The live state folded for serving (``core.weights.carry_across``
        of :meth:`tree`): the state dict of ``Yolact(mcfg)``."""
        from tod_tpu_torch.core.weights import carry_across
        from tod_tpu_torch.models.yolact import Yolact

        return carry_across(self.tree(), Yolact(self.mcfg))

    def tree(self) -> dict[str, np.ndarray]:
        """The live parameters and BatchNorm statistics as the JAX package's
        unfolded tree (``core.weights.train_state_to_tree``)."""
        from tod_tpu_torch.core.weights import train_state_to_tree

        return train_state_to_tree(self.model.state_dict())

    def evaluate(self, n_scenes: int = 8, seed: int = 9999, plan: bool = False) -> dict:
        """The held-out metric sweep (``train/evaluate.py``) on the live
        state, through a detect-mode and a semantic-mode ``Engine`` built by
        the first call; later calls load the live state into them.  With
        ``plan``, each scene is also planned on the device."""
        from tod_tpu_torch.train.evaluate import evaluate_engines, make_eval_engines, swap_weights

        state = self.serving_state()
        if self._eval_engines is None:
            self._eval_engines = make_eval_engines(self.mcfg.input_size, self.mcfg,
                                                   params=state, device=self.device)
        else:
            for eng in self._eval_engines:
                swap_weights(eng, state)
        eng, eng_sem = self._eval_engines
        return evaluate_engines(eng, eng_sem, n_scenes=n_scenes, seed=seed,
                                hw=self.mcfg.input_size, plan=plan)

    # --- checkpoints -------------------------------------------------------
    def save(self, path: str) -> None:
        """The serving tree as an ``.npz`` (``train/checkpoint.save_tree``)."""
        from tod_tpu_torch.train.checkpoint import save_tree

        save_tree(path, self.tree())

    def load(self, path: str) -> None:
        """Warm-start from a serving tree (``--init-from``): parameters and
        BatchNorm statistics, the optimizer and step left as they are.
        Refuses a tree whose leaves do not fit this model, naming the first
        parameter that differs."""
        from tod_tpu_torch.core.weights import read_tree, train_state_from_tree

        state = train_state_from_tree(read_tree(path))
        want = self.model.state_dict()
        if len(state) != len(want):
            raise ValueError(f"checkpoint/model config mismatch: {path} has {len(state)} "
                             f"leaves, this model has {len(want)}")
        for name, value in want.items():
            if name not in state:
                raise ValueError(f"checkpoint/model config mismatch: {path} has no {name}")
            if tuple(state[name].shape) != tuple(value.shape):
                raise ValueError(f"checkpoint/model config mismatch at param {name}: checkpoint "
                                 f"{tuple(state[name].shape)} vs model {tuple(value.shape)}")
        self.model.load_state_dict(state)

    def state(self) -> TrainState:
        names = self.param_names
        sd = self.model.state_dict()
        return TrainState(
            params={n: sd[n] for n in names},
            batch_stats={n: t for n, t in sd.items() if n not in set(names)},
            opt_state={"count": self.opt.count, "mu": dict(zip(names, self.opt.mu)),
                       "nu": dict(zip(names, self.opt.nu))},
            step=self.step,
        )

    def save_state(self, path: str) -> None:
        """The full training state (``torch.save``, crash-safe): resuming
        from it continues the same trajectory, where :meth:`save` keeps only
        the serving tree."""
        from tod_tpu_torch.train.checkpoint import save_state

        save_state(path, dataclasses.asdict(self.state()))

    def load_state(self, path: str) -> None:
        """Resume from :meth:`save_state`.  The optimizer must match this
        trainer's (its leaf count is checked)."""
        from tod_tpu_torch.train.checkpoint import load_state

        saved = load_state(path)
        opt = saved["opt_state"]
        got = 2 + len(opt["mu"]) + len(opt["nu"])
        if got != self.opt.n_leaves:
            raise ValueError(f"optimizer state mismatch: checkpoint has {got} leaves, this "
                             f"Trainer's optimizer has {self.opt.n_leaves} - was the optimizer "
                             f"recipe changed?")
        self.model.load_state_dict({**saved["params"], **saved["batch_stats"]})
        names = self.param_names
        with torch.no_grad():
            for dst, key in ((self.opt.mu, "mu"), (self.opt.nu, "nu")):
                for t, name in zip(dst, names):
                    t.copy_(opt[key][name])
        self.opt.count = int(opt["count"])
        self.step = int(saved["step"])
