"""Driver ``train``: the program's ``Trainer.train`` on synthetic scenes.

Traffic (the mix): ``pool_batches`` batches of ``batch`` scenes at the
configuration's input size, made in set-up by ``generators/scenes.py``
with seed ``--seed`` and cycled, as a dataset held in host memory would be;
``Trainer.train`` copies each batch to the card itself.

Set-up builds one ``Trainer`` (batch size, loss and optimiser from the
configuration), puts the benchmark's own initial weights into its model
(``reference/model.init_params`` from the seed, made on the card), starts
its step and its optimiser's count at the end of the learning-rate warm-up
(the moments zero), so that every checked step moves the parameters at the
schedule's peak rate, and runs its first ``check_steps`` steps through
``Trainer.train``, on batches whose rows all differ; the same object then
trains through the window.  The
driver wraps the trainer instance's step (``_step``): it keeps each step's
loss tensor, records a CUDA event after the step, and a stamper thread
stamps the step's end; in the traced run it opens ``bench.train_step``.

End-to-end: ``train_images_per_s``, the images of the steps the device
finished inside the window over the time from the window's start to the
last of those steps' end.

The check (``correct``), against ``reference/train.py`` in float32 from
the same initial weights on the same batches, once the window has closed
and the trainer is freed (leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the leaf numbers: they move
by round-off alone):

- ``loss_gap``: the relative gap of the first step's loss (the later
  steps' losses are logged beside the reference's);
- ``grad_gap``: the worst leaf's gap between the norms of the first step's
  clipped gradient (the program's from its AdamW first moment after one
  step), against the larger of that leaf's reference norm and the median
  leaf's;
- ``update_gap``: the same for each leaf's change over the ``check_steps``
  steps.
"""

from __future__ import annotations

import contextlib
import gc
import queue
import threading
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import flops as flop_counts
from benchmark.generators.scenes import Scenes
from benchmark.trace import Tracer, breakdown, span


class Stamper:
    """Waits on each step's event in order and stamps its end."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue()
        self.done: dict[int, float] = {}
        self.thread = threading.Thread(target=self._loop, daemon=True, name="bench-stamper")
        self.thread.start()

    def _loop(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            idx, ev = item
            if ev is not None:
                ev.synchronize()
            self.done[idx] = time.perf_counter()

    def finish(self, timeout: float = 60.0):
        self.q.put(None)
        self.thread.join(timeout)


class WindowClosed(Exception):
    """Raised by the data feed once the window has closed."""


class Feed:
    """``next_batch()`` over a pool of batches, cycled; raises
    ``WindowClosed`` once past ``t_end``."""

    def __init__(self, pool):
        self.pool, self.i, self.t_end = pool, 0, None

    def next_batch(self) -> dict:
        if self.t_end is not None and time.perf_counter() >= self.t_end:
            raise WindowClosed
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        return batch


def run(ctx: harness.Context) -> dict:
    from tod_tpu_torch.core.config import ModelConfig, TrainConfig
    from tod_tpu_torch.train.trainer import Trainer

    from benchmark.reference import model as rmodel

    conf, mix = ctx.config, ctx.mix
    on_card = ctx.device == "cuda"
    dev = torch.device(ctx.device)
    stages = {}
    t = time.perf_counter()
    stages["process_and_imports"] = t - ctx.t0
    mcfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in conf["model"].items()})
    tc = dict(conf["train"])
    tc["loss_weights"] = tuple(tc["loss_weights"])
    tcfg = TrainConfig(**tc)
    trainer = Trainer(mcfg, tcfg, device=ctx.device)
    init = rmodel.init_params(conf["model"], ctx.seed, dev)
    live = dict(trainer.model.named_parameters())
    if set(live) != set(init) or any(tuple(live[k].shape) != tuple(init[k].shape) for k in init):
        raise ValueError("the program's parameters do not match the reference's sites")
    with torch.no_grad():
        for k, v in init.items():
            live[k].copy_(v)
    trainer.step = trainer.opt.count = tcfg.warmup_steps
    stages["trainer_and_weights"] = time.perf_counter() - t
    t = time.perf_counter()
    data = Scenes(tuple(conf["model"]["input_size"]), tcfg.batch_size, ctx.seed)
    pool = data.batches(mix["pool_batches"])
    feed = Feed(pool)
    stages["batch_pool"] = time.perf_counter() - t

    state = {"window": False}
    losses, steps = [], []
    stamper = Stamper()
    tracer = Tracer(on_card) if ctx.trace else None
    orig_step = trainer._step

    def step(batch, index, mark=None):
        if state["window"] and tracer is not None:
            now = time.perf_counter()
            if not tracer.started and now >= state["t_w"] + mix["trace_lead_s"]:
                tracer.start()
                state["trace_t"] = time.perf_counter()
            elif tracer.started and not tracer.stopped and \
                    now >= state["trace_t"] + mix["trace_seconds"]:
                tracer.stop()
        traced = tracer is not None and tracer.started and not tracer.stopped
        if ctx.fault == "half_batch":  # the mean taken over half of the batch
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        if ctx.fault == "unchanged":  # the step's state restored after it
            saved = [t.detach().clone() for t in [*trainer.opt.params, *trainer.opt.mu,
                                                  *trainer.opt.nu]]
            count = trainer.opt.count
        with span("bench.train_step") if traced else contextlib.nullcontext():
            metrics = orig_step(batch, index, mark)
        if ctx.fault == "unchanged":
            with torch.no_grad():
                for t, v in zip([*trainer.opt.params, *trainer.opt.mu, *trainer.opt.nu], saved):
                    t.copy_(v)
            trainer.opt.count = count
        if ctx.fault == "altered":  # the loss altered where it is made
            metrics = {**metrics, "loss": metrics["loss"] + 1.0}
        ev = None
        if on_card:
            ev = torch.cuda.Event(blocking=True)
            ev.record()
        if state["window"]:
            steps.append(time.perf_counter())
            losses.append(metrics["loss"])
            stamper.q.put((len(steps) - 1, ev))
        return metrics

    trainer._step = step
    if tracer is not None:
        tracer.warm(lambda: torch.ones(1, device=dev).add_(1))

    # set-up: the checked steps, then warm steps, all through Trainer.train
    t = time.perf_counter()
    quiet = dict(log_every=1, log_fn=lambda *_: None)
    first_losses, first_grad = [], None
    for i in range(mix["check_steps"]):
        first_losses.append(trainer.train(feed, steps=1, **quiet)["loss"])
        if i == 0:
            first_grad = {k: m.detach().clone() / (1 - trainer.opt.b1)
                          for k, m in zip(trainer.param_names, trainer.opt.mu)}
    after = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    trainer.train(feed, steps=mix["warm_steps"], **quiet)
    if on_card:
        torch.cuda.synchronize()
    stages["warmup"] = time.perf_counter() - t

    t_w = time.perf_counter()
    t_end = t_w + ctx.seconds
    state.update(window=True, t_w=t_w)
    feed.t_end = t_end
    error = None
    try:
        trainer.train(feed, steps=10 ** 9, log_every=10 ** 9, log_fn=lambda *_: None)
    except WindowClosed:
        pass
    except Exception as e:  # every image of the window then counts as failed
        error = e
        ctx.log(f"train raised {type(e).__name__}: {e}")
    state["window"] = False
    if tracer is not None and tracer.started and not tracer.stopped:
        tracer.stop()
    stamper.finish()

    dispatched = [i for i, ts in enumerate(steps) if ts < t_end]
    finished = [i for i in dispatched if stamper.done.get(i, np.inf) <= t_end]
    # the work the device finished inside the window, over the time it took
    span_s = max((stamper.done[i] for i in finished), default=t_end) - t_w
    finite = torch.stack(losses).isfinite().cpu().numpy() if losses else np.zeros(0, bool)
    b = tcfg.batch_size
    attempted = b * len(dispatched)
    failed = attempted if error is not None else b * sum(
        1 for i in dispatched if i not in stamper.done or not finite[i])
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": 1 if on_card else 0,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
    out = {"attempted": attempted, "failed": failed, "device": device,
           "setup_stages": {k: round(v, 3) for k, v in stages.items()},
           "metrics": {"train_images_per_s": b * len(finished) / span_s if finished else 0.0,
                       "setup_s": t_w - ctx.t0},
           "notes": {"steps": len(finished)}}
    if tracer is not None:
        out["records"] = train_records(tracer, conf, b, on_card)
        out["breakdown"] = breakdown(out["records"]) if out["records"]["on_card"] else None
        if on_card:
            device["busy_s"] = out["records"]["busy_s"]
            device["window_s"] = out["records"]["window_s"]

    del trainer, orig_step, losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["checks"] = check(ctx, conf, pool, init, first_losses, first_grad, after, error)
    return out


def train_records(tracer: Tracer, conf: dict, batch: int, on_card: bool) -> dict:
    if not tracer.stopped:
        return {"on_card": False, "spans": {}, "kernels": {}, "gaps": []}
    rec = tracer.reduce()
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    rec["units"] = rec["spans"].get("bench.train_step", {}).get("count", 0)
    rec["flops_per_unit"] = flop_counts.train_flops(conf["model"], batch)
    rec["peak_flops"] = harness.peak(kind, "bf16")
    return rec


def check(ctx, conf: dict, pool, init, losses, grad, after, error) -> dict:
    from benchmark.reference import train as rtrain

    limits = conf["limits"]
    if error is not None or grad is None:
        return {k: {"value": float("inf"), "limit": v} for k, v in limits.items()}
    dev = torch.device(ctx.device)
    n = len(losses)
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()}
               for b in pool[:n]]
    anc = rtrain.anchors(conf["model"]).to(dev)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref_losses, ref_grad, ref_after = rtrain.train_steps(
            init, batches, anc, conf["model"], conf["train"],
            getattr(torch, conf["model"]["dtype"]), start=conf["train"]["warmup_steps"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    # the first step's loss: the later ones follow updates that Adam's
    # normalised step makes out of gradients' last bits (PERF.md)
    loss_gap = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    gnorm = {k: float(v.norm()) for k, v in ref_grad.items()}
    med = float(np.median(list(gnorm.values())))
    counted = [k for k in gnorm if gnorm[k] >= 1e-3 * med]

    worst = {}

    def gap(what: str, prog: dict, ref: dict) -> float:
        norms = {k: float(ref[k].norm()) for k in counted}
        floor = float(np.median(list(norms.values())))
        gaps = {k: abs(float(prog[k].norm()) - norms[k]) / max(norms[k], floor) for k in counted}
        top = sorted(gaps, key=gaps.get, reverse=True)[:4]
        worst[what] = [(k, round(gaps[k], 4), float(prog[k].norm()), norms[k]) for k in top]
        return gaps[top[0]]

    values = {"loss_gap": loss_gap, "grad_gap": gap("grad", grad, ref_grad),
              "update_gap": gap("update", {k: after[k] - init[k] for k in counted},
                                {k: ref_after[k] - init[k] for k in counted})}
    ctx.log(f"losses {losses} reference {ref_losses}; {len(counted)} of {len(gnorm)} leaves "
            f"counted; worst leaves (name, gap, program norm, reference norm) {worst}")
    ctx.readings.update(values)
    return {k: {"value": values[k], "limit": v} for k, v in limits.items()}
