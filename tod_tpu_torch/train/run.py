"""Training CLI (counterpart of the JAX package's ``train/run.py``)::

    python -m tod_tpu_torch.train.run --steps 2000 --out checkpoints/yolact.npz

Trains the YOLACT model on the procedural FRC-domain data (or
``--domainrand``, ``--data DIR``, ``--pool N``) on the card and writes the
serving tree as an ``.npz`` that the app serves with ``python -m
tod_tpu_torch.app --checkpoint OUT.npz`` (``--int8`` for a ``--qat`` model).
``--resume`` continues a full training state written by
``--save-full-state`` / ``--state-every`` (``OUT_state.pt``); ``--init-from``
warm-starts the parameters from a serving tree.  ``--tp N`` above 1 lays a
``(dp, tp)`` mesh over the visible cards (``parallel.make_mesh``, ``tp``
dividing their count) and trains one slot of it a process
(``parallel.mesh.launch``): the same trajectory as one device, sharded; slot
0 logs and writes.
"""

from __future__ import annotations

import argparse
import pathlib


def sibling(out: str, tag: str, ext: str) -> str:
    """``OUT`` with ``_tag`` before a new extension: the best and state
    files beside the serving tree."""
    p = pathlib.Path(out)
    return str(p.with_name(f"{p.stem}_{tag}{ext}"))


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--out", default="checkpoints/yolact.npz",
                   help="the serving tree's .npz (OUT_best.npz and OUT_state.pt beside it)")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--small", action="store_true", help="tiny model for smoke runs")
    p.add_argument(
        "--backbone", default="mobilenetv2",
        choices=("mobilenetv2", "resnet18", "resnet50"),
        help="backbone family member (ModelConfig.backbone); short-train a "
        "non-default one to give bench config 15's quality axis a checkpoint",
    )
    p.add_argument("--cls-loss", default="ohem", choices=("ohem", "focal"))
    p.add_argument(
        "--qat",
        action="store_true",
        help="quantization-aware training: fake-quantized convs w/ STE grads "
        "(the checkpoint then serves through the static-int8 prepare pipeline)",
    )
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument(
        "--chunk", type=int, default=1,
        help="batches staged per prefetch (the same update sequence, run as "
        "a loop of steps on the device)",
    )
    p.add_argument(
        "--eval-every", type=int, default=0,
        help="run the held-out metric sweep (mAP@.5, semantic IoU) on the "
        "live state every N steps; the best-mAP checkpoint is kept at "
        "OUT_best (0 = off)",
    )
    p.add_argument("--eval-scenes", type=int, default=8)
    p.add_argument(
        "--data", default=None,
        help="train from an annotated image directory (train/dataset.py "
        "layout: annotations.json + imgs/ + masks/) instead of the "
        "procedural generator",
    )
    p.add_argument(
        "--metrics", default=None,
        help="append one JSON line per log/eval event to this file "
        "(machine-readable training record)",
    )
    p.add_argument(
        "--augment", action="store_true",
        help="label-consistent host-side augmentation (hflip + photometric "
        "jitter, train/augment.py) over the selected data source",
    )
    p.add_argument(
        "--domainrand", action="store_true",
        help="domain-randomized scene generator (train/domainrand.py): "
        "shaded multi-color balls, bumper-band robots, randomized "
        "backgrounds/clutter/photometrics — the sim-to-real training data",
    )
    p.add_argument(
        "--legacy-prob", type=float, default=0.2,
        help="with --domainrand: fraction of scenes drawn in the plain "
        "procedural style (keeps the legacy held-out gates in-distribution)",
    )
    p.add_argument(
        "--pool", type=int, default=0,
        help="pre-generate N unique scenes once and sample batches from the "
        "RAM pool (train/pool.py) — required to keep a ~20 ms/scene "
        "generator from starving the device (0 = off)",
    )
    p.add_argument(
        "--pool-cache", default=None,
        help="with --pool: persist/load the generated pool at this .npz path",
    )
    p.add_argument(
        "--device-augment", action="store_true",
        help="per-step hflip + photometric jitter inside the train step on "
        "the device (train/augment.py), the per-step variety source when "
        "training from a --pool",
    )
    p.add_argument(
        "--resume", default=None,
        help="resume from a FULL training checkpoint (params + optimizer "
        "state + step, written by --save-full-state) — continues the exact "
        "optimization trajectory",
    )
    p.add_argument(
        "--init-from", default=None,
        help="warm-start fine-tuning: initialize params (+ batch stats) from "
        "a serving checkpoint, with a FRESH optimizer and schedule — unlike "
        "--resume, which continues an exact trajectory; the model config "
        "must match the checkpoint's",
    )
    p.add_argument(
        "--save-full-state", action="store_true",
        help="also write the full training state to OUT_state for "
        "exact-trajectory resume via --resume",
    )
    p.add_argument(
        "--state-every", type=int, default=0,
        help="persist the full training state to OUT_state every N steps "
        "(crash-safe replace) so a killed campaign resumes from the last "
        "interval; with --resume, --steps is the TOTAL step target and the "
        "run continues from the restored step to it",
    )
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: a (dp, tp) mesh over the visible cards, one "
                   "process a card")
    args = p.parse_args(argv)
    if args.init_from and args.resume:
        p.error("--init-from and --resume are mutually exclusive")
    if args.tp > 1:
        import os
        import tempfile

        from tod_tpu_torch.parallel.mesh import launch, make_mesh

        try:
            # the visible cards, or the one device the caller names
            mesh = make_mesh(tp=args.tp, devices=None if device is None else [device])
        except ValueError as e:
            raise SystemExit(str(e)) from e
        with tempfile.TemporaryDirectory() as tmp:
            launch(mesh, _slot, args, store_path=os.path.join(tmp, "store"))
        return 0
    return train(args, device)


def _slot(mesh, args) -> None:
    """One slot of ``--tp``'s mesh, in its own process."""
    train(args, mesh=mesh)


def train(args, device=None, mesh=None) -> int:
    """Train as the parsed ``args`` say on ``device``, or as one slot of
    ``mesh`` (this process joined to it)."""
    import dataclasses

    from tod_tpu_torch.core.config import ModelConfig, TrainConfig
    from tod_tpu_torch.train import SyntheticDetectionData, Trainer

    mcfg = ModelConfig(input_size=(args.height, args.width), backbone=args.backbone)
    if args.qat:
        mcfg = dataclasses.replace(mcfg, quantized=True, qat=True)
    if args.small:
        mcfg = dataclasses.replace(mcfg, fpn_channels=32, proto_channels=32, head_channels=32,
                                   width_mult=0.5, num_prototypes=16)
    tcfg = TrainConfig(
        batch_size=args.batch, learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=min(500, max(args.steps // 10, 1)), cls_loss=args.cls_loss,
        device_augment=args.device_augment,
    )
    trainer = Trainer(mcfg, tcfg, device=device, mesh=mesh)
    say = print if trainer.writes else (lambda *_: None)
    run_steps = args.steps
    if args.init_from:
        trainer.load(args.init_from)
        say(f"warm-started params from {args.init_from}")
    if args.resume:
        trainer.load_state(args.resume)
        done = trainer.step
        say(f"resumed from {args.resume} at step {done}")
        if args.state_every:
            # --steps is the total target; the schedule is unchanged
            run_steps = max(args.steps - done, 0)
            say(f"continuing {run_steps} steps to the {args.steps} target")
    if args.data:
        from tod_tpu_torch.train import DiskDetectionData

        data = DiskDetectionData(args.data, mcfg.input_size, batch_size=args.batch,
                                 seed=tcfg.seed)
    elif args.domainrand:
        from tod_tpu_torch.train.domainrand import DomainRandomizedData

        data = DomainRandomizedData(mcfg.input_size, batch_size=args.batch, seed=tcfg.seed,
                                    legacy_prob=args.legacy_prob)
    else:
        data = SyntheticDetectionData(mcfg.input_size, batch_size=args.batch, seed=tcfg.seed)
    if args.pool:
        from tod_tpu_torch.train.pool import ScenePool

        data = ScenePool(data, args.pool, seed=tcfg.seed + 2, cache=args.pool_cache)
    if args.augment:
        from tod_tpu_torch.train import Augmented

        data = Augmented(data, seed=tcfg.seed + 1)
    best = sibling(args.out, "best", ".npz")
    state = sibling(args.out, "state", ".pt")
    trainer.train(
        data,
        steps=run_steps,
        log_every=args.log_every,
        chunk=args.chunk,
        eval_every=args.eval_every,
        eval_scenes=args.eval_scenes,
        best_path=best if args.eval_every else None,
        metrics_path=args.metrics,
        state_path=state if args.state_every else None,
        state_every=args.state_every,
    )
    trainer.save(args.out)
    say(f"saved checkpoint to {args.out}")
    if args.save_full_state:
        trainer.save_state(state)
        say(f"full training state saved to {state}")
    if args.eval_every:
        say(f"best-eval checkpoint kept at {best}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
