"""Entry points (counterpart of the repository root's
``__graft_entry__.py``): the flagship forward, and a dry run of every
multi-device path on an ``n``-slot mesh.

- ``entry()`` returns the flagship serving forward (``ModelConfig()``:
  ``yolact_mnv2_fpn`` at 256x320 in bfloat16, the pinned weights) on the
  card, and example inputs.
- ``dryrun_multichip(n)`` lays an ``n``-slot ``(dp, tp)`` mesh out
  (``tp = 2`` when ``n`` is even) and runs, in one process a slot: one
  sharded train step and ``train(chunk=2)`` at TINY widths, then one
  sharded training-form forward at the flagship's widths and input, which
  meets the divisibility faults that the JAX package finds by compiling
  its flagship step ahead of time.  Slot 0 then drives the one-process
  paths over the mesh's devices: the spatial forward, ``DPBatchServer``
  (its conv sites split over ``tp``), the two-stage pipeline and
  ``shard_inference``.  With ``n`` cards visible the slots are NCCL ranks
  on them; with fewer, gloo ranks on the CPU, as the JAX package re-runs
  itself on ``n`` virtual CPU devices.  Each slot prints its backend and
  device.

``python -m tod_tpu_torch.entry N`` runs ``dryrun_multichip(N)`` (N
defaults to the visible cards, at least 1).
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import sys
import tempfile

import numpy as np
import torch

# the JAX dry run's TINY model
TINY = dict(input_size=(48, 64), fpn_channels=16, proto_channels=16, head_channels=16,
            width_mult=0.35, num_prototypes=8)
SLOT_TIMEOUT_S = 900


def entry(device=None):
    """-> ``(fn, (params, x))``: ``fn(params, x)`` is the flagship serving
    forward, returning ``(loc, conf, coeff, prototypes, sem_logits)``;
    ``params`` its state dict on the device (the card unless ``device``
    says otherwise) and ``x`` a (1, 256, 320, 3) bfloat16 input."""
    from tod_tpu_torch.core.config import ModelConfig, PipelineConfig
    from tod_tpu_torch.core.device import resolve_device
    from tod_tpu_torch.runtime.engine import serving_model

    dev = resolve_device(device)
    cfg = ModelConfig()
    model, dtype, _ = serving_model(PipelineConfig(model=cfg), None, dev)
    params = dict(model.state_dict())
    x = torch.zeros((1, *cfg.input_size, 3), dtype=dtype, device=dev)

    def fn(params, x):
        with torch.inference_mode():
            out = torch.func.functional_call(model, params, (x,))
        return out.loc, out.conf, out.coeff, out.prototypes, out.sem_logits

    return fn, (params, x)


def _finite(value, what: str) -> float:
    value = float(value)
    if not math.isfinite(value):
        raise AssertionError(f"non-finite {what}: {value}")
    return value


def _slot(mesh, out_dir: str) -> None:
    """One slot's part of the dry run (``parallel.mesh.launch``)."""
    import torch.distributed as dist

    from tod_tpu_torch.core.config import ModelConfig, TrainConfig
    from tod_tpu_torch.train import SyntheticDetectionData, Trainer
    from tod_tpu_torch.train.trainer import device_batch

    if mesh.flat[0].type == "cpu":
        torch.set_num_threads(1)  # the slots share the host's cores
    device = mesh.flat[mesh.rank]
    print(f"dryrun slot {mesh.rank}/{mesh.size}: backend {dist.get_backend()}, device "
          f"{device}{'' if device.type == 'cpu' else ' ' + torch.cuda.get_device_name(device)}",
          flush=True)
    dp = mesh.shape["dp"]
    tiny = ModelConfig(**TINY)
    tcfg = TrainConfig(batch_size=max(dp, 2), warmup_steps=1, total_steps=4)
    trainer = Trainer(tiny, tcfg, mesh=mesh)
    data = SyntheticDetectionData(tiny.input_size, batch_size=tcfg.batch_size, seed=0)
    loss = _finite(trainer.train_step(device_batch(data.next_batch(), trainer.device))["loss"],
                   "sharded loss")
    chunked = _finite(trainer.train(data, steps=2, log_every=10, log_fn=lambda *_: None,
                                    chunk=2)["loss"], "chunked sharded loss")

    # the flagship widths: the model sharded over the mesh, one forward on
    # this slot's piece of a global batch
    flagship = ModelConfig()
    ftrainer = Trainer(flagship, TrainConfig(batch_size=max(dp, 2), warmup_steps=1,
                                             total_steps=2), mesh=mesh)
    fbatch = SyntheticDetectionData(flagship.input_size, batch_size=max(dp, 2),
                                    seed=0).next_batch()
    local = ftrainer.layout.local_batch(fbatch)
    x = torch.from_numpy(np.ascontiguousarray(local["image"])).to(ftrainer.device)
    with torch.no_grad():
        fout = ftrainer.model(x)
    _finite(fout.loc.float().abs().max(), "flagship output")
    summary = {"rank": mesh.rank, "backend": dist.get_backend(), "device": str(device),
               "loss": loss, "chunked_loss": chunked, "flagship_loc": list(fout.loc.shape)}
    if mesh.rank == 0:
        summary.update(_one_process_paths(mesh, tiny))
    pathlib.Path(out_dir, f"slot{mesh.rank}.json").write_text(json.dumps(summary))


def _one_process_paths(mesh, tiny) -> dict:
    """Slot 0: the paths that run over the mesh's devices from one process."""
    from tod_tpu_torch.bench.configs import model_state
    from tod_tpu_torch.core.config import CameraConfig, PipelineConfig
    from tod_tpu_torch.models.yolact import Yolact
    from tod_tpu_torch.parallel import shard_inference, spatial_sharded_forward
    from tod_tpu_torch.parallel.pipeline import TwoStagePipeline
    from tod_tpu_torch.parallel.serving import DPBatchServer

    dp = mesh.shape["dp"]
    first = mesh.flat[0]
    state = model_state(tiny)
    model = Yolact(tiny).to(first).eval()
    model.load_state_dict(state)
    dtype = getattr(torch, tiny.dtype)
    model.to(dtype)
    params = dict(model.state_dict())

    def apply_fn(p, imgs):
        return torch.func.functional_call(model, p, (imgs,)).loc

    x = torch.zeros((1, *tiny.input_size, 3), dtype=dtype, device=first)
    with torch.inference_mode():
        spatial = spatial_sharded_forward(apply_fn, mesh)(params, x)
        batch = torch.zeros((max(dp, 2), *tiny.input_size, 3), dtype=dtype)
        sharded = shard_inference(apply_fn, mesh, model)(params)(params, batch)
    _finite(spatial.float().abs().max(), "spatial forward")

    cam = CameraConfig(width=tiny.input_size[1], height=tiny.input_size[0])
    cfg = PipelineConfig(camera=cam, model=tiny)
    dets = DPBatchServer(cfg, mesh, params=state).serve(
        np.zeros((max(dp, 2), *tiny.input_size, 3), np.uint8))
    pipe = TwoStagePipeline(cfg, devices=mesh.flat[:2], params=state)
    plan = pipe.dispatch(np.zeros((cam.height, cam.width, 3), np.uint8),
                         np.zeros((cam.height, cam.width), np.uint16))
    return {"spatial": list(spatial.shape), "shard_inference": list(sharded.shape),
            "dp_serve_boxes": list(dets.boxes.shape),
            "pipeline": [str(pipe.d_fwd), str(pipe.d_post)],
            "pipeline_plan_n": int(plan[0, 0].item())}


def dryrun_multichip(n_devices: int, workdir: str | os.PathLike | None = None) -> dict:
    """The dry run on an ``n_devices`` mesh (see the module docstring).
    Returns slot 0's summary, with every slot's backend and device; prints
    one line.  ``workdir`` holds the process group's store and the slots'
    summaries (a temporary directory by default)."""
    from tod_tpu_torch.parallel import make_mesh
    from tod_tpu_torch.parallel.mesh import launch, visible_devices

    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    tp = 2 if n_devices % 2 == 0 else 1
    cards = visible_devices()
    devices = cards[:n_devices] if len(cards) >= n_devices else ["cpu"] * n_devices
    mesh = make_mesh(n_devices, tp=tp, devices=devices)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        launch(mesh, _slot, tmp, store_path=os.path.join(tmp, "store"),
               timeout=SLOT_TIMEOUT_S)
        slots = [json.loads(pathlib.Path(tmp, f"slot{r}.json").read_text())
                 for r in range(mesh.size)]
    summary = dict(slots[0], mesh={"dp": mesh.shape["dp"], "tp": tp},
                   slots=[{k: s[k] for k in ("rank", "backend", "device")} for s in slots])
    print(f"dryrun_multichip ok: mesh dp={mesh.shape['dp']} tp={tp} on "
          f"{[s['device'] for s in slots]} ({slots[0]['backend']}), train loss "
          f"{summary['loss']:.4f}, chunked loss {summary['chunked_loss']:.4f}, flagship "
          f"sharded forward loc {summary['flagship_loc']}, spatial fwd {summary['spatial']}, "
          f"dp serve boxes {summary['dp_serve_boxes']}, pipeline on {summary['pipeline']} "
          f"plan n={summary['pipeline_plan_n']}", flush=True)
    return summary


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else max(torch.cuda.device_count(), 1))
