"""Frozen serving artifacts (``tod_tpu_torch.deploy``) on the CPU: the
``plan`` and ``track_plan`` artifacts, exported at the pipeline tests'
160x120 camera (the model at 256x320 f32) on the pinned weights and loaded
in a process that cannot import jax, ``tod_tpu`` or the port's model code,
equal their eager engine bit for bit; the file's header, magic and input
checks; the ``--aot`` libraries.  The other modes, the CLI and
``ArtifactEngine`` are in ``test_torch_deploy_cli.py`` and
``test_torch_artifact_engine.py``, and the ``plan`` artifact against the
JAX engine in ``test_torch_pipeline.py`` (whose JAX engine is compiled
there already): an export takes seconds, and each file keeps to a share
of them."""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tod_tpu_torch import deploy
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.ops.preprocess import pack_frame
from tod_tpu_torch.runtime.engine import Engine
from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAM = dict(width=160, height=120)
MODEL = dict(input_size=(256, 320), dtype="float32")
PLANNER = dict(start_offset=80)
FRAMES = (0, 4, 7)
# name -> (engine, artifact mode)
ARTIFACTS = {
    "plan": ("detect", "plan"),
    "track_plan": ("detect", "track_plan"),
}


def pipeline(**kw) -> tcfg.PipelineConfig:
    model = tcfg.ModelConfig(**MODEL, quantized=kw.pop("quantized", False))
    return tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM), model=model,
                               planner=tcfg.PlannerConfig(backend="tpu", **PLANNER), **kw)


def packed_frame(t: int) -> torch.Tensor:
    f = synth_frame_numpy(0, t, CAM["height"], CAM["width"])
    return torch.from_numpy(pack_frame(f.rgb, f.depth))


def flat(out) -> list[np.ndarray]:
    return [t.numpy() for t in out] if isinstance(out, tuple) else [out.numpy()]


@pytest.fixture(scope="module")
def engines():
    from tod_tpu_torch.core.weights import load_pinned

    return {"detect": Engine(pipeline(tracker=tcfg.TrackerConfig(enabled=True)), load_pinned(),
                             device="cpu")}


@pytest.fixture(scope="module")
def artifacts(engines, tmp_path_factory):
    """name -> path of each mode's artifact."""
    out = tmp_path_factory.mktemp("artifacts")
    paths = {}
    for name, (eng, mode) in ARTIFACTS.items():
        exported, meta = deploy.export_engine(engines[eng], mode)
        paths[name] = str(out / f"{name}.todx")
        deploy.save_artifact(exported, meta, paths[name])
    return paths


LOADER = r"""
import json, sys
for name in ("jax", "flax", "msgpack", "orbax", "PIL", "tod_tpu", "tod_tpu_torch.models"):
    sys.modules[name] = None
import numpy as np, torch
from tod_tpu_torch.deploy import ServingArtifact
from tod_tpu_torch.ops.preprocess import pack_frame
from tod_tpu_torch.runtime.frame_source import synth_frame_numpy
paths, frames, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
arrays = {}
for name, path in paths.items():
    art = ServingArtifact.load(path, device="cpu")
    bank = art.init_tracks() if art.meta["mode"] == "track_plan" else None
    for t in frames:
        f = synth_frame_numpy(0, t, art.meta["camera"]["height"], art.meta["camera"]["width"])
        packed = torch.from_numpy(pack_frame(f.rgb, f.depth))
        res = art.call(packed) if bank is None else art.call(packed, bank)
        res = res if isinstance(res, tuple) else (res,)
        for i, r in enumerate(res):
            arrays[f"{name}/{t}/{i}"] = r.numpy().copy()
    arrays[f"{name}/boot"] = np.array(art.boot)
np.savez(out, **arrays)
print(json.dumps(sorted(m for m in sys.modules if m.startswith("tod_tpu_torch.models")
                        and sys.modules[m] is not None)))
"""


def load_elsewhere(paths: dict, frames, out: pathlib.Path):
    """Every artifact of ``paths`` served on ``frames`` in one process that
    blocks jax, ``tod_tpu`` and ``tod_tpu_torch.models`` -> (outputs by
    ``name/frame/index``, the model modules it imported)."""
    r = subprocess.run(
        [sys.executable, "-c", LOADER, json.dumps(paths), json.dumps(frames), str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)},
    )
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as npz:
        return dict(npz), json.loads(r.stdout.strip().splitlines()[-1])


def hold_against_eager(outputs, name: str, eng, mode: str, frames) -> None:
    """The artifact ``name``'s outputs equal ``eng``'s eager step's bit for
    bit, frame by frame (``track_plan``: the plan and the bank, threaded)."""
    bank = eng._init_tracks()
    for t in frames:
        if mode == "track_plan":
            want = flat(eng.serve_step_track_plan(packed_frame(t), bank))
        else:
            want = flat(getattr(eng, f"serve_step_{mode}")(packed_frame(t)))
        got = [outputs[f"{name}/{t}/{i}"] for i in range(len(want))]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert str(outputs[f"{name}/boot"]) == "jit"


@pytest.fixture(scope="module")
def loaded(artifacts, tmp_path_factory):
    return load_elsewhere(artifacts, FRAMES, tmp_path_factory.mktemp("loaded") / "out.npz")


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_artifact_equals_its_eager_engine(engines, loaded, name):
    """Frame by frame the loaded artifact's outputs equal the eager step's
    bit for bit (``track_plan``: the plan and the bank it advanced)."""
    outputs, models = loaded
    assert models == []
    eng, mode = ARTIFACTS[name]
    hold_against_eager(outputs, name, engines[eng], mode, FRAMES)


class TestFile:
    def test_header_reads_without_the_payload(self, artifacts):
        meta = deploy.read_meta(artifacts["track_plan"])
        assert meta["mode"] == "track_plan" and meta["format"] == deploy.FORMAT
        assert meta["camera"] == {"height": 120, "width": 160}
        assert meta["packed_input_bytes"] == 120 * 160 * 5
        assert meta["tracker"] == {"max_tracks": 8, "state_width": 10}
        assert meta["kernels"] == ["bump", "connections", "mask_assembly", "path_walk",
                                   "relax", "track"]
        assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
        assert meta["kernel_limits"] == [] and "aot" not in meta
        assert os.path.getsize(artifacts["track_plan"]) > meta["payload_bytes"] > 0

    def test_bad_magic_and_a_jax_artifact_are_refused(self, tmp_path):
        bad = tmp_path / "bad.todx"
        bad.write_bytes(b"NOTATODX" + bytes(16))
        with pytest.raises(ValueError, match="bad magic"):
            deploy.read_meta(str(bad))
        jax_file = tmp_path / "jax.todx"
        jax_file.write_bytes(b"TODX1\n" + (2).to_bytes(8, "little") + b"{}")
        for read in (deploy.read_meta, lambda p: deploy.ServingArtifact.load(p, device="cpu")):
            with pytest.raises(ValueError, match="python -m tod_tpu_torch.deploy export"):
                read(str(jax_file))

    def test_wrong_inputs_are_refused(self, artifacts):
        art = deploy.ServingArtifact.load(artifacts["plan"], device="cpu")
        with pytest.raises(ValueError, match=r"\(96000,\) uint8 packed frame"):
            art.call(torch.zeros(1000, dtype=torch.uint8))
        with pytest.raises(ValueError, match="uint8"):
            art.call(torch.zeros(96000, dtype=torch.int32))
        with pytest.raises(ValueError, match="takes"):
            art.call(packed_frame(0), torch.zeros(8, 10))
        with pytest.raises(ValueError, match="track_plan"):
            art.init_tracks()
        assert len(art.plan(packed_frame(0)).directions) > 5

    def test_planner_config_comes_from_the_header(self, artifacts):
        pcfg = deploy.planner_config_from_meta(deploy.read_meta(artifacts["plan"]))
        want = tcfg.PlannerConfig(**PLANNER)
        assert (pcfg.start_offset, pcfg.signed_turns, pcfg.max_path_steps) == (
            80, False, want.max_path_steps)


def test_boot_from_an_artifact(artifacts, capsys):
    """``bench.boot --todx`` on the CPU: the artifact's load stages, then
    the first plan through it, ``boot`` named ``todx-`` + the load's, and
    no source compiled."""
    from tod_tpu_torch.bench import boot

    assert boot.main(["--todx", artifacts["plan"], "--width", "160", "--height", "120"],
                     device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["boot"] == "todx-jit" and line["nvcc_built"] == []
    assert list(line["stages_s"]) == ["python", "import_torch", "device_first_touch",
                                      "frame_prep", "artifact_load", "artifact_load_stages",
                                      "first_plan"]
    assert line["first_path_len"] > 5


class TestAot:
    """The ``--aot`` libraries, with fake bytes in place of built ones."""

    BLOB = b"AAAABBBB"

    @classmethod
    def aot_meta(cls, names, capability=(9, 0)):
        from tod_tpu_torch.kernels import _build

        libs = [{"source": s, "name": _build.library_path(s).name if names else f"lib{s}-0.so",
                 "bytes": 4, "sha256": hashlib.sha256(cls.BLOB[4 * i: 4 * i + 4]).hexdigest()}
                for i, s in enumerate(("relax", "path_walk"))]
        return {"compute_capability": list(capability), "libraries": libs}

    def test_matching_names_are_written_with_no_build(self, tmp_path, monkeypatch):
        from tod_tpu_torch.kernels import _build

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "lib")
        monkeypatch.setattr(_build, "built", [])
        assert deploy.install_libraries(self.aot_meta(True), self.BLOB, (9, 0))
        assert (_build.library_path("relax").read_bytes(),
                _build.library_path("path_walk").read_bytes()) == (b"AAAA", b"BBBB")
        assert _build.built == [] and not list((tmp_path / "lib").glob("*.tmp"))

    @pytest.mark.parametrize("names,capability", [(False, (9, 0)), (True, (8, 0))])
    def test_other_names_or_another_card_leave_the_jit_boot(self, tmp_path, monkeypatch,
                                                            names, capability):
        from tod_tpu_torch.kernels import _build

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "lib")
        assert not deploy.install_libraries(self.aot_meta(names), self.BLOB, capability)
        assert not (tmp_path / "lib").exists()
        assert not deploy.install_libraries(None, b"", (9, 0))

    @pytest.mark.parametrize("blob", [b"AAAABBB", b"AAAABBBBC", b"AAAABBCB"],
                             ids=["truncated", "longer", "a_changed_byte"])
    def test_bytes_not_the_listed_ones_leave_the_jit_boot(self, tmp_path, monkeypatch, caplog,
                                                          blob):
        from tod_tpu_torch.kernels import _build

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "lib")
        with caplog.at_level("WARNING", logger="tod_tpu_torch.deploy"):
            assert not deploy.install_libraries(self.aot_meta(True), blob, (9, 0))
        assert not (tmp_path / "lib").exists()
        assert "truncated or changed" in caplog.text

    def test_aot_needs_the_card(self, artifacts):
        with pytest.raises(ValueError, match="export on the card"):
            deploy.build_aot(deploy.read_meta(artifacts["plan"]), torch.device("cpu"))


class TestExportRefusals:
    def test_track_plan_needs_a_tracked_engine(self):
        from tod_tpu_torch.core.weights import load_pinned

        eng = Engine(pipeline(), load_pinned(), device="cpu")
        with pytest.raises(ValueError, match="tracked engine"):
            deploy.export_engine(eng, "track_plan")
        with pytest.raises(ValueError, match="unknown artifact mode"):
            deploy.export_engine(eng, "frames")

    def test_track_plan_refuses_the_obstacle_memory(self):
        """ADVICE.md: a track_plan export from an engine with obstacle memory
        would silently drop the memory layer."""
        from tod_tpu_torch.core.weights import load_pinned

        eng = Engine(pipeline(tracker=tcfg.TrackerConfig(enabled=True, obstacle_memory=0.8)),
                     load_pinned(), device="cpu")
        with pytest.raises(ValueError, match="obstacle memory"):
            deploy.export_engine(eng, "track_plan")
