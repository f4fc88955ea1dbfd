"""The port's bench (``tod_tpu_torch.bench``) on the CPU: the registry and
its refusals, the CLIs, the peak table, ``fuse_scene_batch`` and config 14
against the JAX package's, the FLOP count against XLA's cost analysis, the
chained serve step, the boot's stages and the profile's categories.  Every
config runs at the JAX config's non-TPU sizes."""

from __future__ import annotations

import json
import pathlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.core import config as jcfg
from tod_tpu_torch.bench import configs
from tod_tpu_torch.bench.configs import CONFIGS, UNPORTED, run_config
from tod_tpu_torch.core import config as tcfg

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX package's metric name of each config the port runs
METRICS = {
    2: "latency_fastnms_mask_assembly",
    3: "latency_full_graph_b1",
    4: "latency_rgbd_fusion_b8",
    5: "fps_e2e_320x240_b1",
    6: "fps_e2e_640x480_b1",
    7: "batch2_model_throughput_64x64",
    8: "fps_latency_bounded_320x240",
    10: "int8_vs_bf16_serve_step_320x240",
    11: "train_step_batch1_48x64",
    12: "train_wall_chunked_batch2_48x64",
    13: "batch2_model_throughput_64x64_int8",
    14: "batch_scaling_peak_throughput_64x64",
    15: "backbone_family_batch2_64x64",
    16: "fps_multistream_sweep_320x240",
    17: "fps_latency_bounded_640x480",
    19: "tracked_serving_step_delta_ms",
}
# the ROADMAP.md item each unported config waits for
ITEMS = {1: "data/frc_balls.png", 9: "M16", 18: "M16"}
STAGES = ["python", "import_torch", "device_first_touch", "frame_prep", "weights_load",
          "kernel_build_or_load", "warmup", "first_plan"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once, and torch's default of a thread a core then
    oversubscribes the machine (config 4's plain ring loop took 944 s so,
    against 3 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class TestRegistry:
    def test_every_config_is_registered_with_a_docstring(self):
        assert sorted(CONFIGS) == list(range(1, 20))
        for fn in CONFIGS.values():
            assert callable(fn) and fn.__doc__
        assert sorted(set(METRICS) | set(ITEMS)) == list(range(1, 20))
        assert sorted(UNPORTED) == sorted(ITEMS)

    @pytest.mark.parametrize("n", sorted(ITEMS))
    def test_unported_config_exits_naming_its_item(self, n):
        with pytest.raises(SystemExit) as e:
            run_config(n, device="cpu")
        assert "ROADMAP.md" in str(e.value) and ITEMS[n] in str(e.value)

    @pytest.mark.parametrize("n", sorted(METRICS))
    def test_config_runs_on_the_cpu(self, n):
        out = run_config(n, device="cpu")
        assert out["metric"] == METRICS[n] and out["config"] == n
        assert out["value"] > 0 and out["unit"]
        assert out["backend"] == "cpu"
        assert out["device"] == {"name": "cpu", "power_limit_w": None, "count": 0}
        # no device metric from a CPU run
        assert out.get("mfu") is None
        for point in out.get("curve", []):
            assert point.get("mfu") is None

    def test_bounded_sweep_points(self):
        out = configs.latency_bounded_serving((48, 64), device="cpu", n_frames=4)
        assert [c["max_inflight"] for c in out["curve"]] == [1, 2, 4, None]
        for c in out["curve"]:
            assert c["fps"] > 0 and c["n_latency"] >= 1 and c["p50_ms"] <= c["p99_ms"]
        # best: the fastest bounded point within 33 ms, else the fastest of all
        bounded = [c for c in out["curve"] if c["max_inflight"] and c["p50_ms"] <= 33.0]
        assert out["value"] == max(c["fps"] for c in (bounded or out["curve"]))
        assert out["met_target"] == bool(bounded and out["value"] >= 30.0)
        for field in ("best_p50_rtt_free_ms", "transport_rtt_spread_ms", "weather"):
            assert field not in out


class TestCLI:
    def test_rejects_a_config_it_does_not_know(self):
        from tod_tpu_torch.bench.__main__ import main

        with pytest.raises(SystemExit):
            main(["--config", "99"])

    def test_refuses_without_a_card(self, monkeypatch):
        from tod_tpu_torch.bench.__main__ import main

        no_card(monkeypatch)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--config", "2"])

    def test_all_names_the_unported_and_runs_the_rest(self, monkeypatch, capsys):
        from tod_tpu_torch.bench import __main__ as cli

        ran = []
        monkeypatch.setattr(configs, "run_config",
                            lambda n, device: ran.append(n) or {"config": n, "value": 1.0})
        assert cli.main(["--all"], device="cpu") == 0
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert [x["config"] for x in lines] == list(range(1, 20))
        assert ran == sorted(METRICS)
        for x in lines:
            if x["config"] in ITEMS:
                assert ITEMS[x["config"]] in x["unported"]

    def test_headline_and_profiling_refuse_without_a_card(self, monkeypatch):
        from tod_tpu_torch.bench import headline, profiling

        no_card(monkeypatch)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            headline.main([])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            profiling.main(["--qvga-serve"])

    def test_unported_cli_flags_name_their_items(self, monkeypatch, capsys):
        """No profiling flag is unported any more: ``--train`` profiles the
        flagship's train step phase by phase (here at 48x64, batch 1, with
        the CPU's aten ops as the timeline)."""
        from tod_tpu_torch.bench import profiling

        monkeypatch.setattr(profiling, "TRAIN_HW", (48, 64))
        assert profiling.main(["--train", "--batch", "1"], device="cpu") == 0
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert report["profile"] == "train_step_b1_48x64" and report["timeline"] == "cpu"
        assert list(report["phases"]) == list(profiling.PHASES)
        for phase in ("forward", "loss", "backward", "optimizer"):
            assert report["phases"][phase]["activities"] > 0
        assert abs(sum(p["share"] for p in report["phases"].values()) - 1.0) < 1e-3


def test_power_limit_is_asked_of_the_card_by_its_identity(monkeypatch):
    """nvidia-smi's indices ignore CUDA_VISIBLE_DEVICES, so the limit is
    asked of the card torch names, by its uuid."""
    asked = []

    class Props:
        uuid = "6f1c0a52-7d2e-4c1b-9a3e-0b5d2e8f4c11"

    def run(cmd, **_):
        asked.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    configs._power_limit_w.cache_clear()
    monkeypatch.setattr(configs.subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    try:
        info = configs.device_info(torch.device("cuda", 1))
    finally:
        configs._power_limit_w.cache_clear()
    assert info == {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0, "count": 2}
    assert asked[0][1:3] == ["-i", f"GPU-{Props.uuid}"]


def test_headline_on_the_cpu():
    from tod_tpu_torch.bench import headline

    out = headline.measure("cpu", n_frames=3, k=1)
    assert out["metric"] == "fps_e2e_320x240_b1" == METRICS[5]
    assert out["fps_e2e_320x240_b1"] == out["value"] == max(out["fps_all_runs"]) > 0
    assert out["bounded_fps"] > 0 and out["bounded_p50_ms"] <= out["bounded_p99_ms"]
    assert out["device_step_ms"] > 0 and out["step_gflops"] > 0
    # no device metric, and no boot child, from a CPU run
    assert out["mfu"] is None and out["boot_cold_s"] is None
    assert out["profiled"]["timeline"] == "cpu" and 0 <= out["idle_share"] <= 1
    assert out["backend"] == "cpu" and out["device"]["name"] == "cpu"


def test_peak_flops_table():
    from tod_tpu_torch.bench.mfu import peak_flops

    assert peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_flops("NVIDIA H100 80GB HBM3", "int8") == 1979e12
    assert peak_flops("NVIDIA H100 SXM5 80GB") == 989e12
    assert peak_flops("NVIDIA H100 PCIe") == 756e12
    assert peak_flops("NVIDIA H100 PCIe", "int8") == 1513e12
    assert peak_flops("NVIDIA GeForce RTX 4090") is None
    assert peak_flops("cpu") is None


def _scenes_equal(got, want) -> None:
    for field in ("height", "pos", "balls", "connections"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)


class TestFuseSceneBatch:
    HW = (48, 64)

    def test_matches_jax_exactly(self):
        from tod_tpu.geometry.fusion import fuse_scene_batch as jax_fuse_batch
        from tod_tpu_torch.geometry.fusion import fuse_scene_batch

        h, w = self.HW
        depth, cls_map, id_map = configs.fusion_inputs(3, self.HW, seed=3)
        want = jax_fuse_batch(jnp.asarray(depth), jnp.asarray(cls_map), jnp.asarray(id_map),
                              jcfg.CameraConfig(width=w, height=h), jcfg.GeometryConfig())
        got = fuse_scene_batch(torch.from_numpy(depth.astype(np.int32)),
                               torch.from_numpy(cls_map), torch.from_numpy(id_map),
                               tcfg.CameraConfig(width=w, height=h), tcfg.GeometryConfig())
        assert got.height.shape == (3, h, w) and got.connections.shape == (3, h, w, 8)
        assert got.balls[:, 0, 2].min() > 0  # every frame has balls
        _scenes_equal(got, jax.device_get(want))

    def test_equals_fuse_scene_frame_by_frame(self):
        from tod_tpu_torch.geometry.fusion import fuse_scene, fuse_scene_batch

        h, w = self.HW
        cam, geom = tcfg.CameraConfig(width=w, height=h), tcfg.GeometryConfig()
        maps = [torch.from_numpy(a) for a in configs.fusion_inputs(3, self.HW, seed=4)]
        maps[0] = maps[0].to(torch.int32)
        got = fuse_scene_batch(*maps, cam, geom)
        for j in range(3):
            want = fuse_scene(*(m[j] for m in maps), cam, geom)
            _scenes_equal(type(want)(**{f: getattr(got, f)[j] for f in
                                        ("height", "pos", "balls", "connections")}), want)

    def test_on_the_card_equals_the_cpu(self):
        require_cuda()
        from tod_tpu_torch.geometry.fusion import fuse_scene_batch
        from tod_tpu_torch.kernels.bump import dilate_peaks
        from tod_tpu_torch.kernels.connections import connection_planes

        cfg = configs._pipeline_cfg()
        cam, geom = cfg.camera, cfg.geometry
        maps = [torch.from_numpy(a) for a in configs.fusion_inputs(2, (cam.height, cam.width))]
        maps[0] = maps[0].to(torch.int32)
        k4, k2 = dilate_peaks.launches, connection_planes.launches
        got = fuse_scene_batch(*(m.cuda() for m in maps), cam, geom)
        assert (dilate_peaks.launches - k4, connection_planes.launches - k2) == (2, 2)
        _scenes_equal(type(got)(**{f: getattr(got, f).cpu() for f in
                                   ("height", "pos", "balls", "connections")}),
                      fuse_scene_batch(*maps, cam, geom))


def test_config14_matches_jax_config14_on_the_cpu():
    from tod_tpu.bench.configs import config14_batch_scaling as jax_config14

    want = jax_config14()
    got = configs.config14_batch_scaling(device="cpu")
    assert set(got) == set(want) | {"device"}
    assert got["metric"] == want["metric"]
    assert [c["batch"] for c in got["curve"]] == [c["batch"] for c in want["curve"]]
    for point, jax_point in zip(got["curve"], want["curve"]):
        assert set(jax_point) <= set(point)
        assert point["step_ms"] > 0 and point["images_per_s"] > 0


def _flat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        d = out
        *parts, last = key.split("/")
        for p in parts:
            d = d.setdefault(p, {})
        d[last] = v
    return out


def test_forward_flops_against_xla_cost_analysis():
    """``FlopCounterMode`` counts the convolutions at 2 a multiply-add (bf16,
    channels-last input, depthwise included); XLA's cost analysis of the
    JAX forward also counts the BatchNorm, activation and elementwise work.
    The same narrow model, batch 2 at 64x64, a seeded tree of the JAX
    model's shapes carried across: the port's count is the lower, 0.906 of
    XLA's here (held to 0.85-1.0)."""
    from tod_tpu.bench.configs import _forward_flops
    from tod_tpu.core.config import ModelConfig as JaxModelConfig
    from tod_tpu.models.yolact import create_model
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.models.conv import Conv
    from tod_tpu_torch.models.yolact import Yolact

    hw = (64, 64)
    jax_model, _ = create_model(JaxModelConfig(input_size=hw, **configs.CPU_MODEL))
    x0 = jnp.zeros((2, *hw, 3), jnp.bfloat16)
    shapes = jax.eval_shape(lambda k: jax_model.init(k, x0, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = {k: (np.ones(v.shape, np.float32) if k.endswith("/var")
                else rng.normal(0, 0.1, v.shape).astype(np.float32))
            for k, v in _flat(shapes).items()}
    xla = _forward_flops(jax_model, jax.tree_util.tree_map(jnp.asarray, _nest(tree)), x0)

    model = Yolact(tcfg.ModelConfig(input_size=hw, **configs.CPU_MODEL))
    model.load_state_dict(carry_across(tree, model))
    model = model.to(torch.bfloat16).eval()
    x = torch.zeros((2, *hw, 3), dtype=torch.bfloat16)
    # the model's NCHW view of an NHWC batch is channels-last in memory
    assert x.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)

    # every convolution, counted from its shapes: 2 x output elements x
    # (input channels / groups) x kernel area
    expected = []

    def hook(conv, inputs, out):
        expected.append(2 * out.numel() * conv.weight[0].numel())

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv)]
    got = configs.count_flops(model, x)
    for h in handles:
        h.remove()
    assert got == sum(expected) > 0
    assert configs.count_flops(model.float(), x.float()) == got  # dtype does not count
    assert 0.85 <= got / xla < 1.0, (got, xla)


def test_chained_serve_step_returns_the_same_plan():
    cfg = tcfg.PipelineConfig(
        camera=tcfg.CameraConfig(width=160, height=120),
        model=tcfg.ModelConfig(input_size=(256, 320), dtype="float32"),
        planner=tcfg.PlannerConfig(start_offset=80),
    )
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    eng = Engine(cfg, configs.model_state(cfg.model), device="cpu")
    f = synth_frame_numpy(0, 0, 120, 160)
    packed = torch.from_numpy(pack_frame(f.rgb, f.depth))
    ev_s, host_s, plan = configs.chained_step_s(eng.serve_step_plan, packed, 2,
                                                torch.device("cpu"))
    assert ev_s == host_s > 0  # the host clock on the CPU
    want = eng.serve_step_plan(packed)
    assert int(want[0, 0]) > 0
    assert torch.equal(plan, want)


def test_boot_prints_every_stage_in_order(capsys):
    from tod_tpu_torch.bench import boot

    assert boot.main(["--width", "64", "--height", "48"], device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out["stages_s"]) == STAGES
    assert all(v >= 0 for v in out["stages_s"].values())
    assert out["boot_to_first_plan_s"] >= out["stages_s"]["first_plan"]
    assert out["backend"] == "cpu" and out["device"]["name"] == "cpu"


SET_BUILD_DIR = r"""
import pathlib, sys
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.native import loader
d = _build.set_build_dir(sys.argv[1])
assert loader.available()
try:
    _build.set_build_dir(sys.argv[1] + "-other")
except RuntimeError:
    print(sorted(p.name.split("-")[0] for p in d.iterdir()))
"""


def test_set_build_dir_moves_the_host_build(tmp_path):
    """The boot's cold build: g++ builds the native planner into the
    directory given, and the directory cannot move once a library is out."""
    out = subprocess.run([sys.executable, "-c", SET_BUILD_DIR, str(tmp_path / "b")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "['libplanner']"


class TestProfile:
    def test_top_ops_of_a_cpu_profile(self):
        from tod_tpu_torch.bench.profiling import capture_trace, top_ops

        mcfg = tcfg.ModelConfig(input_size=(64, 64), dtype="float32", **configs.CPU_MODEL)
        model = configs._model(mcfg, torch.device("cpu"))
        x = torch.zeros((1, 64, 64, 3))
        cpu = torch.device("cpu")
        report = top_ops(capture_trace(lambda: model(x).loc, cpu, iters=2), cpu, iters=2)
        assert report["timeline"] == "cpu"
        assert report["categories"]["convolution"] > 0
        assert sum(report["categories"].values()) <= report["wall_ms"] * (1 + 1e-9)
        assert 0 < report["busy_ms"] <= report["wall_ms"]
        assert 0 <= report["idle_share"] <= 1
        assert report["top"] and all(r["count"] >= 1 for r in report["top"])

    def test_a_card_profile_without_cuda_activity_raises(self):
        """No host op stands in for the card's time: a profile read for
        the card that traced no CUDA activity is refused."""
        from tod_tpu_torch.bench.profiling import capture_trace, top_ops

        x = torch.ones(64, 64)
        prof = capture_trace(lambda: x @ x, torch.device("cpu"), iters=2)
        with pytest.raises(RuntimeError, match="no CUDA activity"):
            top_ops(prof, torch.device("cuda"), iters=2)

    @pytest.mark.parametrize("name,cat", [
        ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "convolution"),
        ("void at::native::conv_depthwise2d_forward_kernel<c10::BFloat16>", "convolution"),
        ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>", "convolution"),
        ("void at::native::elementwise_kernel<128, 2, convert_fn>", "elementwise"),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "gemm"),
        ("nvjet_tst_64x8_64x16_1x4_h_bz_TNT", "gemm"),
        ("void nhwcAddPaddingKernel<__nv_bfloat16, (cudnnKernelDataType_t)0>", "convolution"),
        ("void mask_assembly_kernel<8>(float const*, float const*)", "ours"),
        ("bump_memo_kernel(Table, float, int, int, float*)", "ours"),
        ("Memcpy HtoD (Pinned -> Device)", "memcpy"),
        ("Memset (Device)", "memset"),
        ("void at::native::reduce_kernel<512, 1>", "reduction"),
        ("aten::conv2d", "convolution"),
        ("aten::add", "elementwise"),
        ("aten::amin", "reduction"),
    ])
    def test_category(self, name, cat):
        from tod_tpu_torch.bench.profiling import category, our_kernels

        assert category(name, our_kernels()) == cat

    def test_our_kernels_are_every_global_function(self):
        from tod_tpu_torch.bench.profiling import our_kernels

        assert set(our_kernels()) == {
            "bump_kernel", "bump_memo_kernel", "cc_border_kernel", "cc_flatten_kernel",
            "cc_local_kernel", "connections_kernel", "mask_assembly_kernel",
            "path_walk_kernel", "qconv_depthwise_kernel", "qconv_wgmma_kernel",
            "quantize_colmax_kernel", "quantize_kernel", "relax_kernel", "track_warp_kernel"}
