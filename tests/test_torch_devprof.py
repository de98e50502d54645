"""The port's device-profile reader (``obs/devprof.py``, Kineto's Chrome
trace JSON), its ``StepProfiler`` (``utils/profile.py``) and
``utils/trace.device_profile`` / ``annotate``, on the CPU, against the
JAX package's xplane reader and profiler where they have a counterpart.

- a handwritten Kineto trace: the card's lanes chosen over the host's,
  the union of overlapping streams, the attribution's numbers, kernel
  names made readable;
- a CPU capture: the outermost CPU operators stand in for the card's
  lanes, as the XLA:CPU threadpool's lines do in the JAX reader;
- the attribution's keys equal the JAX ``attribution``'s on its shipped
  CPU fixture;
- ``StepProfiler``'s window, a ``close`` mid-window and a resume past the
  window, as ``tests/test_extras.py`` holds the JAX profiler;
- the roofline's bandwidth: ``MLCOMP_TPU_HBM_GBPS``, else the card's data
  sheet, None on the CPU; no TPU figure in the port.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mlcomp_tpu.obs import devprof as jdevprof
from mlcomp_tpu_torch.obs import devprof
from mlcomp_tpu_torch.utils.profile import StepProfiler, create_profiler
from mlcomp_tpu_torch.utils.trace import annotate, device_profile

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JAX_FIXTURE = REPO / "tests" / "data" / "cpu_capture.xplane.pb"


def _kineto_doc():
    """A card's capture in Kineto's layout: two streams whose kernels
    overlap, a copy, a fill, and host events the lane selector must
    skip.  Times in us."""
    return {
        "schemaVersion": 1,
        "traceEvents": [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
            {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0,
             "args": {"name": "python3"}},
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 4242,
             "ts": 100.0, "dur": 900.0},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242,
             "tid": 4242, "ts": 101.0, "dur": 5.0},
            # stream 7: [1000, 1300) and [1500, 1600)
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 1000.0, "dur": 300.0,
             "name": "void qmm_gemv_tc_kernel<__nv_bfloat16, false, 8>(__nv_bfloat16 const*, "
                     "signed char const*, float const*, float const*, float, __nv_bfloat16*, "
                     "int, int, int, int)"},
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 1500.0, "dur": 100.0,
             "name": "void attend_split_kernel<128, 1>(Params)"},
            # stream 8 overlaps stream 7's first kernel: [1200, 1400)
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 8, "ts": 1200.0, "dur": 200.0,
             "name": "void qmm_gemv_tc_kernel<__nv_bfloat16, true, 8>(__nv_bfloat16 const*, "
                     "signed char const*, float const*, float const*, float, __nv_bfloat16*, "
                     "int, int, int, int)"},
            {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 2000.0, "dur": 50.0,
             "name": "Memcpy DtoH (Device -> Pinned)"},
            {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7, "ts": 2100.0, "dur": 0.0,
             "name": "Memset (Device)"},
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 2200.0, "dur": 25.0,
             "name": "void at::native::vectorized_elementwise_kernel<4, at::native::"
                     "FillFunctor<float>, std::array<char*, 1ul> >(int, "
                     "at::native::FillFunctor<float>, std::array<char*, 1ul>)"},
        ],
    }


def test_short_op_names_the_ports_kernels_readably():
    assert devprof.short_op("void qmm_gemv_tc_kernel<__nv_bfloat16, true, 8>(__nv_bfloat16 "
                            "const*, int)") == "qmm_gemv_tc_kernel<bf16, true, 8>"
    assert devprof.short_op("void attend_split_kernel<128, 4>(Params)") == (
        "attend_split_kernel<128, 4>")
    assert devprof.short_op("void qmm_wgmma_kernel(__nv_bfloat16 const*, int)") == (
        "qmm_wgmma_kernel")
    assert devprof.short_op("void at::native::vectorized_elementwise_kernel<4, at::native::"
                            "FillFunctor<float>, std::array<char*, 1ul> >(int)") == (
        "at::native::vectorized_elementwise_kernel<...>")
    assert devprof.short_op("void (anonymous namespace)::attend_split_kernel<128, 1>(Params)"
                            ) == "attend_split_kernel<128, 1>"
    assert devprof.short_op("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
                            "float, float, float, at::native::(anonymous namespace)::"
                            "SoftMaxForwardEpilogue>(float*, float const*, int)") == (
        "at::native::cunn_SoftMaxForward<...>")
    assert devprof.short_op("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert devprof.short_op("aten::mm") == "aten::mm"


def test_lane_selection_takes_the_cards_streams_over_the_host():
    lanes = devprof.device_lines(devprof.parse_trace(_kineto_doc()))
    assert sorted(lanes) == ["GPU 0/stream 7", "GPU 0/stream 8"]
    assert [ev.name.split("(")[0] for ev in lanes["GPU 0/stream 8"]] == [
        "void qmm_gemv_tc_kernel<__nv_bfloat16, true, 8>"]
    assert len(lanes["GPU 0/stream 7"]) == 5      # kernels, the copy and the fill


def test_attribution_on_a_handwritten_trace():
    """Stream 7 and 8 overlap on [1200, 1300): the union is 300 + 100 +
    100 + 50 + 25 = 575 us (the zero-length fill counts nothing)."""
    trace = devprof.parse_trace(_kineto_doc())
    att = devprof.attribution(trace, wall_ms=2.0)
    assert att["device_time_ms"] == pytest.approx(0.575, abs=1e-6)
    assert att["host_gap_ms"] == pytest.approx(2.0 - 0.575, abs=1e-6)
    assert att["wall_ms"] == 2.0
    assert att["device_events"] == 6
    assert att["planes"] == ["GPU 0", "python3"]
    assert att["device_lanes"] == ["GPU 0/stream 7", "GPU 0/stream 8"]
    assert [(k["name"], k["total_ms"], k["count"]) for k in att["kernels"]] == [
        ("qmm_gemv_tc_kernel<bf16, false, 8>", 0.3, 1),
        ("qmm_gemv_tc_kernel<bf16, true, 8>", 0.2, 1),
        ("attend_split_kernel<128, 1>", 0.1, 1),
        ("Memcpy DtoH", 0.05, 1),
        ("at::native::vectorized_elementwise_kernel<...>", 0.025, 1)]
    # a wall shorter than the device time: the gap clamps at 0
    assert devprof.attribution(trace, wall_ms=0.1)["host_gap_ms"] == 0.0
    assert "host_gap_ms" not in devprof.attribution(trace)


def test_busy_ms_merges_overlapping_lanes():
    # us: [0, 1000) and [500, 2000) overlap -> 2 ms, plus [3000, 4000)
    assert devprof.busy_ms([(0.0, 1000.0, None), (500.0, 2000.0, None),
                            (3000.0, 4000.0, None)]) == pytest.approx(3.0)
    assert devprof.busy_ms([]) == 0.0


def test_device_spans_are_capture_relative_and_keep_the_longest():
    trace = devprof.parse_trace(_kineto_doc())
    spans, dropped = devprof.device_spans_us(trace)
    assert dropped == 0 and spans[0][0] == 0.0
    assert [(s[0], s[1]) for s in spans] == [(0.0, 300.0), (200.0, 200.0), (500.0, 100.0),
                                            (1000.0, 50.0), (1200.0, 25.0)]
    spans, dropped = devprof.device_spans_us(trace, limit=2)
    assert dropped == 3 and [s[1] for s in spans] == [300.0, 200.0]


def test_a_cpu_capture_falls_back_to_its_outermost_operators():
    """No card activity: each thread's outermost operators are the lanes
    (a nested aten::mm inside aten::matmul counts once)."""
    doc = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::matmul", "pid": 1, "tid": 1, "ts": 0.0,
         "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 10.0,
         "dur": 80.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::relu", "pid": 1, "tid": 1, "ts": 150.0,
         "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 2, "ts": 160.0,
         "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "region", "pid": 1, "tid": 1,
         "ts": 0.0, "dur": 300.0},
    ]}
    trace = devprof.parse_trace(doc)
    lanes = devprof.device_lines(trace)
    assert {k: [e.name for e in v] for k, v in lanes.items()} == {
        "1/thread 1": ["aten::matmul", "aten::relu"], "1/thread 2": ["aten::add"]}
    att = devprof.attribution(trace, wall_ms=1.0)
    assert att["device_time_ms"] == pytest.approx(0.21)     # [0, 100) + [150, 260)
    assert att["device_events"] == 3


def test_a_live_cpu_capture_parses(tmp_path):
    """End to end: a torch.profiler window over CPU work, written by the
    StepProfiler and read back by the reader, the annotation included."""
    x = torch.randn(128, 128)
    with device_profile(str(tmp_path)) as d:
        with annotate("the_region"):
            (x @ x).relu().sum()
    assert d == str(tmp_path)
    path = devprof.find_trace(str(tmp_path))
    assert path.endswith(".pt.trace.json")
    trace = devprof.load_trace(path)
    names = {e["name"] for e in trace.events}
    assert "the_region" in names and "aten::mm" in names
    att = devprof.attribution(trace, wall_ms=1e4)
    assert att["device_time_ms"] > 0 and att["device_events"] > 0
    assert any(k["name"] == "aten::matmul" for k in att["kernels"])
    spans, dropped = devprof.device_spans_us(trace)
    assert spans and dropped == 0 and min(s[0] for s in spans) == 0.0


def test_find_trace_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        devprof.find_trace(str(tmp_path))


@pytest.mark.parametrize("wall_ms", [None, 1e4])
def test_attribution_keys_equal_the_jax_readers(tmp_path, wall_ms):
    """The port's attribution of a CPU capture carries exactly the keys
    the JAX reader's carries on its shipped CPU fixture."""
    want = jdevprof.attribution(jdevprof.load_xspace(str(JAX_FIXTURE)), wall_ms=wall_ms)
    with device_profile(str(tmp_path)):
        torch.randn(64, 64).sum()
    got = devprof.attribution(devprof.load_trace(devprof.find_trace(str(tmp_path))),
                              wall_ms=wall_ms)
    assert set(got) == set(want)
    assert set(got["kernels"][0]) == set(want["kernels"][0])
    assert got["device_time_ms"] > 0 and want["device_time_ms"] > 0


# --------------------------------------------------------- the profiler


def _files(d: Path):
    return [p for p in d.rglob("*") if p.is_file()] if d.exists() else []


def test_step_profiler_writes_trace(tmp_path):
    prof = StepProfiler(str(tmp_path / "prof"), start_step=1, num_steps=2)
    x = torch.ones(8, 8)
    for step in range(5):
        prof.step(step)
        assert prof.active == (1 <= step < 3)
        x * 2 + 1
    assert prof.done and not prof.active
    prof.close()
    (trace,) = _files(tmp_path / "prof")
    assert str(trace) == prof.trace_path
    assert devprof.attribution(devprof.load_trace(str(trace)))["device_events"] > 0


def test_step_profiler_close_mid_window(tmp_path):
    """close() while the window is open (an epoch ended mid-capture, the
    engine's teardown): the trace stops and lands, and the profiler is
    done for good: a later step inside what was the window never reopens
    it (a dangling profiler session breaks every later capture)."""
    prof = StepProfiler(str(tmp_path / "prof"), start_step=1, num_steps=10)
    prof.step(0)
    assert not prof.active
    prof.step(1)
    assert prof.active and not prof.done
    torch.ones(8, 8) * 2
    prof.close()
    assert not prof.active and prof.done
    assert len(_files(tmp_path / "prof")) == 1
    prof.step(2)
    assert not prof.active and prof.done
    prof.close()  # idempotent
    assert prof.done and len(_files(tmp_path / "prof")) == 1


def test_step_profiler_resume_past_window(tmp_path):
    """A restored trainer whose step counter is past the window never
    starts a trace."""
    prof = StepProfiler(str(tmp_path / "prof"), start_step=2, num_steps=3)
    for step in (7, 8, 9):
        prof.step(step)
        assert not prof.active and not prof.done
    prof.close()
    assert not prof.active
    assert not _files(tmp_path / "prof")


@pytest.mark.parametrize("device,host_ops,want", [
    ("cpu", True, ["CPU"]), ("cpu", False, ["CPU"]),
    ("cuda", True, ["CPU", "CUDA"]), ("cuda", False, ["CUDA"])])
def test_step_profiler_records_the_card_and_the_host_as_asked(monkeypatch, tmp_path, device,
                                                              host_ops, want):
    """A CUDA window records the card's activity, and the host's operators
    unless ``host_ops=False`` (the engine's capture); a CPU window always
    records the host's, its only lanes."""
    seen = []

    class Fake:
        def __init__(self, activities):
            seen.append(sorted(a.name for a in activities))

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            Path(path).write_text("{}")

    monkeypatch.setattr(torch.profiler, "profile", Fake)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    prof = StepProfiler(str(tmp_path), start_step=0, num_steps=1, device=device,
                        host_ops=host_ops)
    prof.step(0)
    prof.close()
    assert seen == [want] and prof.done


def test_create_profiler_reads_the_jax_config_shape():
    from mlcomp_tpu.utils.profile import create_profiler as j_create

    for cfg in (None, {}, True, {"dir": "p", "start_step": 2, "num_steps": 4}):
        got, want = create_profiler(cfg), j_create(cfg)
        if want is None:
            assert got is None
        else:
            assert (got.dir, got.start_step, got.stop_step) == (
                want.dir, want.start_step, want.stop_step)


def test_trainer_profile_config(tmp_path):
    """``profile: {dir, start_step, num_steps}`` on the Trainer writes a
    trace of its window, as the JAX Trainer does (tests/test_extras.py)."""
    from mlcomp_tpu_torch.train.loop import Trainer

    cfg = {
        "model": {"name": "mlp", "num_classes": 4, "hidden": [8]},
        "optimizer": {"name": "sgd", "lr": 0.1},
        "loss": "cross_entropy", "metrics": [], "epochs": 1,
        "profile": {"dir": str(tmp_path / "prof"), "start_step": 0, "num_steps": 1},
        "data": {"train": {"name": "synthetic_classification", "n": 64, "num_classes": 4,
                           "dim": 8, "batch_size": 32}},
    }
    tr = Trainer(cfg, device="cpu")
    stats = tr.fit()
    assert np.isfinite(stats["train/loss"])
    assert tr.profiler.done
    (trace,) = _files(tmp_path / "prof")
    att = devprof.attribution(devprof.load_trace(str(trace)))
    # one step's forward and backward ran inside the window
    assert att["device_time_ms"] > 0
    assert any(e["name"].startswith("autograd::engine") or e["name"] == "aten::addmm"
               for e in devprof.load_trace(str(trace)).events)


# ------------------------------------------------------------ roofline


def test_hbm_bandwidth_is_the_parameter_else_the_cards_data_sheet(monkeypatch):
    monkeypatch.delenv("MLCOMP_TPU_HBM_GBPS", raising=False)
    assert devprof.hbm_gbps("cpu") is None
    for name, want in (("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
                       ("NVIDIA H100 NVL", 3900.0), ("NVIDIA H200", 4800.0),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        assert devprof.hbm_gbps("cuda") == want, name
    monkeypatch.setenv("MLCOMP_TPU_HBM_GBPS", "1234.5")
    assert devprof.hbm_gbps("cuda") == 1234.5
    assert devprof.hbm_gbps("cpu") == 1234.5


def test_no_tpu_bandwidth_in_the_port():
    """The JAX roofline divides by a TPU v5e's 819 GB/s; the port never
    does."""
    tpu = re.compile(r"(?<![\d.])819(?![\d.])")
    for path in list((REPO / "mlcomp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not tpu.search(path.read_text()), path
    assert tpu.search("GBPS', '819'") and not tpu.search("mlp 8192")


def test_the_engines_roofline_is_null_on_the_cpu_and_set_by_the_parameter(monkeypatch):
    """On the CPU the engine's bandwidth is None and so is every roofline
    figure; ``MLCOMP_TPU_HBM_GBPS`` sets one: bytes over bandwidth."""
    from mlcomp_tpu_torch.engine import DecodeEngine
    from mlcomp_tpu_torch.io.weights import init_params
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.models.generation import prep_decode_variables

    monkeypatch.delenv("MLCOMP_TPU_HBM_GBPS", raising=False)
    cfg = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
           "mlp_dim": 128, "dtype": "float32", "kv_quant": True}
    model = prep_decode_variables(create_model(cfg, device="cpu"), init_params(cfg, seed=0))
    eng = DecodeEngine(model, slots=2, prompt_buckets=(16,), max_new_cap=8, prefill_chunk=8)
    try:
        eng.submit([3, 4, 5], 4).result(timeout=60)
        dev = eng.stats()["device"]
        assert dev["hbm_gbps"] is None and dev["roofline_ms_per_dispatch"] is None
        assert dev["roofline_utilization"] is None
        assert dev["steady_state"]["roofline_utilization_est"] is None
        w = sum(t.numel() * t.element_size()
                for t in list(model.parameters()) + list(model.buffers()))
        kv = sum(t.numel() * t.element_size() for layer in eng._d["cache"].layers
                 for t in vars(layer).values())
        assert dev["roofline_bytes_per_dispatch"] == eng.steps_per_dispatch * (w + kv)
    finally:
        eng.close()
    monkeypatch.setenv("MLCOMP_TPU_HBM_GBPS", "2000")
    eng = DecodeEngine(model, slots=2, prompt_buckets=(16,), max_new_cap=8, prefill_chunk=8)
    try:
        eng.submit([3, 4, 5], 4).result(timeout=60)
        dev = eng.stats()["device"]
        assert dev["hbm_gbps"] == 2000.0
        # rounded to 4 decimals, as the JAX engine rounds it
        assert dev["roofline_ms_per_dispatch"] == round(
            dev["roofline_bytes_per_dispatch"] / 2e12 * 1e3, 4)
    finally:
        eng.close()
