"""``GET /profile`` and the engine's device capture on the port's daemon,
held against the JAX daemon on the same weights and requests: the same
status codes and ``status`` strings (404 on the window batcher, 400 on a
bad ``dispatches``, 409 ``profile_busy``, 504 ``profile_timeout`` with
the capture disarmed), the attribution's keys, ``stats()["device"]``
under ``engine`` in ``/healthz`` (and the port's ``/stats``), the ``engine.device``
track of ``/trace``, and the A13 families of ``/metrics``.  The analogues
of tests/test_serve.py's device-profile tests.

The tiny f32 fixture of tests/test_torch_obs.py.  The roofline needs a
memory bandwidth, which the CPU has none of: the tests that read it set
``MLCOMP_TPU_HBM_GBPS`` (the parameter both engines read).
"""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.serve import GenerationService as JService
from mlcomp_tpu.serve import make_http_server as j_http
from mlcomp_tpu_torch.engine import ProfileBusy
from mlcomp_tpu_torch.io.weights import init_params
from mlcomp_tpu_torch.serve import load_service, make_http_server

torch.set_num_threads(1)

CFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
       "mlp_dim": 128, "dtype": "float32"}
TREE = init_params(CFG, seed=0)
SVC_KW = dict(batch_sizes=(1,), prompt_buckets=(16,), max_new_buckets=(8,), prefill_chunk=4,
              steps_per_dispatch=2)
# the A13 families of /metrics
A13 = ("mlcomp_engine_device_time_ms", "mlcomp_engine_profile_captures_total",
       "mlcomp_engine_device_time_ms_per_dispatch", "mlcomp_engine_roofline_utilization")


def _jax_service(**kw):
    return JService(j_create(dict(CFG)), {"params": jax.tree.map(jnp.asarray, TREE)},
                    **{**SVC_KW, **kw})


def _port_service(**kw):
    return load_service(CFG, params=TREE, device="cpu", **{**SVC_KW, **kw})


BOTH = [pytest.param((_jax_service, j_http), id="jax"),
        pytest.param((_port_service, make_http_server), id="port")]


@contextlib.contextmanager
def _daemon(which, **kw):
    make_svc, make_http = which
    svc = make_svc(**kw)
    httpd = make_http(svc, "127.0.0.1", 0, model_name="tiny")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield svc, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        svc.close()


def _get(url, timeout=120):
    """(status code, JSON body) of a GET, errors included."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _generate(url, prompt, n):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps({"prompt": prompt,
                                                  "max_new_tokens": n}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _families(text):
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def _both(fn, **kw):
    """fn(svc, url) on the JAX daemon, then on the port's."""
    out = []
    for which in ((_jax_service, j_http), (_port_service, make_http_server)):
        with _daemon(which, **kw) as (svc, url):
            out.append(fn(svc, url))
    return out


def _armed(svc):
    for _ in range(500):
        if svc.engine._profile is not None:
            return
        time.sleep(0.01)
    raise AssertionError("capture never armed")


def test_profile_404_on_the_window_batcher_as_trace():
    def run(svc, url):
        (c1, b1), (c2, b2) = _get(url + "/profile"), _get(url + "/trace")
        assert "continuous batcher" in b1["error"] and "continuous batcher" in b2["error"]
        return c1, c2

    want, got = _both(run, batcher="window")
    assert got == want == (404, 404)


def test_profile_bad_dispatches_400():
    def run(svc, url):
        out = []
        for bad in ("0", "-3", "nope", "99999", "257"):
            code, body = _get(f"{url}/profile?dispatches={bad}")
            assert "error" in body
            out.append(code)
        assert svc.engine._profile is None
        return out

    want, got = _both(run)
    assert got == want == [400] * 5


def test_profile_conflict_409_then_completes(monkeypatch):
    """A second capture while one is armed answers 409 ``profile_busy``;
    the armed capture then completes once decode traffic flows, over
    plain HTTP, with the JAX attribution's keys; ``stats()["device"]``
    turns capture-sourced, ``/healthz`` and ``/stats`` carry it under
    ``engine``, ``/trace`` holds the ``engine.device`` track and
    ``/metrics`` the A13 families."""
    monkeypatch.setenv("MLCOMP_TPU_HBM_GBPS", "100")

    def run(svc, url):
        result = {}

        def arm():
            result["resp"] = _get(f"{url}/profile?dispatches=1")

        th = threading.Thread(target=arm, daemon=True)
        th.start()
        _armed(svc)
        code, body = _get(url + "/profile")
        busy = (code, body["status"])
        deadline = time.time() + 120
        while th.is_alive() and time.time() < deadline:
            _generate(url, [3, 4, 5], 4)
        th.join(timeout=30)
        code, att = result["resp"]
        assert code == 200, att
        assert att["dispatches"] >= 1 and att["device_time_ms"] > 0
        assert att["host_gap_ms"] >= 0 and att["kernels"] and att["families"]
        dev = svc.engine.stats()["device"]
        assert dev["source"] == "capture" and dev["captures"] == 1
        assert dev["roofline_utilization"] is not None
        assert _get(url + "/healthz")[1]["engine"]["device"]["captures"] == 1
        code, st = _get(url + "/stats")         # the port's daemon alone has /stats
        assert code == 404 or st["engine"]["device"]["captures"] == 1
        tracks = {e["args"]["name"] for e in _get(url + "/trace")[1]["traceEvents"]
                  if e.get("ph") == "M" and e.get("name") == "thread_name"}
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            fams = _families(r.read().decode())
        return busy, set(att), set(dev), "engine.device" in tracks, set(A13) <= fams

    want, got = _both(run)
    assert got[0] == want[0] == (409, "profile_busy")
    # the port adds the wrappers' launches over the window and the bandwidth
    assert got[1] - {"launches", "hbm_gbps"} == want[1] and "launches" in got[1]
    assert got[2] == want[2]
    assert got[3:] == want[3:] == (True, True)


def test_profile_timeout_504_disarms_the_capture(monkeypatch):
    """No traffic: the wait runs out, the daemon answers 504
    ``profile_timeout`` and disarms the capture, so that a new one arms.
    (The wait is the service's request timeout plus 30 s in both daemons;
    the tests shorten it by setting the attribute.)"""
    def run(svc, url):
        svc.request_timeout_s = -29.5
        code, body = _get(url + "/profile?dispatches=2")
        assert svc.engine._profile is None
        fut = svc.profile(dispatches=2)
        assert svc.profile_cancel(fut)
        return code, body["status"]

    want, got = _both(run)
    assert got == want == (504, "profile_timeout")


@pytest.mark.parametrize("which", BOTH)
def test_profile_cancel_disarms_an_unstarted_capture(which):
    with _daemon(which) as (svc, _):
        fut = svc.profile(dispatches=4)
        assert svc.engine._profile is not None
        assert svc.profile_cancel(fut)
        assert svc.engine._profile is None
        with pytest.raises(RuntimeError, match="cancelled"):
            fut.result(timeout=5)
        fut2 = svc.profile(dispatches=4)  # the slot is free again
        assert svc.engine.profile_cancel(fut2)
        assert not svc.profile_cancel(fut2)


@pytest.mark.parametrize("which", BOTH)
def test_profile_future_fails_on_close(which):
    make_svc, _ = which
    svc = make_svc()
    fut = svc.profile(dispatches=2)
    svc.close()
    with pytest.raises(RuntimeError):
        fut.result(timeout=10)


def test_engine_profile_refusals_equal_the_jax_engines():
    """1 to 1024 dispatches, one capture at a time, a closed engine."""
    def run(svc, url):
        eng = svc.engine
        out = []
        for n in (0, 1025):
            with pytest.raises(ValueError, match=r"\[1, 1024\]"):
                eng.profile(dispatches=n)
        fut = eng.profile(dispatches=1024)
        try:
            eng.profile(dispatches=1)
        except RuntimeError as e:
            out.append((type(e).__name__, e.status))
        assert eng.profile_cancel(fut)
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.profile(dispatches=1)
        return out

    want, got = _both(run)
    assert got == want == [("ProfileBusy", "profile_busy")]
    assert issubclass(ProfileBusy, RuntimeError)


def test_a_capture_attributes_the_window_it_ran():
    """The port's capture over a decode window: the dispatches it asked
    for (and one more that was in flight), their families, the host gap the wall less the device time, the
    device spans on the recorder's ``engine.device`` track with a
    ``device_capture`` marker, and one observation of the device-time
    histogram."""
    svc = _port_service()
    try:
        eng = svc.engine
        fut = svc.profile(dispatches=2)
        job = svc.submit([5, 6, 7, 8], 8)
        att = fut.result(timeout=120)
        job.result(timeout=120)
        # the window closes once 2 resolved, after the one still in flight
        # (pipeline depth 2) resolves too
        assert att["requested_dispatches"] == 2 and att["dispatches"] in (2, 3)
        assert set(att["families"]) <= {"decode_scan_k2", "decode_scan_k2+prefill_c4"}
        assert sum(f["dispatches"] for f in att["families"].values()) == att["dispatches"]
        assert att["host_gap_ms"] == pytest.approx(
            max(att["wall_ms"] - att["device_time_ms"], 0.0), abs=2e-4)
        assert att["device_time_ms_per_dispatch"] == pytest.approx(
            att["device_time_ms"] / att["dispatches"], abs=1e-4)
        # on the CPU the wrappers take their plain versions: no launches
        assert set(att["launches"].values()) == {0}
        assert att["hbm_gbps"] is None and att["roofline_utilization"] is None
        dev_events = [e for e in eng.recorder.events
                      if e.get("name") == "device_capture"]
        assert len(dev_events) == 1
        assert dev_events[0]["args"]["dispatches"] == att["dispatches"]
        text = svc.metrics.render()
        assert "mlcomp_engine_device_time_ms_count 1" in text
        assert "mlcomp_engine_profile_captures_total 1" in text
    finally:
        svc.close()
