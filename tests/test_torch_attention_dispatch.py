"""The port's attention dispatch (ops/attention.py) against the JAX
package's rule, and the flash kernels' plain versions at the new head
dims and dtype against the Pallas kernel in interpret mode.

Dispatch: both dispatchers run over the ``MLCOMP_TPU_FLASH`` switch (on,
off, auto) and the cases the JAX package treats apart: a plain call, a
dense mask, causal with Sq != Sk, and S < 128.  The device branch is
stubbed on both sides (the JAX side sees a TPU, the port's wrapper sees a
CUDA tensor and launches the plain version in the kernel's place), so
the test holds the route each takes (flash or reference) and the warning
each gives, and that both compute the same attention (f32, 1e-5).  The
one difference is S < 128: the JAX kernel refuses it for its lane width,
the port's kernels take a ragged S, so the card keeps the flash route
there without a warning.

fp16: the kernels have no fp16 instance, so on the stubbed card the port
warns and takes the reference path (off: without a warning), held against
the JAX dispatch's fp16 output.

Plain versions: the forward's (out, lse) and the backward's gradients at
head dim 256 (and 192, padded to 256 on the card) and on f32, against
``jax.grad`` of the Pallas kernel in interpret mode, f32 within 1e-5 of
the largest entry.
"""

import gc
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlcomp_tpu.ops.attention as jattn
import mlcomp_tpu.ops.pallas.flash_attention as jflash
import mlcomp_tpu_torch.ops.attention as tattn
from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)

SWITCH = {"on": "1", "off": "0", "auto": "auto"}
# (name, b, sq, sk, h, h_kv, d, causal, dense mask)
CASES = [
    ("plain_causal", 1, 128, 128, 2, 1, 32, True, False),
    ("dense_mask", 1, 128, 128, 2, 2, 32, False, True),
    ("causal_sq_ne_sk", 1, 128, 256, 2, 2, 32, True, False),
    ("short_s", 2, 64, 64, 2, 2, 32, False, False),
]


def _inputs(seed, b, sq, sk, h, h_kv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32).astype(dtype),
            rng.standard_normal((b, sk, h_kv, d), dtype=np.float32).astype(dtype),
            rng.standard_normal((b, sk, h_kv, d), dtype=np.float32).astype(dtype))


def _route(module, name, routes, tag):
    real = getattr(module, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        routes.append(tag)
        return out

    return wrapped


def _jax_call(monkeypatch, q, k, v, mask, causal):
    routes = []
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    monkeypatch.setattr(jflash, "flash_attention",
                        _route(jflash, "flash_attention", routes, "flash"))
    monkeypatch.setattr(jattn, "reference_attention",
                        _route(jattn, "reference_attention", routes, "reference"))
    # earlier tests' cyclic garbage (an unclosed socket's ResourceWarning)
    # is collected before the window, not inside it
    gc.collect()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        out = jattn.dot_product_attention(
            *(jnp.asarray(x) for x in (q, k, v)),
            mask=None if mask is None else jnp.asarray(mask), causal=causal)
    return np.asarray(out), routes, [str(w.message) for w in got]


def _port_call(monkeypatch, q, k, v, mask, causal):
    routes = []
    # the CUDA branch, stubbed: the wrapper sees a kernel device and its
    # launch runs the plain version
    monkeypatch.setattr(fa, "runs_kernels", lambda t: True)
    monkeypatch.setattr(fa, "_launch_fwd", lambda q_, k_, v_, lo, hi, c, s: (
        routes.append("flash"), fa.flash_attention_plain(q_, k_, v_, c, s, lo, hi))[1])
    monkeypatch.setattr(tattn, "reference_attention",
                        _route(tattn, "reference_attention", routes, "reference"))
    gc.collect()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        out = tattn.dot_product_attention(
            *(torch.from_numpy(x) for x in (q, k, v)),
            mask=None if mask is None else torch.from_numpy(mask), causal=causal)
    return out.numpy(), routes, [str(w.message) for w in got]


@pytest.mark.parametrize("switch", list(SWITCH))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dispatch_takes_the_jax_route_and_warning(monkeypatch, switch, case):
    _, b, sq, sk, h, h_kv, d, causal, dense = case
    monkeypatch.setenv("MLCOMP_TPU_FLASH", SWITCH[switch])
    q, k, v = _inputs(1, b, sq, sk, h, h_kv, d)
    mask = None
    if dense:
        mask = np.random.default_rng(2).random((b, 1, sq, sk)) > 0.3
        mask[..., 0] = True
    ref, j_routes, j_warn = _jax_call(monkeypatch, q, k, v, mask, causal)
    out, t_routes, t_warn = _port_call(monkeypatch, q, k, v, mask, causal)
    if case[0] == "short_s" and switch != "off":
        # the JAX kernel refuses S < 128 and warns; the card keeps its kernels
        assert j_routes == ["reference"] and len(j_warn) == 1
        j_routes, j_warn = ["flash"], []
    assert t_routes == j_routes
    # the same warnings; each names the device of its tensors (here the
    # stubbed CUDA branch's CPU tensors)
    assert [w.replace("path on CPU", "path on TPU") for w in t_warn] == j_warn
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_a_cpu_tensor_keeps_the_plain_kernels_under_auto_and_on(monkeypatch):
    """No stub: on the CPU the wrapper runs the plain versions where the JAX
    package's auto path takes its reference, at any S; only causal with
    Sq != Sk falls back (the plain version's diagonal is position-aligned)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 1, 64, 64, 2, 2, 32))
    for switch in ("auto", "1"):
        monkeypatch.setenv("MLCOMP_TPU_FLASH", switch)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out = tattn.dot_product_attention(q, k, v, causal=True)
        ref, _ = fa.flash_attention_plain(q, k, v, True, 32 ** -0.5,
                                          fa._window(None, 1, 0, "cpu"),
                                          fa._window(None, 1, 64, "cpu"))
        assert torch.equal(out, ref)
        with pytest.warns(UserWarning, match="causal flash needs Sq == Sk"):
            tattn.dot_product_attention(q[:, :32], k, v, causal=True)


def test_head_dims_above_256_fall_back_loudly_on_the_card(monkeypatch):
    """The kernels have instances at 64, 128 and 256; above 256 the wrapper
    refuses on a CUDA tensor and the dispatcher warns and takes the
    reference path (the JAX kernel pads to 384 there: ROADMAP §B)."""
    monkeypatch.setattr(fa, "runs_kernels", lambda t: True)
    assert [fa.kernel_dh(d, torch.float32) for d in (32, 128, 129, 256)] == [64, 128, 256, 256]
    with pytest.raises(NotImplementedError, match="head dim 320 > 256"):
        fa.kernel_dh(320, torch.bfloat16)
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 1, 128, 128, 1, 1, 320))
    with pytest.warns(UserWarning, match="head dim 320 > 256"):
        out = tattn.dot_product_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, tattn.reference_attention(q, k, v, causal=True))
    assert fa.kernel_refusal(128, 128, 320, True) == "head dim 320 > 256"
    assert fa.kernel_refusal(256, 256, 256, True) is None
    assert fa.kernel_refusal(64, 64, 32, True) is None


@pytest.mark.parametrize("switch", list(SWITCH))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_fp16_on_the_card_falls_back_loudly_to_the_reference(monkeypatch, switch, causal):
    """The kernels have no fp16 instance: on a CUDA tensor the wrapper
    refuses, naming the dtype, and the dispatcher warns and takes the
    reference path (off: the reference without a warning), launching no
    kernel.  The output is held against the JAX dispatch's fp16 output on
    the same inputs (the JAX package's reference path off the TPU: both
    sides round the logits and the weights to fp16 at the same places, so
    they may differ by a rounding of each, within 2^-9 of the largest
    output)."""
    monkeypatch.setenv("MLCOMP_TPU_FLASH", SWITCH[switch])
    assert "torch.float16" in fa.kernel_refusal(128, 128, 64, causal, torch.float16)
    assert fa.kernel_refusal(128, 128, 64, causal, torch.bfloat16) is None
    q, k, v = _inputs(7, 2, 128, 128, 4, 2, 64, np.float16)
    ref = np.asarray(jattn.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                                 causal=causal))
    assert ref.dtype == np.float16
    out, routes, warns = _port_call(monkeypatch, q, k, v, None, causal)
    assert routes == ["reference"]
    if switch == "off":
        assert warns == []
    else:
        assert len(warns) == 1 and warns[0].startswith("flash attention unavailable (")
        assert "the kernels take bf16 or f32, not torch.float16" in warns[0]
    assert out.dtype == np.float16
    np.testing.assert_allclose(out.astype(np.float32), ref.astype(np.float32), rtol=0,
                               atol=2.0 ** -9 * np.abs(ref).max())


def _jax_grads(q, k, v, w, causal, lo, hi):
    def loss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=causal, kv_start=lo, kv_stop=hi,
                                     block_q=128, block_kv=128, interpret=True)
        return jnp.sum(out * w), out

    args = [jnp.asarray(x) for x in (q, k, v)]
    lo = None if lo is None else jnp.asarray(lo, jnp.int32)
    hi = None if hi is None else jnp.asarray(hi, jnp.int32)
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("d,causal,windows", [
    (256, True, None),
    (192, False, ([3, 40], [250, 180])),
    (256, False, ([0, 60], [256, 60])),      # an empty row: zero output and gradients
])
def test_plain_flash_at_dh256_and_f32_matches_pallas(d, causal, windows):
    b, s, h, h_kv = 2, 256, 2, 1
    q, k, v = _inputs(5, b, s, s, h, h_kv, d)
    w = np.random.default_rng(6).standard_normal((b, s, h, d), dtype=np.float32)
    lo, hi = windows if windows else (None, None)
    out_ref, grads_ref = _jax_grads(q, k, v, w, causal, lo, hi)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    lo_t = fa._window(None if lo is None else torch.tensor(lo), b, 0, "cpu")
    hi_t = fa._window(None if hi is None else torch.tensor(hi), b, s, "cpu")
    scale = d ** -0.5
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal, scale, lo_t, hi_t)
    np.testing.assert_allclose(out.numpy(), out_ref, rtol=0,
                               atol=1e-5 * np.abs(out_ref).max())
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.tensor(w), causal, scale,
                                         lo_t, hi_t)
    for name, g, r in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=f"d{name}")
    if windows and windows[0][1] == windows[1][1]:
        assert (out[1] == 0).all() and (lse[1] == -1e30).all()
        assert all((g[1] == 0).all() for g in grads)
