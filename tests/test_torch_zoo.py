"""The port's model zoo against the JAX package's, on the CPU.

``mlp``, ``mnist_cnn``, ResNet (the bottleneck family), ``unet``, ``bert``
(both pad modes, both heads) and ``vit`` (GAP and CLS pooling) at tiny
widths in f32.  Each takes the JAX package's own ``init_model`` weights,
moved across as numpy, and is held to the JAX module on the same inputs:

- eval logits within 1e-5;
- one train step's loss within 1e-5 relative and every parameter's
  gradient within 1e-4 of that leaf's largest JAX gradient (f32 sums in
  another order: ~1e-6 of it);
- the BatchNorm statistics after that step within 1e-6 (absolute and
  relative).

BERT with ``pad_mode: window`` is held against the Pallas flash kernel in
interpret mode (``MLCOMP_TPU_FLASH=1``) at S = 128, with a left-padded, a
right-padded and an all-pad row: the kernels give the dead row 0 where the
XLA reference gives the uniform average.  ``init_params`` is held to the
JAX ``init_model`` tree (paths, shapes, zero and one leaves, the kernels'
moments), and each parity trap between flax and torch has a test that
fails when it is got wrong.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.train.losses import create_loss as j_loss
from mlcomp_tpu.train.state import init_model as j_init
from mlcomp_tpu_torch.io.weights import flatten, init_params, init_variables
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models import zoo
from mlcomp_tpu_torch.train.losses import create_loss
from mlcomp_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

BERT = {"name": "bert_small", "hidden": 32, "layers": 2, "heads": 2, "mlp_dim": 64,
        "vocab_size": 64, "max_len": 128, "dtype": "float32"}
VIT = {"name": "vit_tiny", "hidden": 32, "layers": 1, "heads": 2, "mlp_dim": 64, "patch": 8,
       "num_classes": 5, "dtype": "float32"}
# the bottleneck ResNet at two stages of one block (a strided block with its
# projection included): resnet18's code path at half its compile time
RESNET = {"name": "resnet", "stage_sizes": [1, 1], "width": 8, "num_classes": 10,
          "dtype": "float32"}
UNET = {"name": "unet", "features": [8, 16], "num_classes": 4, "dtype": "float32"}


def _j_model(cfg):
    if cfg["name"] == "resnet":
        from mlcomp_tpu.models.resnet import ResNet

        return ResNet(**{k: v for k, v in cfg.items() if k != "name"})
    return j_create(dict(cfg))


def _port_model(cfg):
    if cfg["name"] == "resnet":
        from mlcomp_tpu_torch.models.resnet import ResNet

        return ResNet(**{k: v for k, v in cfg.items() if k != "name"}, device="cpu")
    return create_model(dict(cfg), device="cpu")


def _tokens(rng):
    ids = rng.integers(1, 64, (3, 128)).astype(np.int32)
    ids[0, 100:] = 0          # right padding
    ids[1, :30] = 0           # left padding
    ids[2, :] = 0             # no live key at all
    return ids


def _case(name):
    """(model cfg, x, y, loss name) of each family at its test size."""
    rng = np.random.default_rng(3)
    if name == "mlp":
        return ({"name": "mlp", "hidden": [16, 8]}, rng.standard_normal((8, 64), np.float32),
                rng.integers(0, 10, 8), "cross_entropy")
    if name == "mnist_cnn":
        return ({"name": "mnist_cnn", "features": [4, 8], "dense": 16},
                rng.random((4, 28, 28, 1), np.float32), rng.integers(0, 10, 4), "cross_entropy")
    if name == "resnet":
        return (RESNET, rng.random((4, 32, 32, 3), np.float32), rng.integers(0, 10, 4),
                "cross_entropy")
    if name == "unet":
        return (UNET, rng.random((2, 16, 16, 3), np.float32), rng.integers(0, 4, (2, 16, 16)),
                "pixel_cross_entropy")
    if name == "bert_dense":
        return BERT, _tokens(rng), rng.integers(0, 2, 3), "cross_entropy"
    if name == "bert_mlm":
        return ({**BERT, "num_classes": None, "layers": 1}, _tokens(rng),
                rng.integers(0, 64, (3, 128)), "cross_entropy")
    if name == "bert_window":
        return {**BERT, "pad_mode": "window"}, _tokens(rng), rng.integers(0, 2, 3), "cross_entropy"
    if name == "vit_gap":
        return VIT, rng.random((2, 32, 32, 3), np.float32), rng.integers(0, 5, 2), "cross_entropy"
    if name == "vit_cls":
        return ({**VIT, "pool": "cls"}, rng.random((2, 32, 32, 3), np.float32),
                rng.integers(0, 5, 2), "cross_entropy")
    raise KeyError(name)


def _jax_run(cfg, x, y, loss):
    """The JAX module's init weights, eval logits, and one train-mode step's
    loss, gradients and new batch_stats on them (one jit)."""
    model = _j_model(cfg)
    loss_fn = j_loss(loss)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    def run():
        params, ms = j_init(model, {"x": batch["x"][:1]}, jax.random.PRNGKey(0))

        def loss_of(p):
            out, new = model.apply({"params": p, **ms}, batch["x"], train=True,
                                   mutable=list(ms) + ["losses"])
            return loss_fn(out, batch), dict(new)

        logits = model.apply({"params": params, **ms}, batch["x"], train=False)
        (value, new), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        return params, ms, logits, value, grads, new.get("batch_stats", {})

    out = jax.tree.map(np.asarray, jax.jit(run)())
    return out[:3] + (float(out[3]),) + out[4:]


def _port_run(cfg, params, ms, x, y, loss):
    model = _port_model(cfg)
    model.load_variables(params, ms, train=True)
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    model.train()
    out = model(torch.from_numpy(x))
    value = create_loss(loss)(out, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    value.backward()
    grads = {k: p.grad.numpy() for k, p in model.params.items()}
    stats = {k: v.numpy() for k, v in model.batch_stats.items()}
    return logits, float(value), grads, stats


FAMILIES = ["mlp", "mnist_cnn", "resnet", "unet", "bert_dense", "bert_mlm", "bert_window",
            "vit_gap", "vit_cls"]


@pytest.mark.parametrize("family", FAMILIES)
def test_the_family_equals_the_jax_module(family, monkeypatch):
    cfg, x, y, loss = _case(family)
    if family == "bert_window":
        # the JAX package's Pallas flash kernel, in interpret mode on the CPU
        monkeypatch.setenv("MLCOMP_TPU_FLASH", "1")
    params, ms, j_logits, j_value, j_grads, j_stats = _jax_run(cfg, x, y, loss)
    logits, value, grads, stats = _port_run(cfg, params, ms, x, y, loss)
    assert logits.dtype == np.float32 and logits.shape == j_logits.shape
    np.testing.assert_allclose(logits, j_logits, rtol=0, atol=1e-5)
    assert value == pytest.approx(j_value, rel=1e-5)
    j_grads = flatten(j_grads)
    assert set(grads) == set(j_grads)
    for k, g in j_grads.items():
        if k.endswith("/k/bias"):
            # its exact gradient is 0 (the bias shifts every key's logit in
            # a row by the same q.b, which the softmax cancels): both sides
            # give rounding noise, held to its layer's q-bias scale
            scale = float(np.abs(j_grads[k[: -len("k/bias")] + "q/bias"]).max())
        else:
            scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 * scale, err_msg=k)
    j_stats = flatten(j_stats)
    assert set(stats) == set(j_stats)
    for k, s in j_stats.items():
        np.testing.assert_allclose(stats[k], s, rtol=1e-5, atol=1e-6, err_msg=k)
    if family == "resnet":
        assert stats and any(not np.allclose(s, flatten(ms["batch_stats"])[k])
                             for k, s in stats.items())
    if family == "bert_window":
        # the dead row: the kernels' 0 attention, not the uniform average
        monkeypatch.setenv("MLCOMP_TPU_FLASH", "0")
        model = _j_model(cfg)
        ref = np.asarray(jax.jit(lambda p: model.apply({"params": p}, jnp.asarray(x)))(
            jax.tree.map(jnp.asarray, params)))
        np.testing.assert_allclose(ref[:2], j_logits[:2], atol=1e-5)
        assert np.abs(ref[2] - j_logits[2]).max() > 1e-3


# ---------------------------------------------------------------- init_params

INITS = [
    ({"name": "mlp", "hidden": [16, 8]}, (1, 64)),
    ({"name": "mnist_cnn"}, (1, 28, 28, 1)),
    ({"name": "resnet50", "width": 16, "num_classes": 10}, (1, 64, 64, 3)),
    ({"name": "resnet101", "width": 8, "num_classes": 10}, (1, 32, 32, 3)),
    (UNET, (1, 16, 16, 3)),
    ({**BERT, "num_classes": None}, (1, 128)),
    ({"name": "vit_s16", "layers": 2, "pool": "cls"}, (1, 32, 32, 3)),
]


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in flatten(tree).items()}


@pytest.mark.parametrize("cfg,shape", INITS, ids=[c["name"] for c, _ in INITS])
def test_init_params_has_the_jax_init_tree(cfg, shape):
    model = j_create(dict(cfg))
    dtype = jnp.int32 if cfg["name"].startswith("bert") else jnp.float32
    want = jax.eval_shape(lambda: j_init(model, {"x": jnp.zeros(shape, dtype)},
                                         jax.random.PRNGKey(0)))
    params, ms = init_variables(cfg, seed=1, sample_shape=shape)
    assert _shapes(params) == _shapes(want[0])
    assert _shapes(ms) == _shapes(want[1])
    assert _shapes(init_params(cfg, seed=1, sample_shape=shape)) == _shapes(want[0])
    flat = flatten(params)
    for k, v in flat.items():
        assert v.dtype == np.float32, k
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "bias" or k in ("cls",):
            assert not v.any(), k
        if leaf == "scale":
            zero_init = k.endswith("BatchNorm_2/scale") and cfg["name"].startswith("resnet")
            assert (v == (0.0 if zero_init else 1.0)).all(), k
    for k, v in flatten(ms.get("batch_stats", {})).items():
        assert (v == (0.0 if k.endswith("mean") else 1.0)).all(), k


def test_init_params_draws_flax_distributions():
    """lecun_normal kernels (a normal truncated at 2 standard deviations,
    variance 1/fan_in), Embed's normal (variance 1/features) and pos_emb's
    normal(0.02), from numpy and from a torch generator alike."""
    cfg = {"name": "bert_small", "vocab_size": 4096}
    for device in (None, "cpu"):
        flat = {k: np.asarray(v) for k, v in flatten(init_params(cfg, seed=2, device=device,
                                                                 sample_shape=(1, 128))).items()}
        q = flat["TransformerLayer_0/q/kernel"]                       # (256, 4, 64)
        out = flat["TransformerLayer_0/out/kernel"]                   # (4, 64, 256)
        up = flat["TransformerLayer_1/Dense_0/kernel"]                # (256, 1024)
        for k, fan_in in ((q, 256), (out, 256), (up, 256)):
            std = np.sqrt(1.0 / fan_in)
            assert k.std() == pytest.approx(std, rel=0.02)
            assert np.abs(k).max() <= 2 * std / zoo.TRUNC_STD * (1 + 1e-6)
            assert np.abs(k).max() > 1.9 * std / zoo.TRUNC_STD
        emb = flat["tok_emb/embedding"]
        assert emb.std() == pytest.approx(np.sqrt(1 / 256), rel=0.02)
        assert np.abs(emb).max() > 4 * np.sqrt(1 / 256)           # not truncated
        assert flat["pos_emb"].std() == pytest.approx(0.02, rel=0.02)
        assert abs(float(flat["pos_emb"].mean())) < 1e-3


@pytest.mark.parametrize("family", ["mlp", "mnist_cnn", "resnet", "unet", "bert_dense",
                                    "vit_gap"])
def test_the_trainer_builds_each_family_from_its_model_config(family):
    cfg, x, y, loss = _case(family)
    if family == "resnet":
        cfg = {"name": "resnet18", "width": 8, "num_classes": 10, "dtype": "float32"}
    ds = {"mlp": {"name": "synthetic_classification", "dim": 64},
          "mnist_cnn": {"name": "synth_mnist"},
          "resnet": {"name": "synthetic_images", "height": 32, "width": 32, "num_classes": 10},
          "unet": {"name": "synthetic_segmentation", "height": 16, "width": 16},
          "bert_dense": {"name": "synthetic_tokens", "seq_len": 128, "vocab_size": 64},
          "vit_gap": {"name": "synthetic_images", "height": 32, "width": 32,
                      "num_classes": 5}}[family]
    tr = Trainer({"model": cfg, "loss": loss, "metrics": [], "epochs": 1,
                  "optimizer": {"name": "sgd", "lr": 0.1, "momentum": 0.9},
                  "data": {"train": {**ds, "n": 4, "batch_size": 2},
                           "valid": {**ds, "n": 2, "batch_size": 2, "seed": 1}}},
                 device="cpu")
    before = {k: v.clone() for k, v in tr.state.model_state.items()}
    stats = tr.fit()
    assert np.isfinite(stats["train/loss"]) and np.isfinite(stats["valid/loss"])
    assert tr.state.step == 2
    assert (family in ("resnet",)) == bool(before)
    for k, v in before.items():
        assert not torch.equal(v, tr.state.model_state[k]), k


# ------------------------------------------------------------- parity traps


def _flax_apply(module, x, **kw):
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw)
    return variables, module


def test_same_padding_is_flax_asymmetric_padding():
    """A 3x3 stride-2 conv on an even input pads 0 before and 1 after
    (ResNet's middle conv), as does a 2x2 stride-1 conv (U-Net's up conv);
    torch's symmetric padding=1 gives other numbers."""
    import flax.linen as nn

    x = np.random.default_rng(0).standard_normal((2, 8, 8, 3), np.float32)
    for kernel, strides in (((3, 3), (2, 2)), ((2, 2), (1, 1))):
        conv = nn.Conv(4, kernel, strides)
        variables = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
        want = np.asarray(conv.apply(variables, jnp.asarray(x)))
        m = zoo.ZooModel()
        m.load_variables({"c": jax.tree.map(np.asarray, variables["params"])})
        got = zoo.conv(zoo.Scope(m).sub("Conv", "c"), torch.from_numpy(x), 4, kernel,
                       strides).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        w = torch.from_numpy(np.asarray(variables["params"]["kernel"])).permute(3, 2, 0, 1)
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w,
                       torch.from_numpy(np.asarray(variables["params"]["bias"])), strides,
                       (kernel[0] - 1 + 1) // 2).permute(0, 2, 3, 1).numpy()
        assert sym.shape != want.shape or np.abs(sym - want).max() > 1e-2


def test_batch_norm_is_flax_batch_norm():
    """Train mode: f32 statistics with the fast variance, the running
    variance updated with the biased batch variance, momentum 0.9, eps
    1e-5; eval mode reads the running statistics.  The input sits far from
    zero with a small spread, where the fast variance and the two-pass one
    differ, and a batch of 4 pixels, where biased and unbiased differ."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = (30.0 + 0.5 * rng.standard_normal((1, 2, 2, 3))).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"scale": jnp.asarray([1.0, 2.0, 0.5]),
                            "bias": jnp.asarray([0.0, 0.1, -0.2])},
                 "batch_stats": {"mean": jnp.asarray([29.0, 30.0, 31.0]),
                                 "var": jnp.asarray([2.0, 0.5, 1.0])}}
    want, new = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    m = zoo.ZooModel()
    m.load_variables({"bn": jax.tree.map(np.asarray, variables["params"])},
                     {"batch_stats": {"bn": jax.tree.map(np.asarray, variables["batch_stats"])}})
    xt = torch.from_numpy(x).requires_grad_()
    got = zoo.batch_norm(zoo.Scope(m).sub("BatchNorm", "bn"), xt, True, torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    for k in ("mean", "var"):
        np.testing.assert_allclose(m.batch_stats[f"bn/{k}"].numpy(),
                                   np.asarray(new["batch_stats"][k]), rtol=1e-6, atol=1e-7)
    two_pass = x.reshape(-1, 3).astype(np.float64).var(0)
    unbiased = 0.9 * np.array([2.0, 0.5, 1.0]) + 0.1 * two_pass * 4 / 3
    assert np.abs(m.batch_stats["bn/var"].numpy() - unbiased).max() > 1e-4
    # the gradient of the custom backward against jax.grad
    g = rng.standard_normal(x.shape).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda x_: jnp.sum(bn.apply(variables, x_, mutable=["batch_stats"])[0] * g))(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-3)
    # eval mode
    eval_bn = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    want_eval = eval_bn.apply(variables, jnp.asarray(x))
    m.load_variables({"bn": jax.tree.map(np.asarray, variables["params"])},
                     {"batch_stats": {"bn": jax.tree.map(np.asarray, variables["batch_stats"])}})
    got_eval = zoo.batch_norm(zoo.Scope(m).sub("BatchNorm", "bn"), torch.from_numpy(x), False,
                              torch.float32)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=1e-5)


def test_layer_and_group_norm_take_flax_eps():
    """flax's LayerNorm and GroupNorm eps is 1e-6 (torch's 1e-5): on rows
    of tiny variance the two give visibly different outputs."""
    import flax.linen as nn

    x = (1e-3 * np.random.default_rng(0).standard_normal((2, 4, 4, 8))).astype(np.float32)
    m = zoo.ZooModel()
    ln = nn.LayerNorm()
    v = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    m.load_variables({"ln": jax.tree.map(np.asarray, v["params"])})
    got = zoo.layer_norm(zoo.Scope(m).sub("LayerNorm", "ln"), torch.from_numpy(x),
                         torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(ln.apply(v, jnp.asarray(x))), atol=1e-4)
    torch_default = F.layer_norm(torch.from_numpy(x), (8,)).numpy()
    assert np.abs(torch_default - got).max() > 1e-2
    gn = nn.GroupNorm(num_groups=4)
    v = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    m.load_variables({"gn": jax.tree.map(np.asarray, v["params"])})
    got = zoo.group_norm(zoo.Scope(m).sub("GroupNorm", "gn"), torch.from_numpy(x), 4,
                         torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(gn.apply(v, jnp.asarray(x))), atol=1e-4)
    torch_default = F.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), 4).permute(
        0, 2, 3, 1).numpy()
    assert np.abs(torch_default - got).max() > 1e-2


def test_gelu_is_the_tanh_approximation():
    import flax.linen as nn

    x = np.linspace(-4, 4, 101, dtype=np.float32)
    got = zoo.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(nn.gelu(jnp.asarray(x))), atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - got).max() > 1e-4


def test_bf16_models_compute_in_bf16_over_f32_params_with_f32_heads():
    """bf16 activations, f32 parameters and logits: the port's ResNet and
    BERT in bf16 give f32 logits within bf16 rounding of the JAX modules'
    (5% of the largest logit), and other logits than in f32."""
    for name in ("resnet", "bert_dense"):
        cfg, x, _y, _loss = _case(name)
        cfg = {**cfg, "dtype": "bfloat16"}
        if name == "bert_dense":
            cfg["layers"] = 1
        model = _j_model(cfg)
        params, ms = jax.jit(lambda: j_init(model, {"x": jnp.asarray(x[:1])},
                                            jax.random.PRNGKey(0)))()
        want = np.asarray(jax.jit(lambda p: model.apply({"params": p, **ms}, jnp.asarray(x),
                                                        train=False))(params))
        port = _port_model(cfg)
        port.load_variables(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, ms))
        assert all(p.dtype == torch.float32 for p in port.params.values())
        port.eval()
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, atol=0.05 * scale, err_msg=name)
        f32 = _port_model({**cfg, "dtype": "float32"})
        f32.load_variables(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, ms))
        f32.eval()
        with torch.no_grad():
            assert not torch.equal(f32(torch.from_numpy(x)), got), name
