"""The port's loss zoo, the dense-contrastive losses, the projector, the
semi-supervised loss, `clipped_argmax` and `sliding_miou` against the JAX
package, from seeded numpy inputs.

The JAX losses cast their inputs to float32 (`astype(jnp.float32)`, also
with x64 on), so the float64 cases hold the port in float64 against
JAX's float32 arithmetic: values to 2e-6 relative, gradients to 2e-5 of
their largest element. The port in float32 agrees as closely. The
projector holds its forward (eval and train mode, the BatchNorm update
included) through the weight bridge in float64 to 1e-10; `sliding_miou`
to 1e-7 (its window sums are exact, its class mean to one float32
rounding), `clipped_argmax` exactly.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.losses import contrastive as jc
from miccai2021_cataract_semantic_segmentation_tpu.losses import functional as jf
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.models.projector import (
    Projector as JaxProjector)
from miccai2021_cataract_semantic_segmentation_tpu.ops.metrics import (
    sliding_miou as jax_sliding_miou)
from miccai2021_cataract_semantic_segmentation_tpu.ops.misc import (
    clipped_argmax as jax_clipped_argmax)

from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import contrastive as pc
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import functional as pf
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.projector import Projector
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import sliding_miou
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.misc import clipped_argmax
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import bridge

from test_torch_eval import numpy_variables

VALUE_RTOL, GRAD_TOL = 2e-6, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _jax_value_and_grad(fn, x_nchw):
    """JAX value and gradient of fn(NHWC x) in x64 mode, the gradient NCHW."""
    jax.config.update("jax_enable_x64", True)
    try:
        v, g = jax.jit(jax.value_and_grad(fn))(_nhwc(x_nchw))
        return float(v), np.asarray(g).transpose(0, 3, 1, 2)
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_value_and_grad(fn, x_nchw, dtype=torch.float64):
    x = torch.tensor(x_nchw, dtype=dtype, requires_grad=True)
    v = fn(x)
    v.backward()
    return float(v.detach()), x.grad.double().numpy()


def _close(got, want):
    (gv, gg), (wv, wg) = got, want
    np.testing.assert_allclose(gv, wv, rtol=VALUE_RTOL, atol=1e-7)
    scale = max(float(np.abs(wg).max()), 1e-12)
    np.testing.assert_allclose(gg, wg, rtol=0, atol=GRAD_TOL * scale)


def _case(seed, n=2, c=17, h=6, w=7, ignore_frac=0.2):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c, h, w)) * 2
    labels = rng.integers(0, c, (n, h, w))
    labels[rng.random((n, h, w)) < ignore_frac] = c        # task 2's ignore id
    return logits, labels


# name, port fn(x, labels), JAX fn(x_nhwc, labels), ignore share
ZOO = {
    "ohem": (lambda x, lb: pf.ohem_cross_entropy(x, lb, ignore_index=17),
             lambda x, lb: jf.ohem_cross_entropy(x, lb, ignore_index=17), 0.2),
    "ohem_min_kept": (lambda x, lb: pf.ohem_cross_entropy(x, lb, 17, 0.7, 20),
                      lambda x, lb: jf.ohem_cross_entropy(x, lb, 17, 0.7, 20), 0.2),
    "ohem_low_thresh": (lambda x, lb: pf.ohem_cross_entropy(x, lb, 17, 0.05, 5),
                        lambda x, lb: jf.ohem_cross_entropy(x, lb, 17, 0.05, 5), 0.0),
    "ohem_all_ignored": (lambda x, lb: pf.ohem_cross_entropy(x, lb, 17),
                         lambda x, lb: jf.ohem_cross_entropy(x, lb, 17), 1.0),
    "focal": (lambda x, lb: pf.focal_loss(x, lb),
              lambda x, lb: jf.focal_loss(x, lb), 0.0),
    "focal_ignore_gamma3": (lambda x, lb: pf.focal_loss(x, lb, 3.0, ignore_index=17),
                            lambda x, lb: jf.focal_loss(x, lb, 3.0, ignore_index=17), 0.2),
    "focal_alpha": (lambda x, lb: pf.focal_loss(x, lb, alpha=np.linspace(0.2, 2, 17)),
                    lambda x, lb: jf.focal_loss(x, lb, alpha=np.linspace(0.2, 2, 17)), 0.2),
    "gendice": (lambda x, lb: pf.generalized_dice(x, lb),
                lambda x, lb: jf.generalized_dice(x, lb), 0.2),
    "gendice_auto": (lambda x, lb: pf.generalized_dice(x, lb, "auto"),
                     lambda x, lb: jf.generalized_dice(x, lb, "auto"), 0.2),
    "gendice_naive_list": (
        lambda x, lb: pf.generalized_dice(x, lb, list(np.linspace(1, 2, 17)), True),
        lambda x, lb: jf.generalized_dice(x, lb, list(np.linspace(1, 2, 17)), True), 0.2),
    "soft_iou": (lambda x, lb: pf.soft_iou(x, lb),
                 lambda x, lb: jf.soft_iou(x, lb), 0.2),
    "soft_iou_naive": (lambda x, lb: pf.soft_iou(x, lb, naive=True),
                       lambda x, lb: jf.soft_iou(x, lb, naive=True), 0.2),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_loss_zoo_value_and_gradient_equal_jax(name):
    port_fn, jax_fn, ignore = ZOO[name]
    logits, labels = _case(len(name), ignore_frac=ignore)
    if name.startswith("gendice") or name.startswith("soft_iou"):
        labels[0, 0] = 3            # class 3 absent elsewhere is fine; keep one present
    want = _jax_value_and_grad(lambda x: jax_fn(x, jnp.asarray(labels)), logits)
    got = _port_value_and_grad(lambda x: port_fn(x, torch.as_tensor(labels)), logits)
    _close(got, want)
    got32 = _port_value_and_grad(lambda x: port_fn(x, torch.as_tensor(labels)),
                                 logits.astype(np.float32), torch.float32)
    _close(got32, want)
    if name == "ohem_all_ignored":
        assert want[0] == got[0] == 0.0


def test_ohem_keeps_what_the_jax_package_keeps():
    """The kept set at a threshold raised by min_kept: the gradient is
    non-zero exactly on the kept pixels, on both sides."""
    logits, labels = _case(11, n=1, h=9, w=9)
    want = _jax_value_and_grad(
        lambda x: jf.ohem_cross_entropy(x, jnp.asarray(labels), 17, 0.3, 30), logits)
    got = _port_value_and_grad(
        lambda x: pf.ohem_cross_entropy(x, torch.as_tensor(labels), 17, 0.3, 30), logits)
    kept_w = np.abs(want[1]).sum(axis=1) > 0
    kept_g = np.abs(got[1]).sum(axis=1) > 0
    np.testing.assert_array_equal(kept_g, kept_w)
    assert 0 < kept_w.sum() < (labels < 17).sum()


def _features(seed, b=2, d=8, h=9, w=10, c=17):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, d, h, w))
    labels = rng.integers(0, 5, (b, 2 * h, 2 * w))   # few classes: positives exist
    labels[rng.random(labels.shape) < 0.2] = c
    labels[0, :4, :4] = 255
    return feats, labels


@pytest.mark.parametrize("version,temperature", [("v1", 0.1), ("v1", 0.5),
                                                 ("v2", 0.1), ("v2", 0.3)])
def test_dense_contrastive_value_and_gradient_equal_jax(version, temperature):
    feats, labels = _features(3 if version == "v1" else 4)
    feats[1, :, 0, 0] = 0.0                       # a zero feature: finite gradients
    if version == "v1":
        jfn = lambda x: jc.dense_contrastive_loss(x, jnp.asarray(labels), 2, temperature)  # noqa: E731
        pfn = lambda x: pc.dense_contrastive_loss(x, torch.as_tensor(labels), 2, temperature)  # noqa: E731
    else:
        jfn = lambda x: jc.dense_contrastive_loss_v2(x, jnp.asarray(labels), 2, temperature, 2)  # noqa: E731
        pfn = lambda x: pc.dense_contrastive_loss_v2(x, torch.as_tensor(labels), 2,  # noqa: E731
                                                     temperature, 2)
    want = _jax_value_and_grad(jfn, feats)
    got = _port_value_and_grad(pfn, feats)
    _close(got, want)
    assert np.isfinite(got[1]).all() and got[0] > 0


def _outputs(seed, n=2, c=17, h=16, w=16):
    rng = np.random.default_rng(seed)
    return {"logits": rng.standard_normal((n, c, h, w)),
            "interm_logits": rng.standard_normal((n, c, h, w)),
            "proj_features": rng.standard_normal((n, 8, h // 4, w // 4))}


def _wrapper_cfg():
    return {"losses": {"TwoScaleLoss": 1.0, "CrossEntropyLoss": 0.5,
                       "OhemCrossEntropy": 0.3, "FocalLoss": 0.2, "GenDiceLoss": 0.2,
                       "SoftIoU": 0.1, "LovaszSoftmax": 0.7,
                       "DenseContrastiveLoss": 0.1, "DenseContrastiveLossV2": 0.1},
            "TwoScaleLoss": {"interm": {"name": "CrossEntropyLoss"},
                             "final": {"name": "FocalLoss"}},
            "OhemCrossEntropy": {"min_kept": 50},
            "GenDiceLoss": {"weights": "auto"},
            "DenseContrastiveLossV2": {"anchor_stride": 1, "temperature": 0.2},
            "dc_off_at_epoch": 1}


@pytest.mark.parametrize("epoch", [0, 1])
def test_loss_wrapper_every_term_equals_jax(epoch):
    """Each term of a LossWrapper of every loss, either side of
    dc_off_at_epoch (Lovász off before it, DC V1 off from it on, V2 never
    gated), and the gradient of the total through every output."""
    outs = _outputs(epoch)
    labels = np.random.default_rng(9).integers(0, 18, (2, 16, 16))
    jfn = jax_build_loss(_wrapper_cfg(), 2)
    keys = sorted(outs)

    def jax_total(*xs):
        total, terms = jfn(dict(zip(keys, xs)), jnp.asarray(labels), epoch=epoch)
        return total, terms

    jax.config.update("jax_enable_x64", True)
    try:
        (want, want_terms), want_g = jax.jit(jax.value_and_grad(
            jax_total, argnums=tuple(range(len(keys))), has_aux=True))(
                *[_nhwc(outs[k]) for k in keys])
        want_terms = {k: float(v) for k, v in want_terms.items()}
    finally:
        jax.config.update("jax_enable_x64", False)
    loss = build_loss(_wrapper_cfg(), 2, "cpu")
    assert loss.full_res == ("interm_logits", "logits")
    xs = {k: torch.tensor(v, requires_grad=True) for k, v in outs.items()}
    total, terms = loss(xs, torch.as_tensor(labels), epoch=epoch)
    total.backward()
    assert set(terms) == set(want_terms)
    for k, v in terms.items():
        np.testing.assert_allclose(float(v.detach()), want_terms[k], rtol=VALUE_RTOL,
                                   atol=1e-7, err_msg=k)
    assert (terms["LovaszSoftmax"] == 0) == (epoch < 1)
    assert (terms["DenseContrastiveLoss"] == 0) == (epoch >= 1)
    assert float(terms["DenseContrastiveLossV2"].detach()) > 0
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=VALUE_RTOL)
    for k, g in zip(keys, want_g):
        g = np.asarray(g).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(xs[k].grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(g).max()), err_msg=k)


def test_dense_contrastive_falls_back_to_deep_features():
    outs = _outputs(5)
    labels = torch.as_tensor(np.random.default_rng(1).integers(0, 18, (2, 16, 16)))
    loss = build_loss({"losses": {"DenseContrastiveLoss": 1.0}}, 2, "cpu")
    assert loss.full_res == ()
    feats = torch.as_tensor(outs["proj_features"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        projected = float(loss({"proj_features": feats}, labels)[0])
    with pytest.warns(UserWarning, match="deep_features"):
        raw = float(loss({"deep_features": feats}, labels)[0])
    assert projected == raw == float(pc.dense_contrastive_loss(feats, labels, 2))
    with pytest.raises(ValueError, match="proj_features"):
        loss({"logits": torch.as_tensor(outs["logits"])}, labels)


SEMI = {
    "ce": {"labeled": {"name": "CrossEntropyLoss"},
           "unlabeled": {"name": "CrossEntropyLoss", "weight": 0.5}},
    "ohem": {"labeled": {"name": "OhemCrossEntropy", "min_kept": 10}},
    "focal": {"labeled": {"name": "FocalLoss", "gamma": 1.5}},
    "lovasz": {"labeled": {"name": "LovaszSoftmax"}},
    "two_scale_bucket": {"labeled": {"name": "TwoScaleLoss", "lovasz_impl": "bucket",
                                     "interm": {"name": "LovaszSoftmax", "weight": 0.4},
                                     "final": {"name": "LovaszSoftmax"}}},
}


@pytest.mark.parametrize("name,task", [("ce", 1), ("ohem", 2), ("focal", 1),
                                       ("lovasz", 1), ("two_scale_bucket", 2)])
def test_semi_supervised_loss_equals_jax(name, task):
    """Both halves' terms and the total's gradient against JAX; the pseudo
    half's below-threshold pixels (id = the class count, also on task 1)
    count nowhere: logits under them do not move the loss."""
    c = {1: 8, 2: 17}[task]
    rng = np.random.default_rng(task * 10 + len(name))
    outs = {"logits": rng.standard_normal((4, c, 12, 12)),
            "interm_logits": rng.standard_normal((4, c, 12, 12))}
    labels = rng.integers(0, c, (4, 12, 12))
    labels[2:][rng.random((2, 12, 12)) < 0.3] = c
    cfg = {"name": "SemiSupervisedLoss", **SEMI[name]}
    jfn = jax_build_loss(cfg, task)
    keys = ("interm_logits", "logits")

    def jax_total(*xs):
        return jfn(dict(zip(keys, xs)), jnp.asarray(labels))

    jax.config.update("jax_enable_x64", True)
    try:
        (want, want_terms), want_g = jax.jit(jax.value_and_grad(
            jax_total, argnums=(0, 1), has_aux=True))(*[_nhwc(outs[k]) for k in keys])
    finally:
        jax.config.update("jax_enable_x64", False)
    loss = build_loss(cfg, task, "cpu")
    xs = {k: torch.tensor(outs[k], requires_grad=True) for k in keys}
    total, terms = loss(xs, torch.as_tensor(labels))
    total.backward()
    for k in ("labeled", "unlabeled"):
        np.testing.assert_allclose(float(terms[k]), float(want_terms[k]),
                                   rtol=VALUE_RTOL, atol=1e-7, err_msg=k)
    for k, g in zip(keys, want_g):
        g = np.asarray(g).transpose(0, 3, 1, 2)
        if xs[k].grad is None:                   # a single-scale loss reads `logits`
            assert k == "interm_logits" and not g.any()
            continue
        scale = max(float(np.abs(g).max()), 1e-12)
        np.testing.assert_allclose(xs[k].grad.numpy(), g, rtol=0, atol=GRAD_TOL * scale)
    ignored = np.broadcast_to((labels == c)[:, None], outs["logits"].shape)
    assert not xs["logits"].grad.numpy()[ignored].any()


def test_semi_supervised_loss_refuses_what_the_jax_package_refuses():
    for labeled in ({"name": "GenDiceLoss"}, {"name": "SoftIoU"}):
        for build in (jax_build_loss, lambda c, t: build_loss(c, t, "cpu")):
            with pytest.raises(NotImplementedError, match="ignore mechanism"):
                build({"name": "SemiSupervisedLoss", "labeled": labeled}, 1)
    mixed = {"name": "SemiSupervisedLoss", "labeled": {"name": "CrossEntropyLoss"},
             "unlabeled": {"name": "FocalLoss"}}
    with pytest.raises(NotImplementedError, match="different labelled"):
        build_loss(mixed, 2, "cpu")
    # the labelled config's own ignore settings win over the pseudo id
    loss = build_loss({"name": "SemiSupervisedLoss",
                       "labeled": {"name": "CrossEntropyLoss", "ignore_index": 3}}, 1, "cpu")
    assert loss.full_res == ("logits",)


@pytest.mark.parametrize("k,stride,hw", [(7, 4, (30, 41)), (3, 2, (17, 20)),
                                         (5, 1, (12, 9))])
@pytest.mark.parametrize("original_size", [True, False])
def test_sliding_miou_equals_jax(k, stride, hw, original_size):
    rng = np.random.default_rng(k + stride)
    logits = rng.standard_normal((2, 6, *hw)).astype(np.float32)
    labels = rng.integers(0, 7, (2, *hw))            # 6 = the ignore id here
    want = np.asarray(jax_sliding_miou(_nhwc(logits), jnp.asarray(labels), k, stride,
                                       original_size))
    got = sliding_miou(torch.as_tensor(logits), torch.as_tensor(labels), k, stride,
                       original_size)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # equal window sums and IoUs; the class mean to one float32 rounding
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    if original_size:
        assert want.shape[1:] == hw


def test_clipped_argmax_equals_jax():
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.full(5, 0.3), (2, 7, 9)).astype(np.float32)   # NHWK
    for t in (0.0, 0.5, 0.9):
        want = np.asarray(jax_clipped_argmax(jnp.asarray(probs), t, 5))
        got = clipped_argmax(torch.as_tensor(probs.transpose(0, 3, 1, 2)), t, 5)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="threshold"):
        clipped_argmax(torch.as_tensor(probs), 1.0, 5)


PROJECTORS = {
    "ocrnet": {"model": "OCRNet", "backbone": "resnet50",
               "projector": {"d": 8, "mlp": [[1, 16, 1]], "use_bn": True}},
    "deeplabv3plus": {"model": "DeepLabv3Plus", "backbone": "resnet50", "out_stride": 8,
                      "projector": {"d": 6, "mlp": [[3, 12, 1], [1, 10, 2]]}},
    "encdec": {"model": "EncDec", "encoder": {"model": "ResNet18"},
               "decoder": {"model": "UPerNet", "ppm_num_ch": 16, "fpn_num_ch": 16},
               "projector": {"d": 8, "mlp": [[3, 16, 2]], "use_bn": True}},
}
BRIDGES = {"ocrnet": bridge.bridge_ocrnet, "deeplabv3plus": bridge.bridge_deeplabv3plus,
           "encdec": bridge.bridge_encdec_upernet}


@pytest.mark.parametrize("name", sorted(PROJECTORS))
def test_projector_through_the_bridge_equals_jax(name):
    """The graph's flax tree (numpy-filled) through the bridge loads the
    port's model strictly, projector included; the port's `proj_features`
    (EncDec: its `deep_features`) equal flax's Projector on the port's
    layer 4, in float64, in eval mode and in train mode with the
    BatchNorm update."""
    graph = PROJECTORS[name]
    jax.config.update("jax_enable_x64", True)
    try:
        jmodel = jax_build_model(graph, 2, dtype=jnp.float64)
        variables = numpy_variables(jmodel, seed=len(name))
        model = build_model(graph, 2, device="cpu").double()
        model.load_state_dict(BRIDGES[name](variables["params"],
                                            variables.get("batch_stats", {})), strict=True)
        jproj = JaxProjector(**graph["projector"], dtype=jnp.float64)
        pvars = {"params": variables["params"]["projector"]}
        if "projector" in variables.get("batch_stats", {}):
            pvars["batch_stats"] = variables["batch_stats"]["projector"]
        x = torch.as_tensor(np.random.default_rng(1).random((2, 3, 32, 32)))
        with torch.no_grad():
            layer4 = (model.enc_model if name == "encdec" else model.backbone)(x)["layer4"]
            out = model(x)
        key = "deep_features" if name == "encdec" else "proj_features"
        want = np.asarray(jproj.apply(pvars, _nhwc(layer4.numpy()), False))
        np.testing.assert_allclose(out[key].numpy(), want.transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-10)
        if name == "encdec":
            assert "proj_features" not in out
        else:
            assert out["deep_features"].shape[1] == 2048
        proj = model.projector.train()
        got = proj(layer4)
        if graph["projector"].get("use_bn"):
            want_t, mutated = jproj.apply(pvars, _nhwc(layer4.numpy()), True,
                                          mutable=["batch_stats"])
            for i in range(len(graph["projector"]["mlp"])):
                bn = getattr(proj, f"mlp_bn_{i}")
                stats = mutated["batch_stats"][f"mlp_bn_{i}"]
                np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=1e-12)
                np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=1e-12)
        else:
            want_t = jproj.apply(pvars, _nhwc(layer4.numpy()), True)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want_t).transpose(0, 3, 1, 2), rtol=0, atol=1e-10)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_projector_layers_and_names():
    p = Projector(32, d=4, mlp=[[3, 8, 1], [1, 6, 2]], use_bn=True)
    assert sorted(k for k in p.state_dict() if not k.endswith("num_batches_tracked")) == sorted(
        ["mlp_0.weight", "mlp_1.weight", "out.weight", "out.bias"]
        + [f"mlp_bn_{i}.{leaf}" for i in (0, 1)
           for leaf in ("weight", "bias", "running_mean", "running_var")])
    assert p.mlp_bn_0.momentum == pytest.approx(3e-4)
    assert p(torch.rand(1, 32, 9, 9)).shape == (1, 4, 5, 5)
    hr = build_model({"model": "HRNetv2", "width": 4, "projector": {"d": 4}}, 2, device="cpu")
    assert not hasattr(hr, "projector")           # as the JAX package, HRNetv2 has none
