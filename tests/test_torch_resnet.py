"""The port's ResNet-50, ResNet-50-DIML and CvT-DIML models
(vit_reranking_tpu_torch/models/resnet.py, models/cvt.py::CvTDIML) and the
ResNet-50 converter against the JAX package's, on the CPU at 64 px.

Every weight and BatchNorm statistic is drawn with numpy from a seed into
the port's model and carried into the Flax model through
``weights.export_params`` (the inverse of ``load_jax_params``), so both
packages run the same weights on the same images.  Tolerances are relative
to the largest magnitude of the JAX output and stated where they are used.
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_reranking_tpu.core import convert as jax_convert
from vit_reranking_tpu.models import frozen_param_mask as jax_frozen_param_mask
from vit_reranking_tpu.models.cvt import CvTDIML as JaxCvTDIML, CvTSpec as JaxSpec
from vit_reranking_tpu.models.resnet import (ResNet50DIML as JaxResNet50DIML,
                                             ResNet50Network as JaxResNet50Network)

from vit_reranking_tpu_torch import models as archs
from vit_reranking_tpu_torch.core import convert
from vit_reranking_tpu_torch.core.config import Config
from vit_reranking_tpu_torch.models.cvt import CvTDIML, CvTSpec
from vit_reranking_tpu_torch.models.resnet import ResNet50DIML, ResNet50Network
from vit_reranking_tpu_torch.weights import export_params, flax_name, load_jax_params

from stand_ins import manifest_state_dict

torch.set_num_threads(2)

B, SIZE, EMBED = 2, 64, 16
TOL = 1e-4
SMALL = dict(dim_embed=(64, 64, 64), num_heads=(1, 1, 1), depth=(1, 1, 1),
             drop_path_rate=(0.0, 0.0, 0.0))


def _seeded(factory, seed):
    """``factory()``'s model with every parameter and statistic drawn with
    numpy: convs and linears N(0, 1/fan_in), norm scales and running
    variances in [0.5, 1.5], biases and running means N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, val in _meta(factory).state_dict().items():
        shape = tuple(val.shape)
        if name.endswith("num_batches_tracked"):
            arr = np.zeros(shape, np.int64)
        elif name.endswith("running_var") or (name.endswith("weight") and len(shape) == 1):
            arr = rng.uniform(0.5, 1.5, shape)
        elif name.endswith(("bias", "running_mean")):
            arr = rng.normal(0.0, 0.1, shape)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            arr = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        sd[name] = torch.from_numpy(arr.astype(np.float32) if arr.dtype.kind == "f" else arr)
    return _port(factory, sd)


def _meta(factory):
    """``factory()`` built on the meta device: the module with no values
    and none of the random initialisation's cost."""
    with torch.device("meta"):
        return factory()


def _port(factory, sd):
    """``factory()``'s model holding copies of the entries of ``sd``."""
    model = _meta(factory)
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    return model


def _tree(flat):
    """{"params/a/b": x} -> {"params": {"a": {"b": x}}}."""
    tree = {}
    for name, arr in flat.items():
        node = tree
        *mods, leaf = name.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def _images(seed=0, n=B, size=SIZE):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, (what, err)
    return err


@functools.lru_cache(maxsize=None)
def _jax_apply(module, train, ret_attn=False):
    """``module.apply`` jitted once per (module, mode): Flax modules hash by
    their fields, so two tests of one model share its compilation."""
    return jax.jit(lambda v, x: module.apply(v, x, train=train, ret_attn=ret_attn,
                                             mutable=["batch_stats"]))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


MODELS = {
    "resnet50_normalize": (lambda: ResNet50Network(embed_dim=EMBED),
                           lambda: JaxResNet50Network(embed_dim=EMBED)),
    "resnet50_diml": (lambda: ResNet50DIML(embed_dim=EMBED),
                      lambda: JaxResNet50DIML(embed_dim=EMBED)),
}


@pytest.fixture(scope="module")
def weights():
    """One seeded ResNet-50-DIML and its Flax variables; the retrieval
    network has the same entries (trunk and a (2048, D) last_linear)."""
    model = _seeded(lambda: ResNet50DIML(embed_dim=EMBED), 0)
    return model.state_dict(), _tree(export_params(model))


def _f64_trunk_map(model, x):
    """The trunk's (B, HW, 2048) map of ``model`` computed in f64 (every
    layer's compute dtype cleared), rounded to f32 at its end."""
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = None
    m.trunk.dtype = torch.float64
    with torch.no_grad():
        return m.trunk(x.double()).flatten(2).transpose(1, 2).numpy()


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_resnet_forward_matches_flax(weights, arch, mode):
    """Both outputs and the token map in evaluation mode (running
    statistics) and training mode (batch statistics, and the running
    statistics it leaves).

    Evaluation mode: within 1e-4 of the largest magnitude (measured ~2e-6).
    Training mode normalises by the statistics of 8 to 2048 values a
    channel, 53 BatchNorms deep, and f32 rounding grows through them: on
    these weights JAX's own f32 map is ~8e-4 from the same forward in f64,
    the port's ~3e-4.  So training mode holds the port to 2e-3 of JAX and
    to no further than JAX from the f64 forward (the port's model in f64,
    rounded once at its end), and the stem's and first stage's running
    statistics, before the growth, to 1e-4."""
    sd, variables = weights
    tm = _port(MODELS[arch][0], sd)
    jm = MODELS[arch][1]()
    x = _images()
    train = mode == "train"
    (jout, (jenc, jmap), _), new = _jax_apply(jm, train)(variables, jnp.asarray(x))
    tm.train(train)
    with torch.no_grad():
        out, (enc, tmap), aux = tm(_nchw(x))
    assert aux == {} and out.dtype == enc.dtype == tmap.dtype == torch.float32
    if arch == "resnet50_diml":
        assert out.shape == (B, 2, 2, EMBED) and enc.shape == (B, 2048)
    else:
        np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0, rtol=1e-6)
    tol = 2e-3 if train else TOL
    for what, got, want in (("out", out, jout), ("enc_out", enc, jenc), ("map", tmap, jmap)):
        _close(got.numpy(), want, tol, what)
    stats = {flax_name(n, v.ndim): v.numpy() for n, v in tm.state_dict().items()
             if "running" in n}
    ref = {"batch_stats/" + "/".join(p.key for p in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0]}
    assert set(stats) == set(ref)
    for name, want in ref.items():
        early = "/trunk/bn1/" in name or "/layer1_" in name
        _close(stats[name], want, TOL if (early or not train) else tol, name)
    if train:
        f64 = _f64_trunk_map(tm, _nchw(x))
        assert _rel(tmap.numpy(), f64) <= max(_rel(jmap, f64), TOL)


def test_frozen_batchnorm_reads_running_stats_in_training(weights):
    """`_frozen`: a training-mode forward gives the evaluation-mode output
    bit for bit, leaves every running statistic as it was, and matches the
    Flax model with ``bn_frozen`` in training mode (1e-4)."""
    sd, variables = weights
    tm = _port(lambda: archs.select("resnet50_frozen_normalize", Config(embed_dim=EMBED)), sd)
    x = _nchw(_images())
    with torch.no_grad():
        ev = tm.eval()(x)[0]
        tr = tm.train()(x)[0]
    assert torch.equal(ev, tr)
    for name, val in tm.state_dict().items():
        assert torch.equal(val, sd[name]), name
    jm = JaxResNet50Network(embed_dim=EMBED, bn_frozen=True)
    (jout, _, _), new = _jax_apply(jm, True)(variables, jnp.asarray(_images()))
    _close(tr.numpy(), jout, what="embed")
    for got, want in zip(jax.tree.leaves(new["batch_stats"]),
                         jax.tree.leaves(variables["batch_stats"])):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_resnet_bf16_close_to_f32(weights, arch):
    """bf16 trunk (BatchNorm statistics f32, heads f32): every output f32,
    and the first output's cosine to the f32 forward above 0.99 per image,
    as tests/test_models.py holds the JAX model; training mode runs and
    moves the running statistics."""
    sd, _ = weights
    opt = Config(embed_dim=EMBED)
    m32 = _port(lambda: archs.select(arch, opt), sd)
    m16 = _port(lambda: archs.select(arch, opt.replace(bf16=True)), sd)
    assert m16.trunk.dtype == torch.bfloat16
    x = _nchw(_images(3))
    with torch.no_grad():
        e32, (g32, t32), _ = m32.eval()(x)
        e16, (g16, t16), _ = m16.eval()(x)
    assert e16.dtype == g16.dtype == t16.dtype == torch.float32
    f32, f16 = e32.reshape(B, -1), e16.reshape(B, -1)
    cos = torch.sum(f32 * f16, -1) / (f32.norm(dim=-1) * f16.norm(dim=-1))
    assert float(cos.min()) > 0.99, cos
    before = m16.trunk.bn1.running_mean.clone()
    with torch.no_grad():
        m16.train()(x)
    assert not torch.equal(before, m16.trunk.bn1.running_mean)


def test_convert_resnet50_matches_jax(weights):
    """A stand-in of the torchvision ImageNet ResNet-50 (the key and shape
    set of tests/manifests/resnet50.json, seeded values): the JAX converter's
    output carried through ``load_jax_params`` is the port's conversion bit
    for bit, with the same entries; the audit passes with ``fc.*`` ignored,
    under the ``module.`` prefix too; the converted trunk's map and pooled
    feature match the Flax model's at 64 px (1e-4).  irresnet50 stays
    refused."""
    sd = manifest_state_dict("resnet50")
    base = weights[0]
    ours = convert.convert_for_arch("resnet50_frozen_normalize", sd)
    jp, js = jax_convert.convert_resnet50(sd)
    carried = load_jax_params(_port(lambda: ResNet50Network(embed_dim=EMBED), base).trunk,
                              {"params": jp["trunk"], "batch_stats": js["trunk"]}).state_dict()
    carried = {f"trunk.{k}": v for k, v in carried.items() if "num_batches" not in k}
    assert set(carried) == set(ours)
    for k, v in ours.items():
        assert torch.equal(carried[k], v), k
    model = _port(lambda: ResNet50Network(embed_dim=EMBED), base)
    report = convert.audit_conversion("resnet50_normalize", sd, target=model.state_dict())
    assert report["problems"] == [] and set(report["ignored_unconsumed"]) >= {"fc.weight",
                                                                               "fc.bias"}
    assert report["uncovered"] == ["last_linear.bias", "last_linear.weight"]
    wrapped = convert.convert_for_arch("resnet50_diml",
                                       {f"module.{k}": v for k, v in sd.items()})
    assert all(torch.equal(wrapped[k], v) for k, v in ours.items())
    model.load_state_dict(convert.merge_params(model.state_dict(), ours))
    x = _images(4)
    with torch.no_grad():
        _, (enc, tmap), _ = model.eval()(_nchw(x))
    jm = JaxResNet50Network(embed_dim=EMBED)
    head = {"last_linear": {"kernel": jnp.zeros((2048, EMBED)), "bias": jnp.zeros((EMBED,))}}
    (_, (jenc, jmap), _), _ = _jax_apply(jm, False)(
        {"params": {**jp, **head}, "batch_stats": js}, jnp.asarray(x))
    _close(enc.numpy(), jenc, what="enc_out")
    _close(tmap.numpy(), jmap, what="map")
    with pytest.raises(NotImplementedError, match="irresnet50"):
        convert.convert_for_arch("irresnet50", sd)


@pytest.mark.parametrize("grid,ret_attn,size", [(7, False, 64), (4, True, 112)])
def test_cvt_diml_matches_jax(grid, ret_attn, size):
    """CvTDIML on a narrow spec (every stage 64 wide, depth 1): at 64 px the
    trunk's 4 x 4 map is pooled up to grid 7, at 112 px its 7 x 7 map down
    to grid 4 (adaptive average pool); the per-patch map, the global
    encoding, the normed map and the stacked rollout maps (on a 4 x 4
    grid, as tests/test_torch_slice.py runs them at 112 px) within 1e-4."""
    tm = _seeded(lambda: CvTDIML(embed_dim=EMBED, grid_size=grid, rollout_grid=4,
                                 spec=CvTSpec(**SMALL)), 1).eval()
    jm = JaxCvTDIML(embed_dim=EMBED, grid_size=grid, rollout_grid=4, spec=JaxSpec(**SMALL))
    x = _images(5, size=size)
    (jout, (jglob, jmap), jaux), _ = _jax_apply(jm, False, ret_attn)(
        _tree(export_params(tm)), jnp.asarray(x))
    with torch.no_grad():
        out, (glob, fmap), aux = tm(_nchw(x), ret_attn=ret_attn)
    assert out.shape == (B, grid, grid, EMBED) and glob.shape == (B, EMBED)
    for what, got, want in (("per_feat", out, jout), ("global_enc", glob, jglob),
                            ("no_avg_feat", fmap, jmap)):
        _close(got.numpy(), want, what=what)
    assert set(aux) == set(jaux) == ({"rollout_maps"} if ret_attn else set())
    if ret_attn:
        _close(aux["rollout_maps"].numpy(), jaux["rollout_maps"], what="rollout_maps")


@pytest.mark.parametrize("arch,cls", [
    ("resnet50_frozen_normalize", ResNet50Network),
    ("resnet50_diml_frozen_normalize", ResNet50DIML),
    ("cvt_diml_normalize_frozen", CvTDIML), ("cvt_13_diml_noln", CvTDIML)])
def test_select_and_frozen_mask_match_jax(arch, cls):
    """``select`` builds the JAX package's class for the arch, and
    ``frozen_param_mask`` freezes what the JAX mask freezes (nothing of a
    ResNet: its `_frozen` lives in the BatchNorms; stages 0 and 1 of a
    `_frozen` CvT-DIML; the LayerNorms under `_noln`)."""
    model = _meta(lambda: archs.select(arch, Config(embed_dim=EMBED, grid_size=4)))
    assert type(model) is cls
    # the JAX mask reads only the tree's paths
    params = {flax_name(n, p.ndim): np.zeros(()) for n, p in model.named_parameters()}
    ref = jax_frozen_param_mask(arch, _tree(params)["params"])
    ref = {"params/" + "/".join(p.key for p in path): bool(v)
           for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    ours = {flax_name(n, p.ndim): ok
            for (n, ok), p in zip(archs.frozen_param_mask(arch, model).items(),
                                  model.parameters())}
    assert ours == ref
    if cls is not CvTDIML:
        assert all(ours.values())
