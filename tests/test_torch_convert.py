"""The port's torch-checkpoint converters and their audit
(vit_reranking_tpu_torch/core/convert.py) against the JAX package's, on the
CPU, on stand-ins of the reference's ImageNet checkpoints: state dicts with
the exact key and shape sets of tests/manifests/{cvt13,deit_small,
swin_tiny}.json, values drawn from a seed.

For each of CvT-13, DeiT-S and Swin-T (full width, as the manifests fix):
  * the JAX converter's output, carried into the port's model through
    ``weights.load_jax_params``, is the port's own conversion, bit for bit,
    entry for entry, and both convert the same set of entries;
  * the converted model's forward (f32; CvT-13 at 64 px, DeiT-S and Swin-T
    at the 224 px their position embedding and bias tables fix) matches
    the JAX model's within 1e-4;
  * both audits fail, naming the key, on a dropped key, an extra key no
    rule reads, and (Swin) a transposed relative-position bias table.
Then ``load_pretrained_into`` from a ``.pth`` file, bare and wrapped.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_reranking_tpu.core import convert as jax_convert
from vit_reranking_tpu.models.cvt import CvTNetwork as JaxCvT
from vit_reranking_tpu.models.swin import SwinNetwork as JaxSwin
from vit_reranking_tpu.models.vit import ViTNetwork as JaxViT

from vit_reranking_tpu_torch.cli.common import load_pretrained_into
from vit_reranking_tpu_torch.core import convert
from vit_reranking_tpu_torch.core.config import Config
from vit_reranking_tpu_torch.models.cvt import CvTNetwork
from vit_reranking_tpu_torch.models.swin import SwinNetwork
from vit_reranking_tpu_torch.models.vit import ViTNetwork
from vit_reranking_tpu_torch.weights import _RENAME, load_jax_params

from stand_ins import manifest_state_dict

torch.set_num_threads(2)

TOL = 1e-4
# manifest -> (arch string, JAX model, port model, input side)
FAMILIES = {
    "cvt13": ("cvt_13_normalize", lambda: JaxCvT(embed_dim=128),
              lambda: CvTNetwork(embed_dim=128), 64),
    "deit_small": ("vit_normalize", lambda: JaxViT(embed_dim=128),
                   lambda: ViTNetwork(embed_dim=128, img_size=224), 224),
    "swin_tiny": ("swin_normalize", lambda: JaxSwin(embed_dim=128),
                  lambda: SwinNetwork(embed_dim=128), 224),
}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): v})
    return out


def _port_name(path):
    """The port's state_dict name of a Flax leaf path (weights.py's map)."""
    *mods, leaf = path
    return ".".join([*mods, _RENAME.get(leaf, leaf)])


def _merge(variables, p, s):
    return {"params": jax_convert.merge_params(dict(variables["params"]), p),
            "batch_stats": jax_convert.merge_params(dict(variables.get("batch_stats", {})), s)}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, arch, checkpoint, JAX model and its converted variables, port
    model carrying them, the port's conversion, input)."""
    name = request.param
    arch, jax_model, port_model, side = FAMILIES[name]
    sd = manifest_state_dict(name)
    jm = jax_model()
    x = np.random.default_rng(7).standard_normal((2, side, side, 3)).astype(np.float32)
    # the init tree's shapes, drawn with numpy (the converter covers all but
    # the fresh head)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x[:1]), train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    variables = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(a.dtype), shapes)
    p, s = jax_convert.convert_for_arch(arch, sd)
    merged = jax.tree.map(np.asarray, _merge(variables, p, s))
    tm = load_jax_params(port_model(), merged).eval()
    jax_names = {_port_name(k) for k in [*_flat(p), *_flat(s)]}
    return dict(name=name, arch=arch, sd=sd, jm=jm, merged=merged, tm=tm,
                ours=convert.convert_for_arch(arch, sd), jax_names=jax_names, x=x)


def test_conversion_bitwise(family):
    ours, target = family["ours"], family["tm"].state_dict()
    assert set(ours) == family["jax_names"]
    for k, v in ours.items():
        assert v.dtype == target[k].dtype and torch.equal(v, target[k]), k
    # the audit against the port's model: nothing fatal, only the head uncovered
    report = convert.audit_conversion(family["arch"], family["sd"], target=target)
    assert report["problems"] == [] and report["n_consumed"] > 0.7 * report["n_keys"]
    assert report["uncovered"] and all(k.startswith("head.") for k in report["uncovered"])
    jreport = jax_convert.audit_conversion(family["arch"], family["sd"])
    assert report["unconsumed"] == jreport["unconsumed"] == []
    assert report["ignored_unconsumed"] == jreport["ignored_unconsumed"]
    assert report["n_consumed"] == jreport["n_consumed"]


def test_converted_forward_matches_jax(family):
    x = family["x"]
    jm = family["jm"]
    je, (jenc, jtok), jaux = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        family["merged"], jnp.asarray(x))
    with torch.no_grad():
        e, (enc, tok), aux = family["tm"](torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for a, b, what in ((e, je, "embed"), (enc, jenc, "enc_out"), (tok, jtok, "token_map"),
                       (aux["head_tokens"], jaux["head_tokens"], "head_tokens")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, err_msg=what)


def _corruptions(name, sd):
    """(label, corrupted checkpoint, key the audit must name)."""
    victim = {"cvt13": "stage1.blocks.0.attn.proj_q.weight",
              "deit_small": "blocks.3.mlp.fc1.weight",
              "swin_tiny": "layers.2.blocks.4.norm2.bias"}[name]
    dropped = {k: v for k, v in sd.items() if k != victim}
    extra = dict(sd, **{"stage7.mystery.weight": torch.zeros(3)})
    out = [("dropped", dropped, victim), ("extra", extra, "stage7.mystery.weight")]
    if name == "swin_tiny":
        key = "layers.1.blocks.0.attn.relative_position_bias_table"
        out.append(("transposed", dict(sd, **{key: sd[key].t().contiguous()}),
                    "relative_position_bias_table"))
    return out


def test_audits_fail_by_name_on_the_same_corruptions(family):
    name, arch = family["name"], family["arch"]
    target = family["tm"].state_dict()
    jvars = {"params": family["merged"]["params"],
             "batch_stats": family["merged"]["batch_stats"]}
    for label, sd, key in _corruptions(name, family["sd"]):
        with pytest.raises(jax_convert.ConversionAuditError, match=key) as jerr:
            jax_convert.audit_conversion(arch, sd, variables=jvars, strict=True)
        with pytest.raises(convert.ConversionAuditError, match=key) as err:
            convert.audit_conversion(arch, sd, target=target, strict=True)
        # the same kind of finding on both sides
        for kind in ("MISSING", "never consumed", "shape mismatch"):
            assert (kind in str(err.value)) == (kind in str(jerr.value)), (label, kind)
        report = convert.audit_conversion(arch, sd, target=target, strict=False) \
            if label != "dropped" else None
        if report is not None:
            assert report["problems"], label


def test_convert_for_arch_refuses_families_without_a_model():
    for arch in ("irresnet50", "densenet169_normalize", "patchnetvlad"):
        with pytest.raises(NotImplementedError, match=arch):
            convert.convert_for_arch(arch, {})


def test_zoom_pos_embed_matches_jax():
    pos = np.random.default_rng(2).standard_normal((1, 1 + 14 * 14, 8)).astype(np.float32)
    for grid in (14, 9):
        np.testing.assert_array_equal(convert.zoom_pos_embed(torch.from_numpy(pos), grid).numpy(),
                                      jax_convert.zoom_pos_embed(pos, grid))


def test_tracked_state_dict_follows_strip_prefix():
    """Reads through a stripped copy mark the original keys; iteration and
    ``in`` mark nothing."""
    sd = convert.TrackedStateDict({"module.a": 1, "module.b": 2, "c": 3})
    stripped = convert.strip_prefix(sd, "module.")
    assert sorted(stripped) == ["a", "b", "c"] and "b" in stripped
    _ = stripped["a"], stripped.get("c"), stripped.get("missing")
    assert stripped.unconsumed() == sd.unconsumed() == ["module.b"]
    assert convert.strip_prefix({"module.x": 1, "y": 2}, "module.") == {"x": 1, "y": 2}


@pytest.fixture(scope="module")
def cvt13_sd():
    return manifest_state_dict("cvt13")


@pytest.mark.parametrize("wrap", [None, "model", "state_dict"])
def test_load_pretrained_into(tmp_path, cvt13_sd, wrap):
    """A .pth of the CvT-13 stand-in (bare, or under "model" or
    "state_dict"): every converted entry lands bit for bit, the fresh head
    keeps its initial values."""
    path = tmp_path / "cvt13.pth"
    torch.save(cvt13_sd if wrap is None else {wrap: cvt13_sd}, path)
    opt = Config(arch="cvt_13_normalize", device="cpu", pretrained_ckpt=str(path))
    model = CvTNetwork(embed_dim=16)
    head = model.head.weight.detach().clone()
    load_pretrained_into(opt, model)
    state = model.state_dict()
    for k, v in convert.convert_for_arch(opt.arch, cvt13_sd).items():
        assert torch.equal(state[k], v), k
    assert torch.equal(model.head.weight, head)


def test_load_pretrained_into_audits_first(tmp_path, cvt13_sd):
    """A checkpoint that lacks a block fails the strict audit, naming it,
    before any weight lands; a path that does not exist raises."""
    path = tmp_path / "cvt13.pth"
    torch.save({k: v for k, v in cvt13_sd.items() if "stage2.blocks.9" not in k}, path)
    opt = Config(arch="cvt_13_normalize", device="cpu", pretrained_ckpt=str(path))
    model = CvTNetwork(embed_dim=16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(convert.ConversionAuditError, match="stage2.blocks.9"):
        load_pretrained_into(opt, model)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        load_pretrained_into(opt.replace(pretrained_ckpt=str(tmp_path / "missing.pth")), model)
