"""The port's bf16 training recipe against the JAX package's, on the CPU.

The JAX package trains CvT-13 and Swin-T with bf16 activations and the
narrowed softmax by default on its accelerator
(vit_reranking_tpu/cli/train_baseline.py:67-92); the port does the same on
the card.  Here, at small sizes, with inputs made by numpy from a seed:

  * K3 in bf16: the port's plain version (the arithmetic of the card's bf16
    kernel) against attention_pallas.kv_resident_attention in interpret
    mode, forward and dq, dk, dv, within 1e-2 of the largest magnitude;
  * K4 in bf16: the packed and batched contracts' plain versions and the
    model's qkv entry against swin_attention_pallas in interpret mode,
    masked and unmasked, the same bar (dadd / dbias f32), and the batched
    plain version on bias and mask (what the card runs for the packed qkv
    entry) against the JAX packed kernel, dbias against its bias gradient;
  * CvT and Swin forwards in bf16, with and without the narrowed softmax,
    on carried weights: embedding cosine > 0.995 to the JAX package's
    (the bar of tests/test_models.py), f32 outputs, and the port's bf16
    embedding closer to JAX's bf16 one than JAX's bf16 is to its f32;
  * three bf16 Adam steps of CvT and one of Swin against the JAX package's;
  * the train_baseline CLI with --bf16 on the CPU, and the precision
    defaults (core/config.py::resolve_precision).
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vit_reranking_tpu.engine.train as jax_train
import vit_reranking_tpu.miners.common as jax_mc
import vit_reranking_tpu.models.swin as jax_swin
import vit_reranking_tpu.ops.swin_attention_pallas as jax_swa
from vit_reranking_tpu.cli.common import build_labels as jax_build_labels
from vit_reranking_tpu.losses.margin import MarginLoss as JaxMarginLoss
from vit_reranking_tpu.models.cvt import CvTNetwork as JaxCvT, CvTSpec as JaxSpec
from vit_reranking_tpu.ops.attention_pallas import kv_resident_attention as jax_kv_attention

import vit_reranking_tpu_torch.models.swin as swin
import vit_reranking_tpu_torch.ops.attention as ap
import vit_reranking_tpu_torch.ops.swin_attention as swa
from vit_reranking_tpu_torch import models
from vit_reranking_tpu_torch.cli import train_baseline
from vit_reranking_tpu_torch.cli.common import build_labels
from vit_reranking_tpu_torch.core.config import Config, resolve_precision
from vit_reranking_tpu_torch.engine.train import init_train_state, make_optimizer, train_step
from vit_reranking_tpu_torch.losses.margin import MarginLoss
from vit_reranking_tpu_torch.miners.common import Triplets
from vit_reranking_tpu_torch.models.cvt import CvTNetwork, CvTSpec
from vit_reranking_tpu_torch.weights import load_jax_params

torch.set_num_threads(2)

BF16_TOL = 1e-2  # kernels: of the largest magnitude of each output
COSINE = 0.995  # model forwards (tests/test_models.py:228-249)
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-2, 5e-2
LR = 1e-5  # the recipe's (Config.lr, reference parameters.py)

CVT_SMALL = dict(dim_embed=(64, 64, 64), num_heads=(1, 1, 1), depth=(1, 1, 1),
                 drop_path_rate=(0.0, 0.0, 0.0))
CVT_SIZE = 64
SWIN_SMALL = dict(embed_dim=32, dim=24, depths=(2, 2), num_heads=(3, 6), drop_path_rate=0.0)
SWIN_SIZE = 56
B, EMBED = 8, 16
LABELS = np.repeat(np.arange(4), 2).astype(np.int32)
TRIPLETS = (np.arange(B), np.arange(B) ^ 1, (np.arange(B) + 2) % B)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16(x):
    """numpy f32 -> the same bf16 values in both packages."""
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _assert_close(ours, ref, name):
    ours, ref = _f32(ours), _f32(ref)
    assert ours.shape == ref.shape, name
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= BF16_TOL, (name, err)


def test_k3_bf16_plain_matches_jax_kernel():
    """K3's plain version in bf16 (the card kernel's arithmetic) against the
    TPU kernel in interpret mode on bf16 inputs (the shapes of
    tests/test_attention_pallas.py), forward and gradients."""
    rng = np.random.default_rng(0)
    BH, T, Tkv, D = 2, 64, 32, 64
    scale = 64.0 ** -0.5
    (q, jq), (k, jk), (v, jv), (do, jdo) = (
        _bf16(rng.standard_normal(s).astype(np.float32))
        for s in ((BH, T, D), (BH, Tkv, D), (BH, Tkv, D), (BH, T, D)))
    ref, vjp = jax.vjp(lambda a, b, c: jax_kv_attention(a, b, c, scale, True), jq, jk, jv)
    ref_grads = vjp(jdo)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ap.kv_resident_attention(*leaves, scale)
    grads = torch.autograd.grad(out, leaves, do)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _assert_close(out, ref, "out")
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert a.dtype == torch.bfloat16
        _assert_close(a, b, name)


def _qkv_problem(seed, masked):
    B_, H, nW, T, D, res = 1, 2, 4, 49, 32, 14
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B_ * nW, T, 3 * H * D)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((H, T, T))).astype(np.float32)
    do = rng.standard_normal((B_ * nW, T, H * D)).astype(np.float32)
    mask = swin._shift_attn_mask(res, res, 7, 3) if masked else None
    return qkv, bias, mask, do, H, nW, D ** -0.5


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("contract", ["packed", "batched"])
def test_k4_bf16_plain_matches_jax_kernel(monkeypatch, contract, masked):
    """The model's qkv entry (its plain version: the contract's plain bf16
    version behind the model's layout) against the JAX package's
    swin_attention in interpret mode, on one bf16 projection; dq, dk, dv as
    one dqkv, and the bias gradient in f32."""
    qkv, bias, mask, do, H, nW, scale = _qkv_problem(1, masked)
    monkeypatch.setattr(swa, "SWIN_KERNEL_PACKED", contract == "packed")
    monkeypatch.setattr(jax_swa, "SWIN_KERNEL_PACKED", contract == "packed")
    Bw, T, C3 = qkv.shape
    D = C3 // (3 * H)
    (tq, jqkv), (tdo, jdo) = _bf16(qkv), _bf16(do)
    jmask = None if mask is None else jnp.asarray(mask)

    def jax_fn(x, b):
        x = x.reshape(Bw, T, 3, H, D).transpose(2, 0, 3, 1, 4)
        o = jax_swa.swin_attention(x[0], x[1], x[2], b, jmask, scale, n_windows=nW,
                                   interpret=True)
        return o.transpose(0, 2, 1, 3).reshape(Bw, T, H * D)

    ref, vjp = jax.vjp(jax_fn, jqkv, jnp.asarray(bias))
    ref_dqkv, ref_dbias = vjp(jdo)
    leaf, tb = tq.clone().requires_grad_(), torch.from_numpy(bias).requires_grad_()
    out = swa.swin_attention_qkv(leaf, tb, None if mask is None else torch.from_numpy(mask),
                                 scale, H, n_windows=nW)
    dqkv, dbias = torch.autograd.grad(out, (leaf, tb), tdo)
    assert out.dtype == dqkv.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    _assert_close(out, ref, "out")
    _assert_close(dqkv, ref_dqkv, "dqkv")
    _assert_close(dbias, ref_dbias, "dbias")


def test_k4a_bf16_packed_contract_matches_jax():
    """The packed contract's own plain version (the (P T, P T) function with
    its additive term) against the JAX packed kernel in interpret mode, with
    the additive term's gradient."""
    rng = np.random.default_rng(2)
    G, nW, T, D, H = 4, 4, 49, 32, 2
    Bimg = G // H
    (q, jq), (k, jk), (v, jv), (do, jdo) = (
        _bf16(rng.standard_normal((G, nW, T, D)).astype(np.float32)) for _ in range(4))
    bias = (0.5 * rng.standard_normal((H, T, T))).astype(np.float32)
    mask = swin._shift_attn_mask(14, 14, 7, 3)
    P = swa._pick_pack_packed(nW, T)
    nblk = nW // P
    shape = (G, nblk, P * T, D)
    add = swa._packed_add_term(torch.from_numpy(bias), torch.from_numpy(mask), P, nblk)
    jadd = jax_swa._packed_add_term(jnp.asarray(bias), jnp.asarray(mask), P, nblk)
    ref, vjp = jax.vjp(lambda a, b, c, d: jax_swa._packed_attention(a, b, c, d, D ** -0.5, Bimg,
                                                                    True),
                       jq.reshape(shape), jk.reshape(shape), jv.reshape(shape), jadd)
    ref_grads = vjp(jdo.reshape(shape))
    leaves = [t.reshape(shape).clone().requires_grad_() for t in (q, k, v)]
    leaves.append(add.clone().requires_grad_())
    out = swa._packed_attention(*leaves, D ** -0.5, Bimg, T)
    grads = torch.autograd.grad(out, leaves, do.reshape(shape))
    _assert_close(out, ref, "out")
    for name, a, b in zip(("dq", "dk", "dv", "dadd"), grads, ref_grads):
        _assert_close(a, b, name)
    assert grads[3].dtype == torch.float32


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_k4_bf16_batched_plain_matches_jax_packed_kernel(shifted):
    """What the card runs for the packed qkv entry in bf16: the batched
    plain version on bias and mask (no packed additive term) against the
    JAX packed kernel in interpret mode on the same bf16 windows (Swin-T
    stage 2, shifted or not): the output, dq, dk, dv, and dbias against the
    bias gradient of the JAX packed path, within 1e-2 of the largest
    magnitude."""
    rng = np.random.default_rng(3)
    G, nW, T, D, H = 4, 4, 49, 32, 2
    (q, jq), (k, jk), (v, jv), (do, jdo) = (
        _bf16(rng.standard_normal((G, nW, T, D)).astype(np.float32)) for _ in range(4))
    bias = (0.5 * rng.standard_normal((H, T, T))).astype(np.float32)
    mask = swin._shift_attn_mask(14, 14, 7, 3) if shifted else None
    jmask = None if mask is None else jnp.asarray(mask)
    ref, vjp = jax.vjp(lambda a, b, c, d: jax_swa.swin_window_attention_packed(
        a, b, c, d, jmask, D ** -0.5, True), jq, jk, jv, jnp.asarray(bias))
    ref_grads = vjp(jdo)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    leaves.append(torch.from_numpy(bias).requires_grad_())
    out = swa.swin_window_attention_plain(*leaves, None if mask is None
                                          else torch.from_numpy(mask), D ** -0.5)
    grads = torch.autograd.grad(out, leaves, do)
    assert out.dtype == torch.bfloat16 and grads[3].dtype == torch.float32
    _assert_close(out, ref, "out")
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, ref_grads):
        _assert_close(a, b, name)


# ---- model forwards -----------------------------------------------------------

def _cosine(a, b):
    a, b = _f32(a).reshape(len(a), -1), _f32(b).reshape(len(b), -1)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _swin_tree(shapes, rng):
    """Flax-layout weights drawn with numpy (as tests/test_torch_swin.py)."""
    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            std = float(np.prod(s.shape[:-1])) ** -0.5
        elif leaf == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        else:
            std = 0.02
        return (std * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def cvt_vars():
    jm = JaxCvT(embed_dim=EMBED, spec=JaxSpec(**CVT_SMALL))
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((2, CVT_SIZE, CVT_SIZE, 3)), train=False))
    return _host(init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def swin_vars():
    x0 = jnp.zeros((2, SWIN_SIZE, SWIN_SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: jax_swin.SwinNetwork(**SWIN_SMALL).init(k, x0, train=False),
                            jax.random.PRNGKey(0))
    return _swin_tree(shapes, np.random.default_rng(1))


def _jax_model(arch, dtype, narrow):
    if arch == "cvt":
        return JaxCvT(embed_dim=EMBED, spec=JaxSpec(**CVT_SMALL), dtype=dtype, narrow_sm=narrow)
    return jax_swin.SwinNetwork(**SWIN_SMALL, dtype=dtype, narrow_sm=narrow)


def _port_model(arch, variables, dtype, narrow):
    if arch == "cvt":
        m = CvTNetwork(embed_dim=EMBED, spec=CvTSpec(**CVT_SMALL), dtype=dtype, narrow_sm=narrow)
    else:
        m = swin.SwinNetwork(**SWIN_SMALL, img_size=SWIN_SIZE, dtype=dtype, narrow_sm=narrow)
    return load_jax_params(m, variables)


@pytest.mark.parametrize("narrow", [False, True], ids=["f32-softmax", "narrow_sm"])
@pytest.mark.parametrize("arch", ["cvt", "swin"])
def test_bf16_forward_matches_jax(cvt_vars, swin_vars, arch, narrow):
    """Evaluation-mode forwards of the same weights and images: the port's
    bf16 embedding against the JAX package's (cosine > 0.995 per image),
    f32 embeddings and token maps in both, and the port's bf16 embedding
    closer to JAX's bf16 one than JAX's bf16 is to JAX's f32: the casts sit
    where the JAX package's do."""
    variables = cvt_vars if arch == "cvt" else swin_vars
    size = CVT_SIZE if arch == "cvt" else SWIN_SIZE
    x = np.random.default_rng(3).standard_normal((4, size, size, 3)).astype(np.float32)
    ref32, ref16 = (jax.jit(lambda v, x, m=m: m.apply(v, x, train=False))(variables, x)
                    for m in (_jax_model(arch, jnp.float32, False),
                              _jax_model(arch, jnp.bfloat16, narrow)))
    with torch.no_grad():
        ours = _port_model(arch, variables, torch.bfloat16, narrow).eval()(
            torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    embed, token_map = ours[0], ours[1][1]
    assert embed.dtype == token_map.dtype == torch.float32
    assert ref16[0].dtype == ref16[1][1].dtype == jnp.float32
    assert np.all(_cosine(embed, ref16[0]) > COSINE), _cosine(embed, ref16[0])
    gap_ours = np.linalg.norm(_f32(embed) - _f32(ref16[0]))
    gap_jax = np.linalg.norm(_f32(ref16[0]) - _f32(ref32[0]))
    assert gap_ours < gap_jax, (gap_ours, gap_jax)


# ---- train steps ---------------------------------------------------------------

class _JaxFixedMiner:
    name = "distance"

    def __call__(self, key, batch, labels):
        a, p, n = (jnp.asarray(t, jnp.int32) for t in TRIPLETS)
        return jax_mc.Triplets(a, p, n, jnp.ones((B,), bool))


class _FixedMiner:
    name = "distance"

    def __call__(self, batch, labels, generator=None):
        a, p, n = (torch.from_numpy(t) for t in TRIPLETS)
        return Triplets(a, p, n, torch.ones(B, dtype=torch.bool))


def _margin_opt():
    return types.SimpleNamespace(n_classes=4, loss_margin_beta=1.05)


def _steps(arch, variables, size, n, narrow, patches, lr=LR, jax_dtype=jnp.bfloat16):
    """``n`` Adam steps in both packages (bf16, the same weights, batch and
    triplets, learning rate ``lr``), with ``patches`` (module, name, value)
    applied to the port's run; returns both packages' metrics and the
    port's model."""
    images = np.random.default_rng(6).standard_normal((B, size, size, 3)).astype(np.float32)
    jm = _jax_model(arch, jax_dtype, narrow)
    jl = JaxMarginLoss(_margin_opt(), _JaxFixedMiner())
    loss_params = _host(jl.init_params(jax.random.PRNGKey(1)))
    lrs = {"model": lr, "criterion": 5e-4}
    arch_name = "cvt_13_normalize" if arch == "cvt" else "swin_normalize"
    labels = jax_build_labels(types.SimpleNamespace(arch=arch_name, fc_lr=-1.0),
                              variables["params"], loss_params)
    tx = jax_train.make_optimizer("adam", lr, 4e-4, [1000], 0.3, 3, lrs, labels)
    state = jax_train.TrainState(
        params=variables["params"], batch_stats=variables.get("batch_stats", {}),
        loss_params=loss_params,
        opt_state=tx.init({"model": variables["params"], "criterion": loss_params}),
        step=jnp.zeros((), jnp.int32),
    )
    step_fn = jax_train.make_train_step(jm.apply, jl, tx, donate=False)
    jax_metrics = []
    for _ in range(n):
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(LABELS), jax.random.PRNGKey(2))
        jax_metrics.append({k: float(v) for k, v in m.items()})

    mp = pytest.MonkeyPatch()
    for mod, name, val in patches:
        mp.setattr(mod, name, val)
    try:
        tm = _port_model(arch, variables, torch.bfloat16, narrow)
        tl = load_jax_params(MarginLoss(_margin_opt(), _FixedMiner()), {"params": loss_params})
        groups = build_labels(Config(arch=arch_name), tm, tl)
        optim = make_optimizer("adam", 4e-4, groups, dict(lrs, fc=-1.0, frozen=0.0))
        tstate = init_train_state(tm, tl, optim, [1000], 0.3, 3)
        x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
        y = torch.from_numpy(LABELS).long()
        ours = [{k: float(v) for k, v in train_step(tstate, x, y).items()} for _ in range(n)]
    finally:
        mp.undo()
    return jax_metrics, ours, tm


def _check_steps(jax_metrics, ours, tm):
    for step, (j, t) in enumerate(zip(jax_metrics, ours)):
        assert t["loss"] == pytest.approx(j["loss"], rel=STEP_LOSS_RTOL), (step, t, j)
        for k in ("grad_l2", "grad_max"):
            assert t[k] == pytest.approx(j[k], rel=STEP_GRAD_RTOL), (step, k, t, j)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for n, b in tm.named_buffers() if "running" in n)


def test_cvt_three_bf16_steps_match_jax(cvt_vars):
    """Three Adam steps of the bf16 CvT (--bf16 --no-narrow_sm) with the
    kv-resident gate lowered, so stages 0 and 1 take K3's bf16 plain route;
    the JAX package's materialising path computes f32 scores and rounds p
    to bf16 before p @ v, K3's arithmetic, but differentiates by autograd
    (dp rounded to bf16).  Loss within rtol 1e-2, gradient L2 norm and
    largest gradient within 5e-2 at each step; parameters and BatchNorm
    statistics stay f32.  Measured on the CPU: loss within 1.1e-3 relative,
    grad_l2 within 9.4e-4 and grad_max within 4.4e-3 over the three steps.

    The learning rate is the recipe's, 1e-5.  At 1e-3 Adam moves every
    element by about lr whatever its gradient, so elements whose gradient
    is bf16 rounding noise take steps of either sign, and by the third step
    the loss moves by several percent in the JAX package alone (its bf16
    run against its f32 run: 2.0% at step 2 and 7.5% at step 3, measured on
    the CPU; the port against JAX bf16: 1.1% and 4.7%)."""
    calls = []
    real = ap.cvt_attention

    def counted(*a):
        out = real(*a)
        calls.append(out is not None and out.dtype == torch.bfloat16)
        return out

    jax_metrics, ours, tm = _steps("cvt", cvt_vars, CVT_SIZE, 3, False,
                                   [(ap, "KV_RESIDENT_MIN_SCORES", 0),
                                    (ap, "cvt_attention", counted)])
    assert calls == [True] * 6  # stages 0 and 1 of three forwards, in bf16
    _check_steps(jax_metrics, ours, tm)


def test_swin_bf16_step_matches_jax(swin_vars):
    """One Adam step of the bf16 Swin with the window route on (the packed
    contract's bf16 plain version) against the JAX package's materialising
    bf16 step (f32 scores, p rounded to bf16), at the CvT steps' bars.
    Measured on the CPU: loss within 2.0e-4 relative, grad_l2 within 1.9e-5
    and grad_max within 9.1e-3."""
    calls = []
    real = swin.swin_attention_qkv

    def counted(qkv, *a, **kw):
        out = real(qkv, *a, **kw)
        calls.append(out is not None and qkv.dtype == torch.bfloat16)
        return out

    jax_metrics, ours, tm = _steps("swin", swin_vars, SWIN_SIZE, 1, False,
                                   [(swin, "USE_SWIN_WINDOW_KERNEL", True),
                                    (swin, "swin_attention_qkv", counted)])
    # stage 0's two blocks take the route; stage 1 is one window an image
    assert calls == [True, True, False, False]
    _check_steps(jax_metrics, ours, tm)


# ---- the CLI and the defaults ----------------------------------------------------

def test_train_baseline_bf16_on_cpu(tmp_path, capsys):
    """train_baseline --bf16 on the CPU: full CvT-13 on a tiny 32 px
    synthetic set, one epoch of two steps and the in-train evaluation."""
    out = train_baseline.main([
        "--dataset", "synthetic", "--arch", "cvt_13_normalize", "--loss", "margin",
        "--batch_mining", "distance", "--synthetic_size", "32", "--synthetic_classes", "2",
        "--synthetic_per_class", "4", "--bs", "4", "--samples_per_class", "2",
        "--n_epochs", "1", "--evalevery", "1", "--embed_dim", "16", "--device", "cpu",
        "--kernels", "2", "--bf16", "--save_path", str(tmp_path / "runs"),
    ])
    assert "precision: bf16 activations, f32 parameters, narrowed softmax" in capsys.readouterr().out
    assert len(out["step_loss"]) == 2 and all(np.isfinite(out["step_loss"]))
    assert len(out["eval"]) == 1
    assert all(0.0 <= v <= 100.0 for v in out["eval"][0].values())


@pytest.mark.parametrize("arch", ["cvt_13_normalize", "swin_normalize", "resnet50_normalize",
                                  "vit_normalize", "cvt_13_diml_normalize"])
@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu"])
def test_precision_defaults(arch, device):
    """bf16 and narrow_sm on for the JAX package's bf16 arches on the card,
    off on the CPU and for CvT-DIML; narrow_sm follows bf16."""
    opt = resolve_precision(Config(arch=arch, device=device))
    want = device != "cpu" and "diml" not in arch
    assert (opt.bf16, opt.narrow_sm) == (want, want)


@pytest.mark.parametrize("flags,want", [
    (dict(bf16=False), (False, False)),
    (dict(narrow_sm=False), (True, False)),
    (dict(bf16=False, narrow_sm=True), (False, True)),
])
def test_precision_explicit_flags_win(flags, want):
    opt = resolve_precision(Config(arch="cvt_13_normalize", device="cuda", **flags))
    assert (opt.bf16, opt.narrow_sm) == want




def test_select_passes_the_precision():
    """select gives CvT and Swin the compute dtype and narrow_sm of opt, with
    f32 parameters and an f32 head."""
    opt = Config(embed_dim=16, bf16=True, narrow_sm=True)
    cvt = models.select("cvt_13_normalize", opt)
    attn = cvt.trunk.stage0.block0.attn
    assert attn.proj_q.compute_dtype == attn.conv_proj_q.bn.compute_dtype == torch.bfloat16
    assert attn.narrow_sm and cvt.trunk.stage2.dtype == torch.bfloat16
    sw = models.select("swin_normalize", opt)
    assert sw.layer0_block0.attn.qkv.compute_dtype == torch.bfloat16
    assert sw.layer0_block0.attn.narrow and sw.layer3_block1.mlp.fc2.compute_dtype == torch.bfloat16
    for m in (cvt, sw):
        assert type(m.head) is torch.nn.Linear
        assert all(p.dtype == torch.float32 for p in m.parameters())
