"""The port's Swin-T (vit_reranking_tpu_torch/models/swin.py) and its
margin-loss training against the JAX package's, on the CPU.

  * the relative position index and the shifted-window mask, bitwise; the
    window partition and its inverse, exactly;
  * a small SwinNetwork (embed 32, dim 24, depths (2, 2), heads (3, 6),
    drop-path 0, 56 px, so stage 0 has 4 windows an image and the window
    dispatcher takes it) on carried weights, with the window kernels off
    and on in both packages: embedding, pooled and token-map features and
    head tokens within 1e-5 (f32 products, LayerNorms and softmax in another
    sum order);
  * the slice as a whole: full Swin-T at 224 px on 2 images, random
    Flax-tree weights carried across, within 1e-5;
  * three Adam steps of the small Swin with fixed triplets, the frozen mask,
    the export round trip, and the train_baseline CLI with --arch
    swin_normalize.
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
from vit_reranking_tpu.models import frozen_param_mask as jax_frozen_param_mask

import vit_reranking_tpu_torch.models.swin as swin
import vit_reranking_tpu_torch.ops.swin_attention as swa
from vit_reranking_tpu_torch.cli import train_baseline
from vit_reranking_tpu_torch.cli.common import build_labels
from vit_reranking_tpu_torch.core.config import Config
from vit_reranking_tpu_torch.engine.train import init_train_state, make_optimizer, train_step
from vit_reranking_tpu_torch.losses.margin import MarginLoss
from vit_reranking_tpu_torch.miners.common import Triplets
from vit_reranking_tpu_torch.models import frozen_param_mask, select
from vit_reranking_tpu_torch.weights import export_params, flax_name, load_jax_params

torch.set_num_threads(2)

SMALL = dict(embed_dim=32, dim=24, depths=(2, 2), num_heads=(3, 6), drop_path_rate=0.0)
SIZE, B = 56, 8
LABELS = np.repeat(np.arange(4), 2).astype(np.int32)
# fixed triplets: each anchor's class partner, a negative two places on
TRIPLETS = (np.arange(B), np.arange(B) ^ 1, (np.arange(B) + 2) % B)
TOL = 1e-5


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(_flat(v, name) if hasattr(v, "items") else {name: np.asarray(v)})
    return out


def _random_tree(shapes, rng):
    """Flax-layout weights drawn with numpy: kernels N(0, 1/fan_in), biases
    and bias tables 0.02 N, LayerNorm scales 1 + 0.1 N."""
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


def test_relative_position_index_and_shift_mask_match_jax():
    for w in (2, 4, 7):
        ours = swin._relative_position_index(w)
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, jax_swin._relative_position_index(w))
    for H, W, w, s in ((56, 56, 7, 3), (28, 28, 7, 3), (14, 14, 7, 3), (8, 12, 4, 2)):
        ours = swin._shift_attn_mask(H, W, w, s)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, jax_swin._shift_attn_mask(H, W, w, s))


def test_window_partition_and_reverse_are_exact():
    x = np.random.default_rng(0).standard_normal((2, 14, 21, 5)).astype(np.float32)
    ours = swin.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_swin.window_partition(x, 7)))
    back = swin.window_reverse(ours, 7, 14, 21)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_swin.window_reverse(jnp.asarray(ours.numpy()), 7, 14, 21)))


@pytest.fixture(scope="module")
def small():
    jm = jax_swin.SwinNetwork(**SMALL)
    x0 = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, x0, train=False), jax.random.PRNGKey(0))
    variables = _random_tree(shapes, np.random.default_rng(1))
    return jm, variables


def _small_port(variables):
    return load_jax_params(swin.SwinNetwork(**SMALL, img_size=SIZE), variables)


def _outputs(out):
    embed, (enc_out, token_map), aux = out
    return [np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t)
            for t in (embed, enc_out, token_map, aux["head_tokens"])]


def _jax_kernel_on(mp):
    """The JAX model with its window kernel forced on, as
    tests/test_swin_attention_pallas.py::test_model_kernel_parity runs it."""
    mp.setattr(jax_swin, "USE_SWIN_WINDOW_KERNEL", True)
    mp.setattr(jax, "default_backend", lambda: "tpu")
    orig = jax_swa.swin_attention
    mp.setattr(jax_swa, "swin_attention", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("route", ["materialising", "packed", "batched"])
def test_small_forward_matches_jax(small, route):
    jm, variables = small
    x = np.random.default_rng(2).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    calls = []
    try:
        if route != "materialising":
            _jax_kernel_on(mp)
            mp.setattr(jax_swa, "SWIN_KERNEL_PACKED", route == "packed")
            mp.setattr(swin, "USE_SWIN_WINDOW_KERNEL", True)
            mp.setattr(swa, "SWIN_KERNEL_PACKED", route == "packed")
            real = swin.swin_attention_qkv
            mp.setattr(swin, "swin_attention_qkv",
                       lambda *a, **kw: calls.append(real(*a, **kw)) or calls[-1])
        ref = _outputs(jm.apply(variables, jnp.asarray(x), train=False))
        tm = _small_port(variables).eval()
        with torch.no_grad():
            ours = _outputs(tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()))
    finally:
        mp.undo()
    for a, b, name in zip(ours, ref, ("embed", "enc_out", "token_map", "head_tokens")):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=TOL, err_msg=name)
    if route != "materialising":
        # stage 0 (4 windows) takes the kernel path in both blocks; stage 1 is
        # one 7x7 window an image, below SWIN_KERNEL_MIN_WINDOWS
        assert [c is not None for c in calls] == [True, True, False, False]


def test_full_swin_t_forward_matches_jax():
    """The slice as a whole: full Swin-T (embed 128) at 224 px, 2 images."""
    jm = jax_swin.SwinNetwork(embed_dim=128)
    x = np.random.default_rng(3).standard_normal((2, 224, 224, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x), train=False),
                            jax.random.PRNGKey(0))
    variables = _random_tree(shapes, np.random.default_rng(4))
    ref = _outputs(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    tm = load_jax_params(swin.SwinNetwork(embed_dim=128), variables).eval()
    with torch.no_grad():
        ours = _outputs(tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()))
    assert ours[2].shape == (2, 49, 768) and ours[3].shape == (2, 49, 128)
    for a, b, name in zip(ours, ref, ("embed", "enc_out", "token_map", "head_tokens")):
        np.testing.assert_allclose(a, b, atol=TOL, err_msg=name)


@pytest.mark.parametrize("arch", ["swin_normalize", "swin_frozen_normalize"])
def test_frozen_param_mask_matches_jax(small, arch):
    _, variables = small
    tm = _small_port(variables)
    ref = _flat(jax_frozen_param_mask(arch, variables["params"]), "params")
    ours = {flax_name(n, p.ndim): ok
            for (n, ok), p in zip(frozen_param_mask(arch, tm).items(), tm.parameters())}
    assert set(ours) == set(ref)
    assert {k for k, v in ours.items() if not v} == {k for k, v in ref.items() if not bool(v)}


def test_select_builds_swin_t():
    opt = types.SimpleNamespace(embed_dim=64)
    m = select("swin_normalize", opt, generator=torch.Generator().manual_seed(0))
    assert isinstance(m, swin.SwinNetwork) and m.normalize
    assert m.head.out_features == 64 and m.layer2_block5.attn.num_heads == 12


@pytest.mark.parametrize("size", [224, 448])
def test_select_swin_t_bias_tables_match_jax(size):
    """The registry builds full Swin-T with no input size: at every size it
    runs at, no stage falls below the window, so the tables are JAX's."""
    m = select("swin_normalize", types.SimpleNamespace(embed_dim=16))
    x0 = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: jax_swin.SwinNetwork(embed_dim=16).init(k, x0, train=False),
                            jax.random.PRNGKey(0))
    ref = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
           if path[-1].key == "relative_position_bias_table"}
    ours = {flax_name(n, p.ndim): tuple(p.shape) for n, p in m.named_parameters()
            if n.endswith("relative_position_bias_table")}
    assert ours == ref and len(ours) == 12


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


@pytest.fixture(scope="module")
def three_steps(small):
    """Three Adam steps in both packages from the same weights, batch and
    triplets.  The JAX package runs its materialising attention and the port
    its window-attention dispatcher (the packed contract's plain version,
    with the bias gradient through the additive term): the same function by
    two routes."""
    jm, variables = small
    images = np.random.default_rng(6).standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    jl = JaxMarginLoss(_margin_opt(), _JaxFixedMiner())
    loss_params = _host(jl.init_params(jax.random.PRNGKey(1)))
    lrs = {"model": 1e-3, "criterion": 5e-4}
    labels = jax_build_labels(types.SimpleNamespace(arch="swin_normalize", fc_lr=-1.0),
                              variables["params"], loss_params)
    tx = jax_train.make_optimizer("adam", 1e-3, 4e-4, [1000], 0.3, 3, lrs, labels)
    state = jax_train.TrainState(
        params=variables["params"], batch_stats={}, loss_params=loss_params,
        opt_state=tx.init({"model": variables["params"], "criterion": loss_params}),
        step=jnp.zeros((), jnp.int32),
    )
    step_fn = jax_train.make_train_step(jm.apply, jl, tx, donate=False)
    jax_metrics = []
    for _ in range(3):
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(LABELS), jax.random.PRNGKey(2))
        jax_metrics.append({k: float(v) for k, v in m.items()})

    mp = pytest.MonkeyPatch()
    mp.setattr(swin, "USE_SWIN_WINDOW_KERNEL", True)
    calls = []
    real = swin.swin_attention_qkv
    mp.setattr(swin, "swin_attention_qkv",
               lambda *a, **kw: calls.append(real(*a, **kw)) or calls[-1])
    try:
        tm = _small_port(variables)
        tl = load_jax_params(MarginLoss(_margin_opt(), _FixedMiner()), {"params": loss_params})
        groups = build_labels(Config(arch="swin_normalize"), tm, tl)
        optim = make_optimizer("adam", 4e-4, groups, dict(lrs, fc=-1.0, frozen=0.0))
        tstate = init_train_state(tm, tl, optim, [1000], 0.3, 3)
        x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
        y = torch.from_numpy(LABELS).long()
        torch_metrics = [{k: float(v) for k, v in train_step(tstate, x, y).items()}
                         for _ in range(3)]
    finally:
        mp.undo()
    return dict(jax=jax_metrics, torch=torch_metrics, params=_host(state.params),
                beta=np.asarray(state.loss_params["beta"]), init=variables["params"],
                tm=tm, tl=tl, calls=calls)


def test_three_steps_take_the_window_attention_path(three_steps):
    # stage 0's two blocks in each of the three forwards
    assert sum(c is not None for c in three_steps["calls"]) == 6


@pytest.mark.parametrize("step", [0, 1, 2])
def test_three_steps_loss_and_grad_norms_match_jax(three_steps, step):
    """Loss, gradient L2 norm and largest gradient at each step: rtol 1e-4
    (f32 products and norms in another sum order, through two Adam updates
    at lr 1e-3)."""
    j, t = three_steps["jax"][step], three_steps["torch"][step]
    for k in ("loss", "grad_l2", "grad_max"):
        assert t[k] == pytest.approx(j[k], rel=1e-4), (k, t[k], j[k])


def test_three_steps_params_match_jax(three_steps):
    """Every parameter after three Adam steps at lr 1e-3, the bias tables
    among them, and the margin loss's beta.  As in tests/test_torch_train.py:
    every element within 1e-4 and 99.9% within 2e-6 (Adam moves an element
    about lr a step whatever its gradient's size, so where a gradient is
    near zero the f32 sum order sets its step).  The key third of each qkv
    bias has an exact gradient of 0 (a shift shared by a row's scores), so
    it is held to the bound of three steps, 3e-3, in both packages."""
    ours = export_params(three_steps["tm"])
    ref = _flat(three_steps["params"], "params")
    init = _flat(three_steps["init"], "params")
    assert set(ours) == set(ref)
    assert sum("relative_position_bias_table" in k for k in ref) == 4
    n_all = n_off = 0
    for name, want in ref.items():
        got = ours[name]
        if name.endswith("attn/qkv/bias"):
            third = want.size // 3
            for a in (got, want):
                assert np.abs(a - init[name])[third:2 * third].max() <= 3e-3 * (1 + 1e-6), name
            keep = np.r_[0:third, 2 * third:want.size]
            got, want = got[keep], want[keep]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=name)
        n_all += want.size
        n_off += int(np.sum(np.abs(got - want) > 2e-6))
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
    np.testing.assert_allclose(three_steps["tl"].beta.detach().numpy(), three_steps["beta"],
                               atol=1e-6)


def test_export_params_inverts_load(three_steps):
    tm = three_steps["tm"]
    tree = {}
    for name, arr in export_params(tm).items():
        node = tree
        *mods, leaf = name.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    fresh = load_jax_params(swin.SwinNetwork(**SMALL, img_size=SIZE), tree)
    assert fresh.layer0_block0.attn.relative_position_bias_table.shape == (169, 3)
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_train_baseline_swin_on_cpu(tmp_path):
    """The port's CLI with --arch swin_normalize: full Swin-T at 224 px,
    batch 4, one epoch of two steps and the in-train evaluation."""
    out = train_baseline.main([
        "--dataset", "synthetic", "--arch", "swin_normalize", "--loss", "margin",
        "--batch_mining", "distance", "--synthetic_size", "224", "--synthetic_classes", "2",
        "--synthetic_per_class", "4", "--bs", "4", "--samples_per_class", "2",
        "--n_epochs", "1", "--evalevery", "1", "--embed_dim", "16", "--device", "cpu",
        "--kernels", "2", "--save_path", str(tmp_path / "runs"),
    ])
    assert len(out["step_loss"]) == 2 and all(np.isfinite(out["step_loss"]))
    assert len(out["step_seconds"]) == 2 and all(s > 0 for s in out["step_seconds"])
    assert len(out["eval"]) == 1 and 0.0 <= out["best_r1"] <= 100.0
    assert (tmp_path / "runs" / "synthetic" / "default_s1" / "latest" / "state.pt").exists()

