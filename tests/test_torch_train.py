"""The port's margin-loss training path against the JAX package's, on the
CPU at a small size: BatchNorm's training-mode statistics, the distance
miner, the margin loss, the schedule, the class sampler, the in-train
metrics, three full Adam steps on the same weights, batch and triplets, and
the train_baseline CLI.

The model is CvT with every stage 64 wide and one head (head dim 64, so the
kv-resident attention gate can take stages 0 and 1), depth (1, 1, 1), no
drop-path, on 64 px images.  Tolerances are stated where they are used.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

import vit_reranking_tpu.data.samplers as jax_samplers
import vit_reranking_tpu.engine.metrics as jax_metrics
import vit_reranking_tpu.engine.train as jax_train
import vit_reranking_tpu.miners.common as jax_mc
import vit_reranking_tpu.ops.attention_pallas as jax_ap
from vit_reranking_tpu.cli.common import build_labels as jax_build_labels
from vit_reranking_tpu.losses.margin import MarginLoss as JaxMarginLoss
from vit_reranking_tpu.miners.distance import BatchMiner as JaxDistanceMiner
from vit_reranking_tpu.models import frozen_param_mask as jax_frozen_param_mask
from vit_reranking_tpu.models.cvt import ConvProj as JaxConvProj
from vit_reranking_tpu.models.cvt import CvTNetwork as JaxCvT, CvTSpec as JaxSpec

import vit_reranking_tpu_torch.ops.attention as ap
from vit_reranking_tpu_torch.cli import test_diml, train_baseline
from vit_reranking_tpu_torch.cli.common import build_labels
from vit_reranking_tpu_torch.core.config import Config
from vit_reranking_tpu_torch.data.samplers import ClassRandomSampler
from vit_reranking_tpu_torch.engine.metrics import metrics_from_scores
from vit_reranking_tpu_torch.engine.train import (
    init_train_state, make_optimizer, multistep_schedule, train_step,
)
from vit_reranking_tpu_torch.losses.margin import MarginLoss
from vit_reranking_tpu_torch.miners.common import (
    Triplets, inverse_sphere_log_q, masked_categorical, pdist,
)
from vit_reranking_tpu_torch.miners.distance import BatchMiner
from vit_reranking_tpu_torch.models import frozen_param_mask
from vit_reranking_tpu_torch.models.cvt import ConvProj, CvTNetwork, CvTSpec
from vit_reranking_tpu_torch.weights import export_params, flax_name, load_jax_params

torch.set_num_threads(2)

SMALL = dict(dim_embed=(64, 64, 64), num_heads=(1, 1, 1), depth=(1, 1, 1),
             drop_path_rate=(0.0, 0.0, 0.0))
B, SIZE, EMBED = 8, 64, 16
LABELS = np.repeat(np.arange(4), 2).astype(np.int32)
# fixed triplets: each anchor's class partner, a negative two places on
TRIPLETS = (np.arange(B), np.arange(B) ^ 1, (np.arange(B) + 2) % B)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(_flat(v, name) if hasattr(v, "items") else {name: np.asarray(v)})
    return out


def _embeddings(seed, n=16, c=16):
    x = np.random.default_rng(seed).standard_normal((n, c)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_batchnorm_running_stats_match_flax():
    """One training-mode ConvProj forward updates the BatchNorm statistics
    as Flax does: biased batch variance, momentum 0.9 (rtol 1e-6: the two
    packages compute the batch variance by different f32 formulas)."""
    x = np.random.default_rng(0).standard_normal((3, 8, 8, 16)).astype(np.float32) * 2 + 0.5
    jm = JaxConvProj(16, 3, 2, 1)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    out, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = load_jax_params(ConvProj(16, 3, 2, 1), _host(variables)).train()
    y = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), atol=1e-5)
    stats = _host(new["batch_stats"]["bn"])
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), stats["mean"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), stats["var"], rtol=1e-6)


def _log_q_scale(d, dim=128):
    """Size of the terms whose difference log q is: (dim - 2) |log d| and
    (dim - 3) / 2 |log(1 - d^2 / 4)|.  One ulp of ``log`` in either package
    shows at 1e-6 of this, so log q is compared at 1e-6 relative to it."""
    d = np.asarray(d, np.float64)
    return float(np.max((dim - 2) * np.abs(np.log(d))
                        + (dim - 3) / 2 * np.abs(np.log(np.maximum(1 - d**2 / 4, 1e-45)))))


def test_pdist_and_log_q_match_jax():
    e = _embeddings(1)
    lab = np.repeat(np.arange(8), 2)
    d_ref = np.asarray(jax_mc.pdist(jnp.asarray(e)))
    d = pdist(torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(d, d_ref, atol=1e-6)
    dc = np.maximum(d_ref, 0.5)
    same = lab[:, None] == lab[None, :]
    ref = np.asarray(jax_mc.inverse_sphere_log_q(jnp.asarray(dc), jnp.asarray(same)))
    got = inverse_sphere_log_q(torch.from_numpy(dc), torch.from_numpy(same)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-6 * _log_q_scale(dc))


def test_distance_miner_masks_match_jax():
    """The miner's negative log-probabilities and positive mask, against the
    JAX miner's own arithmetic (distance.py:27-41)."""
    e = _embeddings(2)
    lab = np.array([0, 0, 0, 1, 1, 2, 2, 2, 3, 3, 4, 5, 5, 6, 6, 7])  # class 4 alone
    jm = JaxDistanceMiner()
    d = jnp.maximum(jax_mc.pdist(jnp.asarray(e)), jm.lower_cutoff)
    same = lab[:, None] == lab[None, :]
    ref_log_q = np.asarray(jax_mc.inverse_sphere_log_q(d, jnp.asarray(same), dim=jm.dim))
    pos = same & ~np.eye(16, dtype=bool)
    ref_pos = np.where(pos.any(-1, keepdims=True), pos, np.eye(16, dtype=bool))
    log_q, pos_mask = BatchMiner().masks(torch.from_numpy(e), torch.from_numpy(lab))
    assert np.array_equal(pos_mask.numpy(), ref_pos)
    assert np.array_equal(np.isinf(log_q.numpy()), np.isinf(ref_log_q))
    fin = np.isfinite(ref_log_q)
    np.testing.assert_allclose(log_q.numpy()[fin], ref_log_q[fin], rtol=0,
                               atol=1e-6 * _log_q_scale(np.asarray(d)))


def test_distance_miner_draws_follow_jax_probabilities():
    """Chi-squared test of the port's draws (seeded torch.Generator) against
    the JAX miner's sampling distribution softmax(log_q) for the negatives
    and the uniform positive distribution, per anchor."""
    e = _embeddings(3, n=8)
    lab = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    jm = JaxDistanceMiner()
    d = jnp.maximum(jax_mc.pdist(jnp.asarray(e)), jm.lower_cutoff)
    log_q = jax_mc.inverse_sphere_log_q(d, jnp.asarray(lab[:, None] == lab[None, :]))
    p_neg = np.asarray(jax.nn.softmax(log_q, axis=-1), np.float64)
    miner, gen = BatchMiner(), torch.Generator().manual_seed(0)
    te, tl = torch.from_numpy(e), torch.from_numpy(lab)
    draws = [miner(te, tl, gen) for _ in range(3000)]
    neg = torch.stack([t.negative for t in draws]).numpy()
    pos = torch.stack([t.positive for t in draws]).numpy()
    assert (pos == np.arange(8) ^ 1).all()  # each class has one other member
    pvals = []
    for a in range(8):
        support = p_neg[a] > 0
        counts = np.bincount(neg[:, a], minlength=8)
        assert counts[~support].sum() == 0
        expected = p_neg[a][support] / p_neg[a][support].sum() * counts.sum()
        pvals.append(scipy.stats.chisquare(counts[support], expected).pvalue)
    # one anchor in 8 tests at p > 1e-3 each; a wrong distribution fails by far
    assert min(pvals) > 1e-3, pvals


def test_masked_categorical_empty_row_is_uniform():
    mask = torch.zeros((4000, 5), dtype=torch.bool)
    draws = masked_categorical(torch.Generator().manual_seed(1), torch.zeros(4000, 5), mask)
    counts = np.bincount(draws.numpy(), minlength=5)
    assert scipy.stats.chisquare(counts).pvalue > 1e-3


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


def test_margin_loss_value_and_grads_match_jax():
    """Value and gradients in the batch and in beta, fixed triplets
    (atol 1e-6: the same f32 arithmetic on 8 pairs)."""
    e = _embeddings(4, n=B)
    jl = JaxMarginLoss(_margin_opt(), _JaxFixedMiner())
    params = jl.init_params(jax.random.PRNGKey(0))
    val, (g_batch, g_params) = jax.value_and_grad(
        lambda b, p: jl(p, b, jnp.asarray(LABELS), key=None), argnums=(0, 1)
    )(jnp.asarray(e), params)
    tl = MarginLoss(_margin_opt(), _FixedMiner())
    te = torch.from_numpy(e).requires_grad_()
    out = tl(te, torch.from_numpy(LABELS).long())
    out.backward()
    assert 0 < float(val) and abs(float(out.detach()) - float(val)) <= 1e-6
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(g_batch), atol=1e-6)
    np.testing.assert_allclose(tl.beta.grad.numpy(), np.asarray(g_params["beta"]), atol=1e-6)


def test_multistep_schedule_matches_jax():
    for tau, gamma, spe in (([2, 5], 0.3, 3), ([1000], 0.5, 10), ([], 0.1, 4)):
        ref = jax_train.multistep_schedule(1e-3, tau, gamma, spe)
        ours = multistep_schedule(1e-3, tau, gamma, spe)
        for count in range(0, 25):
            assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6)


def test_class_random_sampler_matches_jax_bitwise():
    opt = types.SimpleNamespace(bs=12, samples_per_class=3, seed=7)
    image_dict = {c: [(None, c * 10 + i) for i in range(5 + c)] for c in range(6)}
    image_list = [(None, c) for c in range(6) for _ in range(10)]
    ref = list(jax_samplers.ClassRandomSampler(opt, image_dict, image_list))
    ours = list(ClassRandomSampler(opt, image_dict, image_list))
    assert len(ours) == len(ref) == 5 and ours == ref


def test_metrics_from_scores_matches_jax():
    rng = np.random.default_rng(5)
    sims = rng.standard_normal((20, 20)).astype(np.float32)
    sims[3, 7] = sims[3, 8]  # a tie: the lower index ranks first in both
    lab = rng.integers(0, 4, 20).astype(np.int32)
    for mask in (True, False):
        ref = jax_metrics.metrics_from_scores(jnp.asarray(sims), jnp.asarray(lab),
                                              jnp.asarray(lab), mask_diagonal=mask)
        ours = metrics_from_scores(torch.from_numpy(sims), torch.from_numpy(lab),
                                   torch.from_numpy(lab), mask_diagonal=mask)
        for k in ("r1", "rp", "mapr"):
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6)


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxCvT(embed_dim=EMBED, spec=JaxSpec(**SMALL))
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((2, SIZE, SIZE, 3)), train=False))
    return jm, _host(init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", ["cvt_13_normalize", "cvt_13_frozen_normalize",
                                  "cvt_13_noln_normalize", "cvt_13_frozen_noln_normalize"])
def test_frozen_param_mask_matches_jax(jax_model, arch):
    params = jax_model[1]["params"]
    tm = CvTNetwork(embed_dim=EMBED, spec=CvTSpec(**SMALL))
    ref = _flat(jax_frozen_param_mask(arch, params), "params")
    ours = {flax_name(n, p.ndim): ok
            for (n, ok), p in zip(frozen_param_mask(arch, tm).items(), tm.parameters())}
    assert set(ours) == set(ref)
    assert {k for k, v in ours.items() if not v} == {k for k, v in ref.items() if not bool(v)}


@pytest.fixture(scope="module")
def three_steps(jax_model):
    """Three Adam steps in both packages from the same weights, batch and
    triplets, with the kv-resident attention gate lowered so that stages 0
    and 1 take the port's K3 path (its plain version on the CPU)."""
    images = np.random.default_rng(6).standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    jm, variables = jax_model
    jl = JaxMarginLoss(_margin_opt(), _JaxFixedMiner())
    loss_params = _host(jl.init_params(jax.random.PRNGKey(1)))
    lrs = {"model": 1e-3, "criterion": 5e-4}
    labels = jax_build_labels(types.SimpleNamespace(arch="cvt_13_normalize", fc_lr=-1.0),
                              variables["params"], loss_params)
    tx = jax_train.make_optimizer("adam", 1e-3, 4e-4, [1000], 0.3, 3, lrs, labels)
    state = jax_train.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        loss_params=loss_params,
        opt_state=tx.init({"model": variables["params"], "criterion": loss_params}),
        step=jnp.zeros((), jnp.int32),
    )
    step_fn = jax_train.make_train_step(jm.apply, jl, tx, donate=False)
    jax_metrics_ = []
    for _ in range(3):
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(LABELS), jax.random.PRNGKey(2))
        jax_metrics_.append({k: float(v) for k, v in m.items()})

    mp = pytest.MonkeyPatch()
    mp.setattr(ap, "KV_RESIDENT_MIN_SCORES", 0)
    calls = []
    real = ap.cvt_attention
    mp.setattr(ap, "cvt_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    try:
        tm = load_jax_params(CvTNetwork(embed_dim=EMBED, spec=CvTSpec(**SMALL)), variables)
        tl = load_jax_params(MarginLoss(_margin_opt(), _FixedMiner()), {"params": loss_params})
        cfg = Config(arch="cvt_13_normalize")
        groups = build_labels(cfg, tm, tl)
        optim = make_optimizer("adam", 4e-4, groups, dict(lrs, fc=-1.0, frozen=0.0))
        tstate = init_train_state(tm, tl, optim, [1000], 0.3, 3)
        x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
        y = torch.from_numpy(LABELS).long()
        torch_metrics = [{k: float(v) for k, v in train_step(tstate, x, y).items()}
                         for _ in range(3)]
    finally:
        mp.undo()
    jax_state = {"params": _host(state.params), "batch_stats": _host(state.batch_stats),
                 "loss_params": _host(state.loss_params)}
    return dict(jax=jax_metrics_, torch=torch_metrics, jax_state=jax_state, tm=tm, tl=tl,
                init=variables["params"],
                kv_calls=calls, groups=groups)


def test_three_steps_take_the_kv_attention_path(three_steps):
    # stages 0 and 1 (cls-free) of each of the three forwards; stage 2 has a cls token
    assert len(three_steps["kv_calls"]) == 6
    # no head lr and nothing frozen: two groups train, as in the JAX run
    assert [len(three_steps["groups"][k]) > 0 for k in ("model", "fc", "frozen", "criterion")] \
        == [True, False, False, True]


@pytest.mark.parametrize("step", [0, 1, 2])
def test_three_steps_loss_and_grad_norms_match_jax(three_steps, step):
    """Loss, gradient L2 norm and largest gradient at each step: rtol 1e-4
    (f32 convolutions, products and norms in another sum order, carried
    through two Adam updates at lr 1e-3)."""
    j, t = three_steps["jax"][step], three_steps["torch"][step]
    for k in ("loss", "grad_l2", "grad_max"):
        assert t[k] == pytest.approx(j[k], rel=1e-4), (k, t[k], j[k])


def _zero_gradient(name):
    """Parameters whose exact gradient is 0: each adds one vector to every
    key of a row, and softmax ignores a shift shared by a row's scores (the
    key BatchNorm's bias only where no cls token joins the keys)."""
    return name.endswith("attn/proj_k/bias") or (
        name.endswith("attn/conv_proj_k/bn/bias") and "/stage2/" not in name)


def test_three_steps_params_and_batch_stats_match_jax(three_steps):
    """Every parameter and BatchNorm statistic after three Adam steps at
    lr 1e-3, and the margin loss's beta.

    Adam moves an element by lr * m / (sqrt(v) + eps), about lr a step
    whatever its gradient's size, so where a gradient is near zero the sum
    order of f32 rounding sets its step.  Hence: every element within 1e-4
    (a thirtieth of the 3e-3 that three steps can move it), and 99.9% of all
    elements within 2e-6.  Parameters whose exact gradient is 0 (rounding
    noise only) are held to the bound of three steps, 3e-3, in both
    packages."""
    ours = export_params(three_steps["tm"])
    js = three_steps["jax_state"]
    ref = {**_flat(js["params"], "params"), **_flat(js["batch_stats"], "batch_stats")}
    init = _flat(three_steps["init"], "params")
    assert set(ours) == set(ref)
    n_all = n_off = 0
    for name, want in ref.items():
        if _zero_gradient(name):
            for got in (ours[name], want):
                assert np.abs(got - init[name]).max() <= 3 * 1e-3 * (1 + 1e-6), name
            continue
        np.testing.assert_allclose(ours[name], want, atol=1e-4, rtol=0, err_msg=name)
        n_all += want.size
        n_off += int(np.sum(np.abs(ours[name] - want) > 2e-6))
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
    np.testing.assert_allclose(three_steps["tl"].beta.detach().numpy(),
                               js["loss_params"]["beta"], atol=1e-6)


def test_export_params_inverts_load(three_steps):
    tm = three_steps["tm"]
    flat = export_params(tm)
    tree = {}
    for name, arr in flat.items():
        node = tree
        *mods, leaf = name.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    fresh = load_jax_params(CvTNetwork(embed_dim=EMBED, spec=CvTSpec(**SMALL)), tree)
    for k, v in tm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k


def test_train_baseline_main_on_cpu(monkeypatch, tmp_path):
    """The port's CLI: full CvT-13 on a tiny 32 px synthetic set, two epochs
    of two steps, evaluation each epoch, checkpoints under --save_path."""
    monkeypatch.chdir(tmp_path)
    out = train_baseline.main([
        "--dataset", "synthetic", "--arch", "cvt_13_normalize", "--loss", "margin",
        "--batch_mining", "distance", "--synthetic_size", "32", "--synthetic_classes", "2",
        "--synthetic_per_class", "4", "--bs", "4", "--samples_per_class", "2",
        "--n_epochs", "2", "--evalevery", "1", "--embed_dim", "16", "--device", "cpu",
        "--kernels", "2", "--save_path", str(tmp_path / "runs"),
    ])
    assert len(out["step_loss"]) == 4 and all(np.isfinite(out["step_loss"]))
    assert len(out["eval"]) == 2 and 0.0 <= out["best_r1"] <= 100.0
    run = tmp_path / "runs" / "synthetic" / "default_s1"
    assert out["run_dir"] == str(run)
    for f in ("latest/state.pt", "best/state.pt", "latest.metrics.json", "log_train.csv",
              "log_test.csv", "Parameter_Info.txt"):
        assert (run / f).exists(), f
    assert len((run / "log_train.csv").read_text().splitlines()) == 3


@pytest.mark.parametrize("flag", [["--bf16"], ["--narrow_sm"], ["--cache_device"],
                                  ["--resume_path", "x"]])
def test_train_baseline_refuses_unported_options(tmp_path, flag):
    with pytest.raises(NotImplementedError):
        train_baseline.main(["--device", "cpu", "--save_path", str(tmp_path)] + flag)


@pytest.mark.parametrize("flag", [["--resume_path", "x"], ["--bf16"], ["--narrow_sm"],
                                  ["--cache_device"], ["--mesh_shape", "1,1"],
                                  ["--checkpoint_every_steps", "5"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_eval_refuses_unported_options(tmp_path, monkeypatch, flag):
    """The evaluation CLI refuses, before it builds anything, every option
    whose effect the port lacks: with --resume_path it would otherwise score
    the random model from --seed and write that as the run's result."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=flag[0].lstrip("-")):
        test_diml.main(["--dataset", "synthetic", "--device", "cpu", "--synthetic_size", "32"]
                       + flag)
    assert not (tmp_path / "test_results").exists()
