"""The port's MSLS training against the JAX package's, on the CPU, and both
MSLS CLIs end to end.

* ``msls_triplet_loss``: value and gradients;
* the step schedule against optax's;
* three f32 Adam steps and one SGD step of a narrow CvT (every stage 64
  wide, one head, depth (1, 1, 1), drop rates 0, 32 px) on the same
  weights and triplets, against the JAX step assembled from
  ``model.apply``, ``msls_triplet_loss`` and the optax chain of
  vit_reranking_tpu/cli/train_msls_baseline.py:174-188;
* train_msls_baseline and test_msls_baseline on ``--dataset synthetic
  --device cpu`` at 32 px (the narrow CvT in place of CvT-13, whose
  full-width steps take seconds each on the CPU): finite recalls,
  ``latest`` and ``best``; a ``--checkpoint_every_steps 1`` run stopped after its first
  subcache and resumed from ``latest`` mines the uninterrupted run's
  triplets and ends on its weights, bit for bit;
* every refusal of the MSLS CLIs, and the inputs on which both packages
  fail (a non-square token map; ``use_cls_token`` with an embedding
  narrower than the bank).

The JAX package's MSLS CLIs are not run (each takes minutes on the CPU).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import vit_reranking_tpu.data.msls as jax_msls
from vit_reranking_tpu.engine.extract import make_embed_fn as jax_make_embed_fn
from vit_reranking_tpu.engine.msls_val import msls_val as jax_msls_val
from vit_reranking_tpu.losses.msls import msls_triplet_loss as jax_triplet_loss
from vit_reranking_tpu.models.cvt import CvTNetwork as JaxCvT, CvTSpec as JaxSpec

import vit_reranking_tpu_torch.data.msls as msls
import vit_reranking_tpu_torch.models as archs
from vit_reranking_tpu_torch.cli import test_msls_baseline, train_msls_baseline
from vit_reranking_tpu_torch.core.checkpoint import load_checkpoint
from vit_reranking_tpu_torch.core.config import Config
from vit_reranking_tpu_torch.engine.msls_val import msls_val
from vit_reranking_tpu_torch.losses.msls import msls_triplet_loss
from vit_reranking_tpu_torch.models.cvt import CvTNetwork, CvTSpec
from vit_reranking_tpu_torch.weights import export_params, load_jax_params

torch.set_num_threads(2)

SMALL = dict(dim_embed=(64, 64, 64), num_heads=(1, 1, 1), depth=(1, 1, 1),
             drop_path_rate=(0.0, 0.0, 0.0))
EMBED, SIZE, B, NNEG = 16, 32, 2, 3


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(_flat(v, name) if hasattr(v, "items") else {name: np.asarray(v)})
    return out


def test_triplet_loss_and_grads_match_jax():
    rng = np.random.default_rng(0)
    q, p = (rng.standard_normal((4, 8)).astype(np.float32) for _ in "qp")
    n = rng.standard_normal((4, 3, 8)).astype(np.float32) * 0.3
    val, grads = jax.value_and_grad(jax_triplet_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, p, n)), margin=0.1)
    tq, tp, tn = (torch.from_numpy(x).requires_grad_() for x in (q, p, n))
    out = msls_triplet_loss(tq, tp, tn, margin=0.1)
    out.backward()
    assert 0 < float(val) and abs(float(out.detach()) - float(val)) <= 1e-6
    for t, g in zip((tq, tp, tn), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6)


def _jax_tx(opt):
    """The optax chain of vit_reranking_tpu/cli/train_msls_baseline.py:174-188."""
    sched = optax.exponential_decay(opt.lr, transition_steps=opt.lrstep,
                                    decay_rate=opt.lrgamma, staircase=True)
    inner = optax.trace(decay=opt.momentum) if opt.optim == "sgd" else optax.scale_by_adam()
    return optax.chain(optax.add_decayed_weights(opt.weightdecay), inner,
                       optax.scale_by_schedule(lambda c: -sched(c // 1000))), sched


def test_step_schedule_matches_optax():
    opt = Config(lr=1e-4, lrstep=2, lrgamma=0.5)
    _, sched = _jax_tx(opt)
    for count in (0, 1, 999, 1000, 1999, 2000, 3999, 4000, 6500, 12345):
        assert train_msls_baseline.lr_at(opt, count) == pytest.approx(
            float(sched(count // 1000)), rel=1e-6)


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxCvT(embed_dim=EMBED, normalize=True, spec=JaxSpec(**SMALL))
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((2, SIZE, SIZE, 3)), train=False))
    return jm, _host(init(jax.random.PRNGKey(0)))


def _triplets(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    p = (q + 0.5 * rng.standard_normal(q.shape)).astype(np.float32)
    negs = rng.standard_normal((B, NNEG, SIZE, SIZE, 3)).astype(np.float32)
    return q, p, negs


def _run_both(jax_model, opt, steps):
    """``steps`` steps of each package from the same weights, each on its
    own triplets; returns (JAX losses, port losses, JAX state, port model,
    the initial parameters)."""
    jm, variables = jax_model
    tx, _ = _jax_tx(opt)

    def loss_fn(params, batch_stats, q, p, negs):
        images = jnp.concatenate([q, p, negs.reshape(-1, *negs.shape[-3:])])
        out, new = jm.apply({"params": params, "batch_stats": batch_stats}, images, train=True,
                            mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0),
                                  "droppath": jax.random.PRNGKey(0)})
        emb = out[0]
        en = emb[2 * B:].reshape(B, -1, emb.shape[-1])
        loss = opt.tl_weight * jax_triplet_loss(emb[:B], emb[B:2 * B], en, margin=opt.margin)
        return loss, new["batch_stats"]

    @jax.jit
    def step(params, batch_stats, opt_state, q, p, negs):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch_stats, q, p, negs)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    tm = load_jax_params(CvTNetwork(embed_dim=EMBED, spec=CvTSpec(**SMALL)), variables)
    optim = train_msls_baseline.make_msls_optimizer(opt, tm)
    ref, ours = [], []
    for i in range(steps):
        q, p, negs = _triplets(10 + i)
        params, stats, opt_state, loss = step(params, stats, opt_state,
                                              *map(jnp.asarray, (q, p, negs)))
        ref.append(float(loss))
        m = train_msls_baseline.msls_train_step(opt, tm, optim, i, *map(torch.from_numpy,
                                                                        (q, p, negs)))
        ours.append(float(m["loss"]))
    return ref, ours, {"params": _host(params), "batch_stats": _host(stats)}, tm, \
        variables["params"]


def _zero_gradient(name):
    """Parameters whose exact gradient is 0 (tests/test_torch_train.py): a
    shift shared by every key of a row, which softmax ignores."""
    return name.endswith("attn/proj_k/bias") or (
        name.endswith("attn/conv_proj_k/bn/bias") and "/stage2/" not in name)


def test_three_adam_steps_match_jax(jax_model):
    """Three steps at the recipe's lr 1e-4 (scripts/baselines/msls_train.sh):
    losses within rtol 1e-4 at each step; every parameter and BatchNorm
    statistic within 3e-5, a tenth of the 3e-4 that three Adam steps can
    move an element (Adam moves an element about lr a step whatever its
    gradient, so where a gradient is near 0 the f32 sum order sets the
    sign of its step), and 99.9% of the elements within 2e-7; exact-zero
    gradients within the three steps' bound in both packages
    (tests/test_torch_train.py's bars, scaled to the learning rate)."""
    lr = 1e-4
    opt = Config(lr=lr, weightdecay=1e-3, tl_weight=0.5, margin=0.1)
    ref, ours, js, tm, init = _run_both(jax_model, opt, 3)
    assert all(np.isfinite(ours)) and min(ours) > 0
    for a, b in zip(ours, ref):
        assert a == pytest.approx(b, rel=1e-4)
    got = export_params(tm)
    want = {**_flat(js["params"], "params"), **_flat(js["batch_stats"], "batch_stats")}
    init = _flat(init, "params")
    assert set(got) == set(want)
    n_all = n_off = 0
    for name, w in want.items():
        if _zero_gradient(name):
            for g in (got[name], w):
                assert np.abs(g - init[name]).max() <= 3 * lr * (1 + 1e-6), name
            continue
        np.testing.assert_allclose(got[name], w, atol=0.1 * 3 * lr, rtol=0, err_msg=name)
        n_all += w.size
        n_off += int(np.sum(np.abs(got[name] - w) > 2e-7))
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_sgd_step_matches_jax(jax_model):
    """One SGD step with momentum and the coupled weight decay: the loss
    within rtol 1e-4, and the update of every parameter with a gradient
    within 1e-4 of the JAX update in L2 over the whole model (measured
    3.7e-6: the gradients' f32 sum order); the parameters whose exact
    gradient is 0 move by rounding noise only, under 1e-9, in both."""
    opt = Config(optim="sgd", lr=1e-2, weightdecay=1e-3, momentum=0.9)
    ref, ours, js, tm, init = _run_both(jax_model, opt, 1)
    assert ours[0] == pytest.approx(ref[0], rel=1e-4)
    got = export_params(tm)
    init = _flat(init, "params")
    du, dw = [], []
    for name, w in _flat(js["params"], "params").items():
        if _zero_gradient(name):
            for g in (got[name], w):
                assert np.abs(g - init[name]).max() <= 1e-9, name
            continue
        du.append((got[name] - init[name]).ravel())
        dw.append((w - init[name]).ravel())
    du, dw = np.concatenate(du), np.concatenate(dw)
    assert np.linalg.norm(du - dw) <= 1e-4 * np.linalg.norm(dw)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.fixture
def narrow(monkeypatch):
    """The CLIs build the narrow CvT for every ``cvt*`` arch."""
    real = archs.select

    def select(arch, opt, generator=None, img_size=224):
        if arch.startswith("cvt"):
            return CvTNetwork(embed_dim=opt.embed_dim, spec=CvTSpec(**SMALL),
                              generator=generator)
        return real(arch, opt, generator=generator, img_size=img_size)

    monkeypatch.setattr(archs, "select", select)


CLI_ARGS = ["--dataset", "synthetic", "--arch", "cvt_13_normalize", "--embed_dim", "16",
            "--msls_image_size", "32", "--nNeg", "2", "--device", "cpu"]
TRAIN_ARGS = CLI_ARGS + ["--n_epochs", "1", "--evalevery", "1", "--lr", "0.001"]


def test_train_and_test_cli(narrow, tmp_path):
    out = train_msls_baseline.main(TRAIN_ARGS + ["--save_path", str(tmp_path)])
    run = tmp_path / "synthetic" / "default_s1"
    assert out["run_dir"] == str(run)
    # 48 queries in 3 subcaches of 16, 4 triplets a step
    assert len(out["triplets"]) == 3 and len(out["step_loss"]) >= 3
    assert all(np.isfinite(out["step_loss"])) and len(out["mine_seconds"]) == 3
    assert 0.0 <= out["best_r5"] <= 1.0 and set(out["eval"][0]) == {
        f"globalR_{n}" for n in (1, 5, 10, 20, 50, 100)}
    for f in ("latest/state.pt", "best/state.pt", "latest.metrics.json", "log_train.csv",
              "log_test.csv"):
        assert (run / f).exists(), f
    assert len(list((run / "visual").glob("0_*.png"))) == min(3, len(out["step_loss"]))
    recalls = test_msls_baseline.main(CLI_ARGS + ["--use_ot", "--grid_size", "2",
                                                  "--resume_path", str(run / "best")])
    assert set(recalls) == {f"{k}R_{n}" for k in ("global", "diml")
                            for n in (1, 5, 10, 20, 50, 100)}
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in recalls.values())
    # the checkpoint's model evaluated globally gives the trainer's recalls
    again = test_msls_baseline.main(CLI_ARGS + ["--resume_path", str(run / "best")])
    assert again == {k: v for k, v in recalls.items() if k.startswith("global")}
    assert again == out["eval"][0]


class _Stop(Exception):
    pass


def test_resume_from_a_subcache_checkpoint(narrow, tmp_path, monkeypatch):
    """An uninterrupted run, and one stopped after its first subcache's
    checkpoint then resumed from ``latest``: the resumed run mines the same
    triplets for the two later subcaches, and both end on the same weights
    and recalls."""
    args = TRAIN_ARGS + ["--checkpoint_every_steps", "1"]
    full = train_msls_baseline.main(args + ["--save_path", str(tmp_path / "a")])
    real = train_msls_baseline.maybe_msls_subcache_checkpoint

    def stop_after_first(*a, **kw):
        real(*a, **kw)
        raise _Stop

    monkeypatch.setattr(train_msls_baseline, "maybe_msls_subcache_checkpoint",
                        stop_after_first)
    with pytest.raises(_Stop):
        train_msls_baseline.main(args + ["--save_path", str(tmp_path / "b")])
    monkeypatch.setattr(train_msls_baseline, "maybe_msls_subcache_checkpoint", real)
    latest = tmp_path / "b" / "synthetic" / "default_s1" / "latest"
    assert (latest.parent / "latest_mining.npz").exists()
    assert load_checkpoint(str(latest))["subset"] == 1
    resumed = train_msls_baseline.main(args + ["--save_path", str(tmp_path / "b"),
                                               "--resume_path", str(latest)])
    assert resumed["resumed"][:2] == (0, 1)
    assert resumed["triplets"] == full["triplets"][1:]
    assert sum(len(t) for _, _, t in resumed["triplets"]) > 0
    assert resumed["eval"] == full["eval"]
    a, b = full["model"].state_dict(), resumed["model"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("cli", ["train", "test"])
@pytest.mark.parametrize("flags", [
    ["--distill", "embed"], ["--enable_xbm"], ["--task_loss", "supcon"], ["--track_drift"],
    ["--cache_device"], ["--mesh_shape", "data:1"], ["--arch", "patchnetvlad"],
    ["--arch", "netvlad_pca128"], ["--arch", "irresnet50"],
], ids=lambda f: "".join(f).replace("--", "-"))
def test_msls_clis_refuse_what_is_not_ported(cli, flags, tmp_path):
    main = (train_msls_baseline if cli == "train" else test_msls_baseline).main
    with pytest.raises(NotImplementedError, match=flags[-1] if flags[0] == "--arch" else
                       flags[0][2:]):
        main(CLI_ARGS + flags + ["--save_path", str(tmp_path)])


def test_both_packages_fail_on_a_non_square_token_map(jax_model):
    """A 32 x 48 input leaves CvT a 2 x 3 token map: the JAX package's bank
    reshape fails, and the port raises ValueError naming the cause."""
    jm, variables = jax_model
    x = np.zeros((2, 32, 48, 3), np.float32)
    with pytest.raises(Exception):
        jax_make_embed_fn(jm)(variables, jnp.asarray(x))
    tm = load_jax_params(CvTNetwork(embed_dim=EMBED, spec=CvTSpec(**SMALL)), variables)
    for dense in (True, False):
        fn = train_msls_baseline.make_extract_fn(tm, dense, torch.device("cpu"))
        with pytest.raises(ValueError, match="square"):
            fn(x)


def test_both_packages_fail_on_cls_token_width_mismatch():
    """``use_cls_token`` (msls_val's default) with a 16-d embedding and a
    32-d bank, as a ResNet-50 gives with --use_ot: both packages fail, the
    port with ValueError naming both widths."""

    def extract(xp):
        def fn(imgs):
            B = imgs.shape[0]
            c = imgs.reshape(B, -1)[:, :16]
            return c, xp.ones((B, 32, 4), xp.float32) * imgs.reshape(B, -1)[:, :1, None]
        return fn

    mk = lambda pkg: pkg.SyntheticMSLS(n_queries=8, n_db=16, nNeg=2, image_size=16,
                                       cached_queries=8, cached_negatives=16, seed=0)
    with pytest.raises(Exception):
        jax_msls_val(mk(jax_msls), extract(jnp), trunc_nums=(0, 4), batch=8)
    with pytest.raises(ValueError, match="16-d global embeddings with a 32-d"):
        msls_val(mk(msls), extract(np), trunc_nums=(0, 4), batch=8)
