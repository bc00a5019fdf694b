"""The port's MSLS data and evaluation against the JAX package's, on the CPU.

* the reader (``data/msls.py::MSLS``) on a written city tree, every
  attribute compared exactly, in train, val and test modes, im2im and
  seq2seq; the UTM radius queries against scikit-learn at points within a
  millimetre of the 10 m and 25 m radii;
* ``SyntheticMSLS``, and hard-negative mining (``new_epoch``,
  ``update_subcache``) with and without an embedding: the same triplets and
  mining state, and a ``set_mining_state`` round trip through the trainer's
  numpy archive;
* ``recall_at_n``, ``msls_val`` on shared numpy features (global only and
  with the rerank, JAX's Pallas kernel in interpret mode), and the query !=
  gallery rerank ``fused_featvit_rerank_scores_qg`` against JAX's and
  against the port's eager ``calc_similarity``, and msls_val's eager branch
  against JAX's (1e-5, identical rankings: the same f32 terms summed in
  other orders);
* every default the port's ``Config`` shares with the JAX package's.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from sklearn.neighbors import NearestNeighbors
from stand_ins import write_msls_split

import vit_reranking_tpu.data.msls as jax_msls
from vit_reranking_tpu.core.config import Config as JaxConfig
from vit_reranking_tpu.engine.msls_val import msls_val as jax_msls_val
from vit_reranking_tpu.engine.msls_val import recall_at_n as jax_recall_at_n
from vit_reranking_tpu.ops.rerank_pallas import (
    fused_featvit_rerank_scores_qg as jax_fused_qg,
)
from vit_reranking_tpu.ops.similarity import calc_similarity as jax_calc_similarity

import vit_reranking_tpu_torch.data.msls as msls
from vit_reranking_tpu_torch.cli.common import _mining_arrays, _mining_state
from vit_reranking_tpu_torch.core.config import Config
from vit_reranking_tpu_torch.engine.msls_val import (
    eager_rerank_scores, msls_val, recall_at_n,
)
from vit_reranking_tpu_torch.ops.rerank import fused_featvit_rerank_scores_qg
from vit_reranking_tpu_torch.ops.similarity import calc_similarity

torch.set_num_threads(2)

TOL = 1e-5
# MSLS-sized UTM coordinates (metres)
EAST, NORTH = (3e5, 7e5), (4e6, 6e6)


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


def _ring(rng, center, radius, n, spread=1e-3):
    """``n`` points at ``radius`` +- ``spread`` metres around ``center``."""
    ang = rng.uniform(0, 2 * np.pi, n)
    d = radius + rng.uniform(-spread, spread, n)
    return center + np.stack([np.cos(ang), np.sin(ang)], 1) * d[:, None]


def _write_city(root, city, seed):
    """A city of 24 database and 12 query frames at MSLS magnitudes: runs of
    frames 8 m apart in sequences of 4 to 6 consecutive frame numbers (one
    broken by a skipped frame number), queries within a millimetre of 10 m
    and of 25 m from database frames, a night and a sideways query, a
    panorama in each split, and one frame out of the subtask."""
    rng = np.random.default_rng(seed)
    origin = np.array([rng.uniform(*EAST), rng.uniform(*NORTH)])
    n_db, n_q = 24, 12
    db = origin + np.stack([np.arange(n_db) * 8.0, np.zeros(n_db)], 1)
    db[12:] += [0.0, 40.0]
    q = np.concatenate([
        _ring(rng, db[3], 10.0, 3), _ring(rng, db[15], 25.0, 3),
        _ring(rng, db[8], 10.0, 2), db[[5, 18, 20, 22]] + rng.uniform(-3, 3, (4, 2)),
    ])
    for name, utm, n, sizes in (("database", db, n_db, (6, 5, 6, 7)),
                                ("query", q, n_q, (5, 4, 3))):
        seq = np.repeat([f"{city}-{name[0]}s{i}" for i in range(len(sizes))], sizes)
        frames = np.concatenate([np.arange(s) for s in sizes])
        frames[sizes[0] + 2:] += 1  # a skipped frame number inside the second sequence
        night, sideways, pano = np.zeros(n, bool), np.zeros(n, bool), np.zeros(n, bool)
        in_subtask = np.ones(n, bool)
        pano[4] = True
        in_subtask[n - 2] = False
        if name == "query":
            night[1], sideways[6] = True, True
        write_msls_split(os.path.join(root, "train_val", city, name),
                         [f"{city}_{name[0]}{i:03d}" for i in range(n)], utm, seq, frames,
                         night, sideways, pano, in_subtask)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("msls"))
    _write_city(root, "cityA", 0)
    _write_city(root, "cityB", 1)
    return root


def _same(a, b, name):
    if isinstance(a, np.ndarray) and a.dtype == object or isinstance(a, list):
        assert len(a) == len(b), name
        if isinstance(a, np.ndarray):
            assert a.shape == np.asarray(b).shape, name
        for x, y in zip(a, b):
            _same(np.asarray(x), np.asarray(y), name)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype.kind == b.dtype.kind and a.shape == b.shape, (name, a.dtype, b.dtype,
                                                                 a.shape, b.shape)
    assert np.array_equal(a, b), name


ATTRS = ("qIdx", "qImages", "pIdx", "nonNegIdx", "dbImages", "qEndPosList", "dbEndPosList",
         "all_pos_indices", "night", "sideways", "triplets", "seq_length_q", "seq_length_db")


@pytest.mark.parametrize("mode,task,seq", [
    ("train", "im2im", 1), ("val", "im2im", 1), ("test", "im2im", 1),
    ("train", "seq2seq", 3), ("val", "seq2seq", 3), ("test", "seq2seq", 3),
])
def test_reader_matches_jax(tree, mode, task, seq):
    kw = dict(cities="cityA,cityB", mode=mode, task=task, seq_length=seq, nNeg=2, seed=3)
    ref = jax_msls.MSLS(tree, **kw)
    ours = msls.MSLS(tree, **kw)
    assert len(ours.qImages) > 0 and len(ours.qEndPosList) == (2 if mode != "test" else 0)
    for name in ATTRS + ("cities",) + (("weights", "negCache") if mode == "train" else ()):
        _same(getattr(ours, name), getattr(ref, name), name)
    if mode == "train" and task == "im2im":
        # the night and sideways queries are weighted, the panoramas are gone
        assert len(ours.night) and len(ours.sideways)
        assert not any("_d004" in k for k in ours.dbImages)


def test_radius_neighbors_matches_sklearn_at_the_radii():
    """500 queries within 1 mm of 10 m (and of 25 m) from database points at
    MSLS magnitudes: the port's positive sets are scikit-learn's, row for
    row, while the direct distance decides some rows otherwise."""
    rng = np.random.default_rng(0)
    direct_off = 0
    for radius in (10.0, 25.0):
        db = np.stack([rng.uniform(*EAST, 400), rng.uniform(*NORTH, 400)], 1)
        src = rng.integers(0, 400, 500)
        q = np.concatenate([_ring(rng, db[s], radius, 1) for s in src])
        _, ref = NearestNeighbors(algorithm="brute").fit(db).radius_neighbors(q, radius)
        ours = msls.radius_neighbors(db, q, radius)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert np.array_equal(a, b) and a.dtype.kind == b.dtype.kind
        d = np.sqrt(((q[:, None] - db[None]) ** 2).sum(-1))
        direct_off += sum(not np.array_equal(np.nonzero(r <= radius)[0], b)
                          for r, b in zip(d, ref))
    assert direct_off > 0


def test_images_from_list_and_input_transform_match_jax(tmp_path):
    """JPEG frames of a written split through ``ImagesFromList`` and MSLS's
    ``input_transform`` (a bilinear resize to (h, w), then normalize), a
    comma-joined sequence key stacked, bit for bit against the JAX
    package's."""
    from vit_reranking_tpu.data.transforms import input_transform as jax_input_transform

    from vit_reranking_tpu_torch.data.transforms import input_transform

    d = tmp_path / "query"
    keys = [f"q{i}" for i in range(4)]
    write_msls_split(str(d), keys, np.zeros((4, 2)), ["s"] * 4, np.arange(4),
                     image_size=(36, 20))
    paths = [str(d / "images" / f"{k}.jpg") for k in keys]
    names = [paths[0], ",".join(paths[1:])]
    ref = jax_msls.ImagesFromList(names, jax_input_transform((12, 18)))
    ours = msls.ImagesFromList(names, input_transform((12, 18)))
    assert input_transform((12, 18)).resize == (12, 18) and len(ours) == 2
    for i in range(2):
        (a, ia), (b, ib) = ours[i], ref[i]
        assert ia == ib and a.dtype == b.dtype and np.array_equal(a, b)
    assert ours[1][0].shape == (3, 12, 18, 3)


# ---------------------------------------------------------------------------
# SyntheticMSLS and mining
# ---------------------------------------------------------------------------


def _oracle(imgs):
    """A numpy embedding of the rendered images (their content is a smooth
    function of the UTM position): mean colour and row means, unit norm."""
    x = np.concatenate([imgs.reshape(imgs.shape[0], -1, 3).mean(1),
                        imgs.reshape(imgs.shape[0], 8, -1).mean(-1)], -1)
    return (x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)).astype(np.float32)


def _synthetic(pkg, task="im2im", seq=1):
    return pkg.SyntheticMSLS(n_queries=24, n_db=48, nNeg=2, image_size=16, cached_queries=8,
                             cached_negatives=24, seed=0, task=task, seq_length=seq)


@pytest.mark.parametrize("task,seq", [("im2im", 1), ("seq2seq", 3)])
def test_synthetic_matches_jax(task, seq):
    ref, ours = _synthetic(jax_msls, task, seq), _synthetic(msls, task, seq)
    for name in ATTRS + ("weights", "negCache", "utmDb", "utmQ"):
        _same(getattr(ours, name), getattr(ref, name), name)
    for key in (ours.qImages[3], ours.dbImages[7]):
        assert np.array_equal(ours.load_image_array(key), ref.load_image_array(key))


def _state_equal(a, b):
    assert a["rng"] == b["rng"]
    assert a["current_subset"] == b["current_subset"] and a["nCacheSubset"] == b["nCacheSubset"]
    _same(a["negCache"], b["negCache"], "negCache")
    _same(list(a["subcache_indices"]), list(b["subcache_indices"]), "subcache_indices")


@pytest.mark.parametrize("task,seq,embed", [("im2im", 1, True), ("im2im", 1, False),
                                            ("seq2seq", 3, True)])
def test_mining_matches_jax(task, seq, embed, tmp_path):
    """Every subcache of an epoch mined in both packages from the same
    embedding (or none): the same triplets and mining state.  Then the state
    after the first subcache, written and read back as the trainer's numpy
    archive, restores a fresh port dataset (on another generator) to mine
    the later subcaches as the uninterrupted one did."""
    fn = _oracle if embed else None
    ref, ours = _synthetic(jax_msls, task, seq), _synthetic(msls, task, seq)
    ref.new_epoch()
    ours.new_epoch()
    saved, later = None, []
    for sub in range(ours.nCacheSubset):
        ref.update_subcache(fn, None)
        ours.update_subcache(fn, None)
        assert [tuple(map(int, t)) for t, _ in ours.triplets] == \
            [tuple(map(int, t)) for t, _ in ref.triplets]
        assert [t for _, t in ours.triplets] == [t for _, t in ref.triplets]
        _state_equal(ours.mining_state(), ref.mining_state())
        if sub == 0:
            np.savez(tmp_path / "mining.npz", **_mining_arrays(ours.mining_state()))
        else:
            later.append([tuple(map(int, t)) for t, _ in ours.triplets])
    assert sum(map(len, later)) > 0 or not embed
    resumed = _synthetic(msls, task, seq)
    resumed.rng = np.random.default_rng(12345)
    with np.load(tmp_path / "mining.npz", allow_pickle=False) as z:
        resumed.set_mining_state(_mining_state(z))
    again = []
    for _ in range(1, resumed.nCacheSubset):
        resumed.update_subcache(fn, None)
        again.append([tuple(map(int, t)) for t, _ in resumed.triplets])
    assert again == later
    _state_equal(resumed.mining_state(), ours.mining_state())


def test_getitem_and_collate_match_jax():
    ref, ours = _synthetic(jax_msls), _synthetic(msls)
    for ds in (ref, ours):
        ds.new_epoch()
        ds.update_subcache(_oracle, None)
    items_r = [ref[i] for i in range(3)]
    items_o = [ours[i] for i in range(3)]
    for a, b in zip(msls.MSLS.collate_fn(items_o), jax_msls.MSLS.collate_fn(items_r)):
        _same(a, b, "collate")


# ---------------------------------------------------------------------------
# recall and validation
# ---------------------------------------------------------------------------


def test_recall_at_n_matches_jax():
    rng = np.random.default_rng(11)
    n_values = [1, 5, 10, 20, 50, 100]
    preds = [rng.integers(0, 60, (13, 30)), rng.integers(0, 60, (7, 30))]
    gt = [rng.integers(0, 60, int(rng.integers(0, 5))) for _ in range(20)]
    ref = np.asarray(jax_recall_at_n(preds, gt, n_values, 20))
    assert np.array_equal(recall_at_n(preds, gt, n_values, 20), ref)


def _extract(xp):
    """A deterministic extract function in numpy (the port's) or jax.numpy
    (JAX traces it inside its chunk program): 16 px images -> a (B, 6, 4)
    dense map (2x2 patches: mean colour and mean square colour) and its
    patch mean as the global embedding, unit norm."""

    def fn(imgs):
        B = imgs.shape[0]
        p = imgs.reshape(B, 2, 8, 2, 8, 3).transpose(0, 1, 3, 2, 4, 5).reshape(B, 4, 64, 3)
        dense = xp.concatenate([p.mean(2), (p * p).mean(2) - 1.0], -1).transpose(0, 2, 1)
        c = dense.mean(-1)
        return c / xp.linalg.norm(c, axis=-1, keepdims=True), dense

    return fn


@pytest.mark.parametrize("trunc", [(0,), (0, 8)])
def test_msls_val_matches_jax(trunc):
    ds = _synthetic(msls)
    ref = jax_msls_val(_synthetic(jax_msls), _extract(jnp), trunc_nums=trunc, batch=8)
    details = {}
    ours = msls_val(ds, _extract(np), trunc_nums=trunc, batch=8, details=details)
    assert set(ours) == set(ref) and ("dimlR_1" in ours) == (max(trunc) > 0)
    assert ours == ref
    if max(trunc):
        # the rerank moved some query's order
        assert not torch.equal(details["final"][0][:, :8], details["preds"][0][:, :8])


def _qg_problem(seed, Nq=20, Ng=40, K=8, C=12, R=9):
    rng = np.random.default_rng(seed)
    banks, cents = [], []
    for n in (Nq, Ng):
        b = rng.standard_normal((n, C, R)).astype(np.float32)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        c = b.mean(-1) + 0.1 * rng.standard_normal((n, C)).astype(np.float32)
        banks.append(b)
        cents.append(c / np.linalg.norm(c, axis=-1, keepdims=True))
    sims = cents[0] @ cents[1].T
    top = np.argsort(-sims, 1, kind="stable")[:, :K].astype(np.int32)
    return banks[0], cents[0], banks[1], cents[1], top


QG_FLAGS = {
    "msls-val": dict(use_minus=True, use_cls_token=True, temperature=0.1),
    "patch-mean": dict(use_minus=True, temperature=0.1),
    "partial-ot": dict(use_cls_token=True, ot_part=0.9),
}


def _per_pair_eager(qb, qc, gb, gc, top, flags):
    """The port's eager ``calc_similarity`` with each (query, candidate)
    pair a problem of its own, so that each exits Sinkhorn on its own
    residual, as the fused rerank's pairs do under full OT."""
    Q, K = top.shape
    score, _ = calc_similarity(
        qb[:, None].expand(-1, K, -1, -1).reshape(Q * K, *qb.shape[1:]),
        qc[:, None].expand(-1, K, -1).reshape(Q * K, -1),
        gb[top].reshape(Q * K, 1, *gb.shape[1:]), gc[top].reshape(Q * K, 1, -1), stage=1,
        **flags)
    return score.reshape(Q, K)


@pytest.mark.parametrize("name", list(QG_FLAGS))
def test_qg_rerank_matches_jax_and_eager(name):
    """The fused query != gallery rerank against JAX's (interpret mode) and
    against the port's eager ``calc_similarity`` computing the same
    function (full OT: each pair exiting on its own; partial OT: each
    query's candidates together, the fused rerank's group exit); and
    msls_val's eager branch (each query's candidates exit together)
    against the JAX package's (a vmap of its ``calc_similarity`` over the
    queries, engine/msls_val.py:259-266).  1e-5 and identical rankings."""
    flags = dict(QG_FLAGS[name], ot_temp=0.05)
    qb, qc, gb, gc, top = _qg_problem(1)
    jq = [jnp.asarray(x) for x in (qb, qc, gb, gc, top)]
    ref = np.asarray(jax_fused_qg(*jq, query_tile=8, interpret=True, **flags))
    t = [torch.from_numpy(x) for x in (qb, qc, gb, gc)]
    ttop = torch.from_numpy(top).long()
    ours = fused_featvit_rerank_scores_qg(*t, ttop, query_tile=8, **flags).numpy()
    order = lambda a: np.argsort(-np.asarray(a), 1, kind="stable")
    eager = eager_rerank_scores(*t, ttop, flags).numpy()
    same_function = eager if flags.get("ot_part", 1.0) <= 0.999 else \
        _per_pair_eager(*t, ttop, flags).numpy()
    jax_eager = np.asarray(jax.vmap(lambda i: jax_calc_similarity(
        jq[0][i], jq[1][i], jq[2][jq[4][i]], jq[3][jq[4][i]], stage=1, **flags)[0])(
        jnp.arange(top.shape[0])))
    for got, want in ((ours, ref), (same_function, ours), (eager, jax_eager)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert np.array_equal(order(got), order(want))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_config_defaults_match_jax():
    """Every field of the port's Config but ``device`` is a field of the JAX
    package's, with the same default; the MSLS CLIs' fields among them."""
    ours, ref = Config(), JaxConfig()
    names = [f.name for f in dataclasses.fields(Config)]
    jax_names = {f.name for f in dataclasses.fields(JaxConfig)}
    assert [n for n in names if n not in jax_names] == ["device"]
    for n in names:
        if n != "device":
            assert getattr(ours, n) == getattr(ref, n), n
    for n in ("nNeg", "margin", "msls_task", "msls_subtask", "msls_seq_length",
              "msls_image_size", "imageresizew", "imageresizeh", "cachebatchsize", "lrstep",
              "lrgamma", "weightdecay", "momentum", "mini_data", "tl_weight", "task_loss",
              "distill", "enable_xbm", "track_drift", "xbm_size", "kd_weight"):
        assert n in names, n
