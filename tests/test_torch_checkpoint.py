"""The port's checkpoint round trip on a written CUB200 tree, on the CPU:
train one epoch of one step (full CvT-13 with a 16-wide head, 224 px crops
of small JPEG/PNG files), then

  * evaluate ``best`` through ``run_eval --resume_path``: exactly the
    metrics of the same weights evaluated in memory, the rerank included;
  * resume ``latest`` into a fresh trainer: its next step (same batch,
    generator and learning rate) is the uninterrupted trainer's, bitwise;
  * ``--checkpoint_every_steps`` and ``--save_every_epoch`` refresh
    ``latest`` between evaluations; ``--sweep`` writes one row a run;
  * a ``--pretrained_ckpt`` that does not exist raises
    ``FileNotFoundError`` (the JAX package would skip it).

The options still refused (``--cache_device``, ``--mesh_shape``) are held
by ``tests/test_torch_train.py``.
"""

import copy
import csv
import os
import shutil

import numpy as np
import pytest
import torch

from vit_reranking_tpu_torch.cli import common, test_diml, train_baseline
from vit_reranking_tpu_torch.cli.common import (build_training, resume_train_state,
                                                run_train_step)
from vit_reranking_tpu_torch.core.checkpoint import load_checkpoint
from vit_reranking_tpu_torch.core.config import from_args

from stand_ins import write_class_tree

torch.set_num_threads(2)

TREE_ARGS = ["--dataset", "cub200", "--arch", "cvt_13_normalize", "--embed_dim", "16",
             "--bs", "4", "--kernels", "1", "--seed", "3", "--device", "cpu"]
TRAIN_ARGS = TREE_ARGS + ["--samples_per_class", "2", "--loss", "margin",
                          "--batch_mining", "distance", "--evalevery", "1"]
# the flagship rerank's flags (scripts/diml/test_diml_cvt.sh)
EVAL_ARGS = TREE_ARGS + ["--use_cls_token", "--temperature", "0.1", "--use_ot",
                         "--use_inverse", "--grid_size", "7", "--ot_part", "1.0",
                         "--use_rollout"]
TRUNCS = (0, 2)  # 4 test images: rerank each query's top 2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch (one step) on a 4-class tree: 4 training and 4 test images."""
    root = tmp_path_factory.mktemp("recipe")
    source = str(root / "data")
    write_class_tree(os.path.join(source, "cub200"), n_classes=4, per_class=2, seed=4)
    src = ["--source_path", source]
    summary = train_baseline.main(TRAIN_ARGS + src + [
        "--n_epochs", "1", "--save_path", str(root / "runs")])
    return dict(summary=summary, run=summary["run_dir"], src=src, root=root)


def test_eval_from_best_equals_in_memory(trained, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    state = trained["summary"]["state"]
    best = load_checkpoint(os.path.join(trained["run"], "best"))
    assert best["epoch"] == 0 and best["step"] == state.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(best["params"][k], v), k
    opt = from_args(EVAL_ARGS + trained["src"])
    from_best = test_diml.run_eval(
        opt.replace(resume_path=os.path.join(trained["run"], "best")), TRUNCS)
    # the same evaluation of the trained model as it is in memory
    monkeypatch.setattr(test_diml.archs, "select",
                        lambda *a, **kw: copy.deepcopy(state.model))
    in_memory = test_diml.run_eval(opt, TRUNCS)
    assert from_best == in_memory
    assert set(from_best["r1"]) == set(TRUNCS)


def _step(state, seed=11):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((4, 224, 224, 3)).astype(np.float32)
    lab = np.array([0, 0, 1, 1], np.int32)
    torch.manual_seed(seed)  # drop-path draws
    m = run_train_step(state, lab, images, torch.Generator().manual_seed(seed), "cpu")
    return float(m["loss"])


def test_resumed_step_equals_uninterrupted(trained):
    uninterrupted = copy.deepcopy(trained["summary"]["state"])
    opt = from_args(TRAIN_ARGS + trained["src"]).replace(n_classes=2)
    _, _, resumed = build_training(opt, steps_per_epoch=1, device=torch.device("cpu"))
    assert resume_train_state(os.path.join(trained["run"], "latest"), resumed) == 0
    assert resumed.step == uninterrupted.step == 1
    loss = _step(resumed)
    assert loss == _step(uninterrupted) and np.isfinite(loss)
    assert resumed.step == uninterrupted.step == 2
    for a, b in ((resumed.model, uninterrupted.model),
                 (resumed.criterion, uninterrupted.criterion)):
        for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), name
    sa, sb = resumed.optimizer.state_dict(), uninterrupted.optimizer.state_dict()
    assert [g["lr"] for g in sa["param_groups"]] == [g["lr"] for g in sb["param_groups"]]
    for i, st in sa["state"].items():
        for key, val in st.items():
            assert torch.equal(val, sb["state"][i][key]), (i, key)


def test_latest_refreshed_between_evaluations(trained, tmp_path, monkeypatch):
    """``--checkpoint_every_steps 1 --save_every_epoch`` from epoch 1 to 2,
    evaluating at epoch 2 only: every save of ``latest`` as (by, epoch,
    step, with metrics?); the step and epoch-end saves carry no metrics,
    the evaluation's do, and the last one is on disk."""
    saves = []

    def spy(by, real):
        def save(path, state, metrics=None):
            if path.endswith("/latest"):
                saves.append((by if not metrics else "eval", state["epoch"], state["step"]))
            real(path, state, metrics)
        return save

    monkeypatch.setattr(common, "save_checkpoint", spy("step", common.save_checkpoint))
    monkeypatch.setattr(train_baseline, "save_checkpoint",
                        spy("epoch", train_baseline.save_checkpoint))
    summary = train_baseline.main(TRAIN_ARGS + trained["src"] + [
        "--checkpoint_every_steps", "1", "--save_every_epoch", "--start_epoch", "1",
        "--n_epochs", "3", "--evalevery", "2", "--save_path", str(tmp_path)])
    assert saves == [("step", 1, 1), ("epoch", 1, 1), ("step", 2, 2), ("eval", 2, 2)]
    last = load_checkpoint(os.path.join(summary["run_dir"], "latest"))
    assert (last["epoch"], last["step"]) == (2, 2)


def test_sweep_writes_one_row_a_run(trained, tmp_path, monkeypatch):
    """Two runs (one with ``best``, one with only ``latest``) and a
    directory with neither, which the sweep skips."""
    monkeypatch.chdir(tmp_path)
    runs = tmp_path / "runs"
    shutil.copytree(trained["run"], runs / "a")
    shutil.copytree(trained["run"], runs / "b")
    shutil.rmtree(runs / "b" / "best")
    (runs / "c").mkdir()
    featvit = [a for a in EVAL_ARGS if a != "--use_rollout"]
    rows = test_diml.main(featvit + trained["src"] + ["--sweep", str(runs)])
    assert [name for name, _ in rows] == ["a", "b"]
    assert rows[0][1] == rows[1][1]  # best and latest hold the same weights
    with open(tmp_path / "test_results" / "sweep_cub200.csv") as f:
        table = list(csv.reader(f))
    assert table[0] == ["run", "r1@0", "rp@0", "mapr@0"]
    assert [r[0] for r in table[1:]] == ["a", "b"]


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_missing_pretrained_ckpt_raises(tmp_path, monkeypatch, cli):
    monkeypatch.chdir(tmp_path)
    args = ["--dataset", "synthetic", "--synthetic_size", "32", "--synthetic_classes", "2",
            "--synthetic_per_class", "4", "--bs", "4", "--embed_dim", "16", "--device", "cpu",
            "--arch", "cvt_13_normalize", "--pretrained_ckpt", str(tmp_path / "typo.pth")]
    with pytest.raises(FileNotFoundError, match="typo.pth"):
        if cli == "train":
            train_baseline.main(args + ["--save_path", str(tmp_path / "runs")])
        else:
            test_diml.main(args)
    assert not (tmp_path / "test_results").exists()
