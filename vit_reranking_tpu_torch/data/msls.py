"""Mapillary Street-Level Sequences (MSLS): the city reader, the synthetic
stand-in, and subcache hard-negative mining.

Port of vit_reranking_tpu/data/msls.py (reference training_tools/msls.py:
76-584) with the same attribute surface (``qIdx``, ``qImages``, ``pIdx``,
``nonNegIdx``, ``dbImages``, ``qEndPosList``, ``dbEndPosList``,
``all_pos_indices``, ``night``, ``sideways``, ``weights``, ``triplets``,
``negCache``) and the same ``np.random.default_rng(seed)`` stream, so the
same descriptors give the same pools and triplets.  Two things differ in
how, not in what:

  * the CSVs are read with the ``csv`` module and numpy, as
    ``pandas.read_csv(path, index_col=0)`` reads them for these columns
    (:class:`_Table`);
  * the UTM radius queries are the arithmetic of scikit-learn's brute
    ``NearestNeighbors.radius_neighbors`` (its Euclidean reduction: BLAS
    ``ddot`` row norms, a ``dgemm`` middle term, ``|q|^2 + m + |d|^2 <=
    r^2``) through scipy's BLAS, which decides points within a millimetre
    of the 10 m and 25 m radii as it does (:func:`radius_neighbors`).

Mining ranks with numpy on the host, as the JAX package does; the
descriptors come from the caller's ``embed_fn`` (the port's model on the
card).  PIL is imported inside the functions that open images.
"""

from __future__ import annotations

import csv
import itertools
import math
from os.path import join
from typing import Callable, List, Optional

import numpy as np

default_cities = {
    "train": ["trondheim", "london", "boston", "melbourne", "amsterdam", "helsinki",
              "tokyo", "toronto", "saopaulo", "moscow", "zurich", "paris", "bangkok",
              "budapest", "austin", "berlin", "ottawa", "phoenix", "goa", "amman",
              "nairobi", "manila"],
    "val": ["cph", "sf"],
    "test": ["miami", "athens", "buenosaires", "stockholm", "bengaluru", "kampala"],
}

_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def _number(text: str) -> float:
    """A cell as pandas parses it into a number: booleans as 1 and 0, an
    empty cell as NaN."""
    if text in _TRUE:
        return 1.0
    if text in _FALSE:
        return 0.0
    return float(text) if text.strip() else math.nan


class _Table:
    """A CSV read as ``pandas.read_csv(path, index_col=0)`` reads the
    columns MSLS uses: the first column is the (integer) index, every other
    column is kept as text and converted where it is read."""

    def __init__(self, path: str):
        with open(path, newline="") as f:
            header, *body = list(csv.reader(f))
        self.index = np.asarray([int(r[0]) for r in body], dtype=np.int64)
        self._cols = {name: [r[i] for r in body] for i, name in enumerate(header) if i}
        self._pos = {int(label): i for i, label in enumerate(self.index)}

    def __len__(self) -> int:
        return len(self.index)

    def text(self, col: str, rows=None) -> List[str]:
        vals = self._cols[col]
        return vals if rows is None else [vals[i] for i in rows]

    def numbers(self, col: str, rows=None) -> np.ndarray:
        return np.asarray([_number(t) for t in self.text(col, rows)], dtype=np.float64)

    def loc(self, labels) -> List[int]:
        """Row positions of index ``labels`` (``.loc``; KeyError when one is
        missing)."""
        return [self._pos[int(label)] for label in labels]

    def truthy(self, col: str) -> np.ndarray:
        """``np.where(frame[col])[0]``: the positions of nonzero cells."""
        return np.where(self.numbers(col) != 0)[0]

    def equals_false(self, col: str) -> np.ndarray:
        """``(frame[col] == False).values`` of a column of ``True`` /
        ``False`` text (or of numbers: 0 is False)."""
        out = []
        for t in self.text(col):
            try:
                out.append(_number(t) == 0.0)
            except ValueError:
                out.append(False)
        return np.asarray(out, dtype=bool)


def _row_sq_norms(x: np.ndarray) -> np.ndarray:
    from scipy.linalg import blas

    return np.asarray([blas.ddot(row, row) for row in x], dtype=np.float64)


def radius_neighbors(db: np.ndarray, queries: np.ndarray, radius: float,
                     chunk: int = 256) -> List[np.ndarray]:
    """For each query, the indices of ``db`` within ``radius``, ascending:
    ``NearestNeighbors(algorithm="brute").fit(db).radius_neighbors(queries,
    radius)[1]`` with scikit-learn's own float64 arithmetic (its Euclidean
    radius reduction): the squared distance ``|q|^2 + (-2 q . d) + |d|^2``
    from BLAS ``ddot`` norms and a ``dgemm`` middle term, clipped at 0 and
    held to ``radius ** 2``.  At MSLS's UTM magnitudes (1e5-1e7 m) this
    decides points within a millimetre of the radius otherwise than the
    direct distance or numpy's own expansion would."""
    from scipy.linalg import blas

    db = np.ascontiguousarray(db, dtype=np.float64)
    queries = np.ascontiguousarray(queries, dtype=np.float64)
    db_sq, q_sq = _row_sq_norms(db), _row_sq_norms(queries)
    r2 = float(radius) * float(radius)
    out = []
    for s in range(0, len(queries), chunk):
        middle = blas.dgemm(-2.0, queries[s:s + chunk], db, trans_b=True)
        sq = np.maximum((q_sq[s:s + chunk, None] + middle) + db_sq[None, :], 0.0)
        out.extend(np.nonzero(row)[0] for row in sq <= r2)
    return out


class ImagesFromList:
    """Path-list dataset returning (image, idx) (reference msls.py:55-73).
    Comma-joined paths (sequences) give a stacked (L, H, W, 3) array."""

    def __init__(self, images, transform):
        self.images = np.asarray(images)
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        from PIL import Image

        try:
            imgs = [Image.open(im) for im in self.images[idx].split(",")]
        except Exception:
            imgs = [Image.open(self.images[0])]
        arrs = [self.transform(im) for im in imgs]
        return (arrs[0] if len(arrs) == 1 else np.stack(arrs)), idx


class MSLS:
    def __init__(self, root_dir, cities="", nNeg=5, transform=None, mode="train",
                 task="im2im", subtask="all", seq_length=1, posDistThr=10,
                 negDistThr=25, cached_queries=1000, cached_negatives=1000,
                 positive_sampling=True, bs=24, threads=8, margin=0.1,
                 exclude_panos=True, seed=0):
        assert mode in ("train", "val", "test")
        assert task in ("im2im", "im2seq", "seq2im", "seq2seq")
        assert subtask in ("all", "s2w", "w2s", "o2n", "n2o", "d2n", "n2d")
        assert seq_length % 2 == 1
        assert (task == "im2im" and seq_length == 1) or (task != "im2im" and seq_length > 1)

        if cities in default_cities:
            self.cities = default_cities[cities]
        elif cities == "":
            self.cities = default_cities[mode]
        else:
            self.cities = cities.split(",")

        self.qIdx, self.qImages, self.pIdx, self.nonNegIdx, self.dbImages = [], [], [], [], []
        self.sideways, self.night = [], []
        self.qEndPosList, self.dbEndPosList = [], []
        self.all_pos_indices = []

        self.nNeg = nNeg
        self.margin = margin
        self.posDistThr = posDistThr
        self.negDistThr = negDistThr
        self.cached_queries = cached_queries
        self.cached_negatives = cached_negatives
        self.exclude_panos = exclude_panos
        self.mode = mode
        self.subtask = subtask
        self.transform = transform
        self.bs = bs
        self.threads = threads
        self.rng = np.random.default_rng(seed)

        if task == "im2im":
            seq_length_q, seq_length_db = 1, 1
        elif task == "seq2seq":
            seq_length_q, seq_length_db = seq_length, seq_length
        elif task == "seq2im":
            seq_length_q, seq_length_db = seq_length, 1
        else:
            seq_length_q, seq_length_db = 1, seq_length
        self.task = task
        self.seq_length_q = seq_length_q
        self.seq_length_db = seq_length_db

        for city in self.cities:
            subdir = "test" if city in default_cities["test"] else "train_val"
            qdir = join(root_dir, subdir, city, "query")
            dbdir = join(root_dir, subdir, city, "database")
            _lenQ, _lenDb = len(self.qImages), len(self.dbImages)

            if self.mode in ("train", "val"):
                qData = _Table(join(qdir, "postprocessed.csv"))
                qDataRaw = _Table(join(qdir, "raw.csv"))
                dbData = _Table(join(dbdir, "postprocessed.csv"))
                dbDataRaw = _Table(join(dbdir, "raw.csv"))

                qSeqKeys, qSeqIdxs = self.arange_as_seq(qData, qdir, seq_length_q)
                dbSeqKeys, dbSeqIdxs = self.arange_as_seq(dbData, dbdir, seq_length_db)

                if self.mode == "val":
                    qIdxF = _Table(join(qdir, "subtask_index.csv"))
                    dbIdxF = _Table(join(dbdir, "subtask_index.csv"))
                    qSeqKeys, qSeqIdxs = self.filter(qSeqKeys, qSeqIdxs, qIdxF.truthy(self.subtask))
                    dbSeqKeys, dbSeqIdxs = self.filter(dbSeqKeys, dbSeqIdxs,
                                                       dbIdxF.truthy(self.subtask))

                if self.exclude_panos:
                    qSeqKeys, qSeqIdxs = self.filter(
                        qSeqKeys, qSeqIdxs, np.where(qDataRaw.equals_false("pano"))[0])
                    dbSeqKeys, dbSeqIdxs = self.filter(
                        dbSeqKeys, dbSeqIdxs, np.where(dbDataRaw.equals_false("pano"))[0])

                unique_qSeqIdx = np.unique(qSeqIdxs)
                unique_dbSeqIdx = np.unique(dbSeqIdxs)
                if len(unique_qSeqIdx) == 0 or len(unique_dbSeqIdx) == 0:
                    continue

                self.qImages.extend(qSeqKeys)
                self.dbImages.extend(dbSeqKeys)
                self.qEndPosList.append(len(qSeqKeys))
                self.dbEndPosList.append(len(dbSeqKeys))

                qRows = qData.loc(unique_qSeqIdx)
                dbRows = dbData.loc(unique_dbSeqIdx)

                utmQ = np.stack([qData.numbers("easting", qRows),
                                 qData.numbers("northing", qRows)], 1).reshape(-1, 2)
                utmDb = np.stack([dbData.numbers("easting", dbRows),
                                  dbData.numbers("northing", dbRows)], 1).reshape(-1, 2)
                night = qData.numbers("night", qRows)
                sideways = np.asarray(
                    [t == "Sideways" for t in qData.text("view_direction", qRows)], dtype=bool)
                index = qData.index[qRows]

                pos_indices = radius_neighbors(utmDb, utmQ, self.posDistThr)
                self.all_pos_indices.extend(pos_indices)
                if self.mode == "train":
                    nI = radius_neighbors(utmDb, utmQ, self.negDistThr)

                frameIdx2uniq = lambda f, u: np.where(np.isin(u, f))[0]
                uniq2seq = lambda f, s: np.where(np.isin(s, f).reshape(s.shape))[0]

                for q_seq_idx in range(len(qSeqKeys)):
                    q_frame_idxs = qSeqIdxs[q_seq_idx]
                    q_uniq = frameIdx2uniq(q_frame_idxs, unique_qSeqIdx)
                    p_uniq = np.unique([p for u in q_uniq for p in pos_indices[u]])
                    if len(p_uniq) > 0:
                        p_seq_idx = np.unique(uniq2seq(unique_dbSeqIdx[p_uniq], dbSeqIdxs))
                        self.pIdx.append(p_seq_idx + _lenDb)
                        self.qIdx.append(q_seq_idx + _lenQ)
                        if self.mode == "train":
                            n_uniq = np.unique([n for u in q_uniq for n in nI[u]])
                            n_seq_idx = np.unique(uniq2seq(unique_dbSeqIdx[n_uniq], dbSeqIdxs))
                            self.nonNegIdx.append(n_seq_idx + _lenDb)
                            if np.sum(night[np.isin(index, q_frame_idxs)]) > 0:
                                self.night.append(len(self.qIdx) - 1)
                            if np.sum(sideways[np.isin(index, q_frame_idxs)]) > 0:
                                self.sideways.append(len(self.qIdx) - 1)
            else:  # test
                qIdxF = _Table(join(qdir, "subtask_index.csv"))
                dbIdxF = _Table(join(dbdir, "subtask_index.csv"))
                qSeqKeys, qSeqIdxs = self.arange_as_seq(qIdxF, qdir, seq_length_q)
                dbSeqKeys, dbSeqIdxs = self.arange_as_seq(dbIdxF, dbdir, seq_length_db)
                qSeqKeys, qSeqIdxs = self.filter(qSeqKeys, qSeqIdxs, qIdxF.truthy(self.subtask))
                dbSeqKeys, dbSeqIdxs = self.filter(dbSeqKeys, dbSeqIdxs,
                                                   dbIdxF.truthy(self.subtask))
                self.qImages.extend(qSeqKeys)
                self.dbImages.extend(dbSeqKeys)
                self.qIdx.extend(range(_lenQ, len(qSeqKeys) + _lenQ))

        if len(self.qImages) == 0 or len(self.dbImages) == 0:
            raise RuntimeError(
                "No query/database images for the chosen cities/task/subtask."
            )

        self.qIdx = np.asarray(self.qIdx)
        self.qImages = np.asarray(self.qImages)
        self.pIdx = np.asarray(self.pIdx, dtype=object)
        self.nonNegIdx = np.asarray(self.nonNegIdx, dtype=object)
        self.dbImages = np.asarray(self.dbImages)
        self.sideways = np.asarray(self.sideways)
        self.night = np.asarray(self.night)
        self.triplets: List = []

        if mode == "train":
            self.negCache = np.asarray([np.empty((0,), dtype=int)] * len(self.qIdx))
            if positive_sampling:
                self.__calcSamplingWeights__()
            else:
                self.weights = np.ones(len(self.qIdx)) / float(len(self.qIdx))

    def __calcSamplingWeights__(self):
        """night/sideways-weighted query sampling (msls.py:309-331)."""
        N = len(self.qIdx)
        self.weights = np.ones(N)
        if len(self.night) != 0:
            self.weights[self.night] += N / len(self.night)
        if len(self.sideways) != 0:
            self.weights[self.sideways] += N / len(self.sideways)

    @staticmethod
    def arange_as_seq(data: _Table, path, seq_length):
        """The keys and frame rows of every run of ``seq_length`` frames
        centred on a row of ``data`` that ``seq_info.csv`` has as one
        sequence of consecutive frame numbers."""
        seqInfo = _Table(join(path, "seq_info.csv"))
        seq_keys, seq_idxs = [], []
        for idx in data.index:
            if idx < (seq_length // 2) or idx >= (len(seqInfo) - seq_length // 2):
                continue
            seq_idx = np.arange(-seq_length // 2, seq_length // 2) + 1 + idx
            frames = seqInfo.numbers("frame_number", seq_idx)
            if len(np.unique(seqInfo.text("sequence_key", seq_idx))) == 1 and (
                np.diff(frames) == 1
            ).all():
                seq_keys.append(
                    ",".join(join(path, "images", k + ".jpg")
                             for k in seqInfo.text("key", seq_idx))
                )
                seq_idxs.append(seq_idx)
        return seq_keys, np.asarray(seq_idxs)

    @staticmethod
    def filter(seqKeys, seqIdxs, center_frame_condition):
        keys, idxs = [], []
        for key, idx in zip(seqKeys, seqIdxs):
            if idx[len(idx) // 2] in center_frame_condition:
                keys.append(key)
                idxs.append(idx)
        return keys, np.asarray(idxs)

    def __len__(self):
        return len(self.triplets)

    def mining_state(self) -> dict:
        """The subcache-mining state: the numpy generator's state, the
        negative cache, this epoch's subcache split and the subset cursor.
        Taken at a subcache boundary it makes a resumed run pick the same
        pools and mine the same triplets for every later subcache.  A plain
        dict of numpy arrays, ints and the generator's state dict
        (cli/common.py writes it as a numpy archive)."""
        return {
            "rng": self.rng.bit_generator.state,
            "negCache": getattr(self, "negCache", None),
            "subcache_indices": getattr(self, "subcache_indices", None),
            "current_subset": int(getattr(self, "current_subset", 0)),
            "nCacheSubset": int(getattr(self, "nCacheSubset", 0)),
        }

    def set_mining_state(self, state: dict) -> None:
        """Inverse of :meth:`mining_state`: restore mid-epoch mining."""
        self.rng.bit_generator.state = state["rng"]
        if state["negCache"] is not None:
            self.negCache = state["negCache"]
        if state["subcache_indices"] is not None:
            self.subcache_indices = state["subcache_indices"]
            self.nCacheSubset = state["nCacheSubset"]
            self.current_subset = state["current_subset"]

    def new_epoch(self):
        """Shuffled, weighted query subcaches (msls.py:399-414)."""
        self.nCacheSubset = math.ceil(len(self.qIdx) / self.cached_queries)
        p = self.weights / self.weights.sum()
        arr = self.rng.choice(len(self.qIdx), size=len(self.qIdx), replace=True, p=p)
        self.subcache_indices = np.array_split(arr, self.nCacheSubset)
        self.current_subset = 0

    def update_subcache(self, embed_fn: Optional[Callable] = None,
                        outputdim: Optional[int] = None):
        """Hard-negative mining over the current subcache (msls.py:416-567).

        ``embed_fn(images (B, H, W, 3) float32 numpy) -> (B, D)`` numpy
        descriptors; without it, random triplets (a positive, and negatives
        outside the query's non-negatives)."""
        self.triplets = []
        if embed_fn is None:
            qidxs = self.rng.choice(len(self.qIdx), min(self.cached_queries, len(self.qIdx)),
                                    replace=False)
            for q in qidxs:
                qidx = self.qIdx[q]
                pidx = self.rng.choice(self.pIdx[q], size=1)[0]
                while True:
                    nidxs = self.rng.choice(len(self.dbImages), size=self.nNeg)
                    if np.sum(np.isin(nidxs, np.asarray(self.nonNegIdx[q]))) == 0:
                        break
                self.triplets.append(([qidx, pidx, *nidxs], [-1, 1] + [0] * len(nidxs)))
            self.current_subset += 1
            return

        qidxs, pidxs, nidxs = self._select_pools()

        qvecs = self._embed_paths(self.qImages[self.qIdx[qidxs]], embed_fn)
        pvecs = self._embed_paths(self.dbImages[pidxs], embed_fn)
        nvecs = self._embed_paths(self.dbImages[nidxs], embed_fn)
        self._mine_from_vecs(qidxs, pidxs, nidxs, qvecs, pvecs, nvecs)

    def _select_pools(self):
        """The current subcache's (query idxs, positive db ids, negative db
        ids) (msls.py:416-447)."""
        if self.current_subset >= len(self.subcache_indices):
            self.current_subset = 0
        qidxs = np.asarray(self.subcache_indices[self.current_subset])

        pidxs = np.unique([i for idx in self.pIdx[qidxs] for i in idx])
        nidxs = self.rng.choice(
            len(self.dbImages), min(self.cached_negatives, len(self.dbImages)), replace=False
        )
        nonneg = np.unique([i for idx in self.nonNegIdx[qidxs] for i in idx])
        nidxs = nidxs[np.isin(nidxs, nonneg, invert=True)]
        return qidxs, pidxs, nidxs

    def _mine_from_vecs(self, qidxs, pidxs, nidxs, qvecs, pvecs, nvecs):
        """Hardest-negative triplets from the pools' descriptors
        (msls.py:489-558): for each query, its best-ranked cached positive
        and the nNeg negatives of smallest loss, where more than nNeg
        violate the margin."""
        self.triplets = []
        pScores = qvecs @ pvecs.T
        pRanks = np.argsort(-pScores, axis=1)
        nScores = qvecs @ nvecs.T

        for q in range(len(qidxs)):
            qi = qidxs[q]
            cached_pidx = np.where(np.isin(pidxs, self.pIdx[qi]))[0]
            prank_pos = np.where(np.isin(pRanks[q], cached_pidx))[0]
            if len(prank_pos) == 0:
                continue
            dPos = pScores[q, pRanks[q, prank_pos[0]]]
            dNeg = nScores[q]
            loss = dPos - dNeg + self.margin**0.5
            violating = loss > 0
            if np.sum(violating) <= self.nNeg:
                continue
            hardest = np.argsort(loss)[: self.nNeg]
            qidx = self.qIdx[qi]
            pidx = pidxs[pRanks[q, prank_pos[0]]]
            hardestNeg = nidxs[hardest]
            self.triplets.append(([qidx, pidx, *hardestNeg], [-1, 1] + [0] * len(hardestNeg)))
        self.current_subset += 1

    # A comma-joined key names the L frames of a sequence (arange_as_seq):
    # frames stack to an (L, H, W, C) axis, flatten into the forward's
    # batch, and the sequence's descriptor is the L2-normalised mean of its
    # frames' embeddings (center-frame semantics for positives and subtasks).

    def load_frame(self, path: str) -> np.ndarray:
        """Load and transform one frame."""
        from PIL import Image

        return self.transform(Image.open(path))

    def _load_key(self, key: str, transform=None) -> np.ndarray:
        """Key -> (H, W, C) single frame or (L, H, W, C) stacked sequence."""
        if transform is None:
            load = self.load_frame
        else:
            def load(p):
                from PIL import Image

                return transform(Image.open(p))
        frames = [load(p) for p in key.split(",")]
        return frames[0] if len(frames) == 1 else np.stack(frames)

    def load_image_array(self, name: str) -> np.ndarray:
        """Load and transform one key (the whole sequence when comma-joined)."""
        return self._load_key(name)

    @staticmethod
    def aggregate_seq(frame_embs: np.ndarray, L: int, eps: float = 1e-12) -> np.ndarray:
        """(B*L, D) per-frame embeddings -> (B, D) L2-normalised means."""
        e = frame_embs.reshape(-1, L, frame_embs.shape[-1]).mean(1)
        return e / (np.linalg.norm(e, axis=-1, keepdims=True) + eps)

    def _embed_paths(self, paths, embed_fn, batch=32):
        """Embed keys (sequences aggregate over frames); ``embed_fn`` sees
        only fixed (batch, H, W, 3) frame batches, the last one zero-padded."""
        out = []
        for s in range(0, len(paths), batch):
            items = [self._load_key(p) for p in paths[s : s + batch]]
            n = len(items)
            arr = np.stack(items)
            if n < batch:
                arr = np.concatenate(
                    [arr, np.zeros((batch - n, *arr.shape[1:]), arr.dtype)]
                )
            if arr.ndim == 5:  # (batch, L, H, W, 3) sequences
                L = arr.shape[1]
                flat = arr.reshape(batch * L, *arr.shape[2:])
                embs = np.concatenate(
                    [
                        np.asarray(embed_fn(flat[i * batch : (i + 1) * batch]))
                        for i in range(L)
                    ],
                    0,
                )
                out.append(self.aggregate_seq(embs, L)[:n])
            else:
                out.append(np.asarray(embed_fn(arr))[:n])
        return np.concatenate(out, 0)

    def __getitem__(self, idx):
        triplet, target = self.triplets[idx]
        qidx, pidx, nidx = triplet[0], triplet[1], triplet[2:]
        query = self._load_key(self.qImages[qidx])
        positive = self._load_key(self.dbImages[pidx])
        negatives = np.stack([self._load_key(self.dbImages[i]) for i in nidx])
        return query, positive, negatives, [qidx, pidx] + list(nidx)

    @staticmethod
    def collate_fn(batch):
        """(q, p, negs) -> stacked arrays (msls.py:367-394)."""
        batch = [b for b in batch if b is not None]
        if not batch:
            return None, None, None, None, None
        query, positive, negatives, indices = zip(*batch)
        query = np.stack(query)
        positive = np.stack(positive)
        negCounts = np.asarray([n.shape[0] for n in negatives])
        negatives = np.concatenate(negatives, 0)
        indices = list(itertools.chain(*indices))
        return query, positive, negatives, negCounts, indices


class SyntheticMSLS(MSLS):
    """In-memory MSLS stand-in: procedural images on a grid of UTM positions,
    with :class:`MSLS`'s attributes and methods (the JAX package's
    ``SyntheticMSLS``, value for value).

    Sequence keys are comma-joined frame names; the frames of one sequence
    render at small UTM offsets around the center frame."""

    def __init__(self, n_queries=32, n_db=64, nNeg=2, image_size=64,
                 cached_queries=16, cached_negatives=32, margin=0.1, seed=0,
                 mode="train", task="im2im", seq_length=1):
        assert task in ("im2im", "im2seq", "seq2im", "seq2seq")
        assert seq_length % 2 == 1
        self.nNeg = nNeg
        self.margin = margin
        self.cached_queries = cached_queries
        self.cached_negatives = cached_negatives
        self.mode = mode
        self.bs = 8
        self.threads = 1
        self.rng = np.random.default_rng(seed)
        self.image_size = image_size
        self.task = task
        self.seq_length_q = seq_length if task in ("seq2im", "seq2seq") else 1
        self.seq_length_db = seq_length if task in ("im2seq", "seq2seq") else 1

        rng = np.random.default_rng(seed + 1)
        # db positions on a loose grid; queries near a random db point
        self.utmDb = rng.uniform(0, 1000, (n_db, 2))
        anchor = rng.integers(0, n_db, n_queries)
        self.utmQ = self.utmDb[anchor] + rng.uniform(-5, 5, (n_queries, 2))

        d = np.linalg.norm(self.utmQ[:, None] - self.utmDb[None, :], axis=-1)
        pos = [np.where(d[i] <= 10)[0] for i in range(n_queries)]
        nonneg = [np.where(d[i] <= 25)[0] for i in range(n_queries)]

        def seq_key(base, L):
            if L == 1:
                return base
            half = L // 2
            return ",".join(f"{base}@{k}" for k in range(-half, half + 1))

        keep = [i for i in range(n_queries) if len(pos[i]) > 0]
        self.qIdx = np.asarray(keep)
        self.qImages = np.asarray(
            [seq_key(f"q{i}", self.seq_length_q) for i in range(n_queries)]
        )
        self.dbImages = np.asarray(
            [seq_key(f"db{i}", self.seq_length_db) for i in range(n_db)]
        )
        self.pIdx = np.asarray([pos[i] for i in keep], dtype=object)
        self.nonNegIdx = np.asarray([nonneg[i] for i in keep], dtype=object)
        self.all_pos_indices = [pos[i] for i in keep]
        self.qEndPosList = [n_queries]
        self.dbEndPosList = [n_db]
        self.night, self.sideways = np.asarray([]), np.asarray([])
        self.weights = np.ones(len(self.qIdx))
        self.triplets = []
        self.negCache = np.asarray([np.empty((0,), int)] * len(self.qIdx))

        # image content: a smooth function of UTM position plus noise, so
        # nearby places look alike
        self._db_protos = rng.standard_normal((8, 8, 3)).astype(np.float32)

        def render(utm, idx_seed):
            r = np.random.default_rng(idx_seed)
            phase = utm / 37.0
            g = np.linspace(0, 2 * np.pi, 8)
            patt = (
                np.sin(g[:, None] + phase[0])[:, :, None]
                + np.cos(g[None, :] + phase[1])[:, :, None]
            ).astype(np.float32)
            base = patt + 0.3 * self._db_protos
            img = np.kron(base, np.ones((image_size // 8, image_size // 8, 1), np.float32))
            return img + 0.2 * r.standard_normal(img.shape).astype(np.float32)

        self._render = render
        self.transform = None

    def load_frame(self, name):
        # frame names: "q3" / "db7" with an optional "@k" sequence offset
        off = 0
        if "@" in name:
            name, k = name.split("@")
            off = int(k)
        if name.startswith("db"):
            utm, seed = self.utmDb[int(name[2:])], 20_000 + int(name[2:])
        else:
            utm, seed = self.utmQ[int(name[1:])], 10_000 + int(name[1:])
        return self._render(utm + 1.5 * off, seed + 1000 * off)
