"""Stand-ins for files no test can download: image trees in the CUB200,
Cars196, SOP and MSLS layouts, and torch state dicts in the key and shape sets of
the reference's ImageNet checkpoints (tests/manifests/*.json).

Everything is drawn from a seed with numpy.  ``chip_smoke.py`` loads this
module by its path too, so it imports nothing of JAX and imports PIL and
torch inside its functions.
"""

import csv
import json
import os

import numpy as np

MANIFESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "manifests")


def _save_image(path, rng, sides):
    from PIL import Image

    w, h = (int(s) for s in rng.integers(sides[0], sides[1] + 1, 2))
    # a smooth colour field and noise, so JPEG keeps some structure
    base = rng.integers(0, 256, (2, 2, 3)).astype(np.float32)
    field = np.asarray(Image.fromarray(base.astype(np.uint8)).resize((w, h), Image.BILINEAR))
    noise = rng.integers(-40, 41, (h, w, 3))
    Image.fromarray(np.clip(field + noise, 0, 255).astype(np.uint8)).save(path)


def write_class_tree(root, n_classes, per_class, seed=0, sides=(20, 60),
                     exts=(".jpg", ".png")):
    """The CUB200 / Cars196 layout: ``root/images/<class>/<file>``, class
    directories named ``001.class_0`` ..., files of random sides within
    ``sides`` (odd sizes and mixed aspect ratios), extensions in turn, and
    one file that is not an image."""
    rng = np.random.default_rng(seed)
    for c in range(n_classes):
        d = os.path.join(root, "images", f"{c + 1:03d}.class_{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            _save_image(os.path.join(d, f"img_{i}{exts[(c + i) % len(exts)]}"), rng, sides)
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("not an image\n")
    return root


def write_sop_tree(root, n_train, n_test, per_class, seed=0, sides=(20, 60)):
    """The SOP layout: ``Ebay_train.txt`` / ``Ebay_test.txt`` (a header,
    then ``image_id class_id super_class_id path``) and the images under
    ``<super_class>_final/``; class ids are 1-based, the test ids follow the
    training ones, and a gap in each split's ids tests the remapping."""
    rng = np.random.default_rng(seed)
    image_id = 1
    for fname, first, n in (("Ebay_train.txt", 1, n_train),
                            ("Ebay_test.txt", n_train + 3, n_test)):
        lines = ["image_id class_id super_class_id path"]
        for k in range(n):
            cls = first + k + (k >= n // 2)  # skip one id halfway
            sup = 1 + cls % 3
            d = os.path.join(root, f"super{sup}_final")
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                rel = f"super{sup}_final/{cls}_{i}.JPG"
                _save_image(os.path.join(root, rel), rng, sides)
                lines.append(f"{image_id} {cls} {sup} {rel}")
                image_id += 1
        with open(os.path.join(root, fname), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def _write_indexed_csv(path, header, rows):
    """A CSV whose first, unnamed column is the row index (what
    ``pandas.to_csv`` writes and ``read_csv(index_col=0)`` reads)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + list(header))
        for i, r in enumerate(rows):
            w.writerow([i] + list(r))


def write_msls_split(d, keys, utm, seq_keys, frames, night=None, sideways=None, pano=None,
                     in_subtask=None, image_size=None, seed=0):
    """One MSLS ``query/`` or ``database/`` directory: ``postprocessed.csv``
    (key, easting, northing, night, view_direction), ``raw.csv`` (key,
    pano), ``seq_info.csv`` (sequence_key, frame_number, key) and
    ``subtask_index.csv`` (all, s2w, ... n2d), indexed by frame row, as the
    reference's reader takes them; with ``image_size`` ((w, h)) also
    ``images/<key>.jpg``, whose colour follows the easting, so images of
    nearby places look alike.  ``in_subtask`` marks the frames of every
    subtask (default all)."""
    n = len(keys)
    night = np.zeros(n, bool) if night is None else night
    sideways = np.zeros(n, bool) if sideways is None else sideways
    pano = np.zeros(n, bool) if pano is None else pano
    in_subtask = np.ones(n, bool) if in_subtask is None else in_subtask
    os.makedirs(d, exist_ok=True)
    _write_indexed_csv(os.path.join(d, "postprocessed.csv"),
                       ["key", "easting", "northing", "night", "view_direction"],
                       [(k, repr(float(e)), repr(float(nn)), str(bool(ni)),
                         "Sideways" if s else "Forward")
                        for k, (e, nn), ni, s in zip(keys, utm, night, sideways)])
    _write_indexed_csv(os.path.join(d, "raw.csv"), ["key", "pano"],
                       [(k, str(bool(p))) for k, p in zip(keys, pano)])
    _write_indexed_csv(os.path.join(d, "seq_info.csv"), ["sequence_key", "frame_number", "key"],
                       [(sk, int(fr), k) for sk, fr, k in zip(seq_keys, frames, keys)])
    _write_indexed_csv(os.path.join(d, "subtask_index.csv"),
                       ["all", "s2w", "w2s", "o2n", "n2o", "d2n", "n2d"],
                       [[int(a)] * 7 for a in in_subtask])
    if image_size is None:
        return
    from PIL import Image

    os.makedirs(os.path.join(d, "images"), exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = image_size
    x = np.linspace(0, 2 * np.pi, w, dtype=np.float32)[:, None]
    # one noise field, shifted by a random row and column an image
    noise = rng.integers(-12, 13, (h, w, 3), dtype=np.int16)
    for key, (e, nn) in zip(keys, utm):
        phase = np.array([e / 37.0, nn / 53.0, (e + nn) / 71.0], np.float32)
        row = 127 + 80 * np.sin(x + phase)  # (w, 3): the colour varies along x
        shifted = np.roll(noise, tuple(int(k) for k in rng.integers(0, (h, w))), axis=(0, 1))
        Image.fromarray(np.clip(row[None] + shifted, 0, 255).astype(np.uint8)).save(
            os.path.join(d, "images", f"{key}.jpg"), quality=90)


def write_msls_city(root, city, n_db, n_q, seed=0, image_size=None):
    """One ``train_val/<city>`` of the MSLS layout at real UTM magnitudes:
    ``n_db`` database frames 10 m apart along a road, in sequences of 16
    frames, and ``n_q`` query frames within a few metres of the first
    ``n_q`` of them (so the far database frames are negatives), two of them
    at night and two sideways, one database panorama.  Returns the root."""
    rng = np.random.default_rng(seed)
    origin = np.array([rng.uniform(3e5, 7e5), rng.uniform(4e6, 6e6)])
    db = origin + np.stack([np.arange(n_db) * 10.0, rng.uniform(-1, 1, n_db)], 1)
    q = db[:n_q] + rng.uniform(-4, 4, (n_q, 2))
    for name, utm, n in (("database", db, n_db), ("query", q, n_q)):
        night, sideways, pano = np.zeros(n, bool), np.zeros(n, bool), np.zeros(n, bool)
        if name == "query":
            night[[1, 5]] = True
            sideways[[2, 9]] = True
        else:
            pano[n // 2] = True
        write_msls_split(os.path.join(root, "train_val", city, name),
                         [f"{city}_{name[0]}{i:04d}" for i in range(n)], utm,
                         [f"{city}_{name[0]}s{i // 16}" for i in range(n)],
                         np.arange(n) % 16, night, sideways, pano,
                         image_size=image_size, seed=seed + len(name))
    return root


def manifest_state_dict(name):
    """A torch state dict with the keys, shapes and dtypes of
    ``tests/manifests/<name>.json``, values drawn as
    tests/test_convert_manifests.py::load_state_dict draws them (small
    normal values, positive running variances, int64 zeros)."""
    import torch

    with open(os.path.join(MANIFESTS, f"{name}.json")) as f:
        man = json.load(f)
    rng = np.random.default_rng(0)
    sd = {}
    for k, meta in man.items():
        shape = tuple(meta["shape"])
        if meta["dtype"] == "int64":
            arr = np.zeros(shape, np.int64)
        else:
            arr = 0.05 * rng.standard_normal(shape)
            if k.endswith("running_var"):
                arr = np.abs(arr) + 1.0
            arr = arr.astype(np.float32)
        sd[k] = torch.from_numpy(arr)
    return sd
