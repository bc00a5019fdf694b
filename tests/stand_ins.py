"""Stand-ins for files no test can download: image trees in the CUB200,
Cars196 and SOP layouts, and torch state dicts in the key and shape sets of
the reference's ImageNet checkpoints (tests/manifests/*.json).

Everything is drawn from a seed with numpy.  ``chip_smoke.py`` loads this
module by its path too, so it imports nothing of JAX and imports PIL and
torch inside its functions.
"""

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
