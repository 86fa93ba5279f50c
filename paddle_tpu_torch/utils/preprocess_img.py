"""Image-dataset preprocessing, the port of
``paddle_tpu/utils/preprocess_img.py`` (reference python/paddle/utils/
preprocess_img.py ImageClassificationDatasetCreater + preprocess_util):
walk a `data_path/<label>/*.jpg` tree, resize, split train/test, and
write batch files + a meta file the dataset loaders consume."""

from __future__ import annotations

import os
import pickle
import random

import numpy as np

from ..v2 import image as image_util

__all__ = ["ImageClassificationDatasetCreater", "DatasetCreater"]


class DatasetCreater:
    """preprocess_util.DatasetCreater: base walker producing
    (sample, label) lists from a labeled directory tree."""

    def __init__(self, data_path):
        self.data_path = data_path
        self.train_ratio = 0.8

    def list_images(self):
        classes = sorted(
            d for d in os.listdir(self.data_path)
            if os.path.isdir(os.path.join(self.data_path, d)))
        self.label_set = {c: i for i, c in enumerate(classes)}
        items = []
        for c in classes:
            cdir = os.path.join(self.data_path, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png")):
                    items.append((os.path.join(cdir, fname),
                                  self.label_set[c]))
        return items


class ImageClassificationDatasetCreater(DatasetCreater):
    """preprocess_img.py:78: resize to target_size, pickle batches of
    (image CHW float32, label), write meta {mean, label_set, sizes}."""

    def __init__(self, data_path, target_size, color=True):
        super().__init__(data_path)
        self.target_size = int(target_size)
        self.color = color
        self.num_per_batch = 1024

    def create_batches(self, out_path=None, seed=0):
        items = self.list_images()  # walk BEFORE creating the output dir
        out_path = out_path or os.path.join(self.data_path, "batches")
        os.makedirs(out_path, exist_ok=True)
        rng = random.Random(seed)
        rng.shuffle(items)
        n_train = int(len(items) * self.train_ratio)
        splits = {"train": items[:n_train], "test": items[n_train:]}
        mean_acc, mean_n = None, 0
        meta = {"label_set": self.label_set,
                "target_size": self.target_size, "batches": {}}
        for split, rows in splits.items():
            paths = []
            for bi in range(0, max(len(rows), 1), self.num_per_batch):
                chunk = rows[bi: bi + self.num_per_batch]
                if not chunk:
                    continue
                data, labels = [], []
                for path, label in chunk:
                    im = image_util.load_image(path, is_color=self.color)
                    im = image_util.simple_transform(
                        im, self.target_size, self.target_size,
                        is_train=False, is_color=self.color)
                    data.append(np.asarray(im, np.float32))
                    labels.append(label)
                arr = np.stack(data)
                if split == "train":
                    s = arr.sum(axis=0)
                    mean_acc = s if mean_acc is None else mean_acc + s
                    mean_n += arr.shape[0]
                bpath = os.path.join(out_path,
                                     f"{split}_batch_{bi//self.num_per_batch:03d}")
                with open(bpath, "wb") as f:
                    pickle.dump({"data": arr,
                                 "labels": np.asarray(labels, np.int64)}, f)
                paths.append(bpath)
            meta["batches"][split] = paths
        if mean_n:
            meta["mean"] = (mean_acc / float(mean_n)).astype(np.float32)
        with open(os.path.join(out_path, "meta"), "wb") as f:
            pickle.dump(meta, f)
        return meta
