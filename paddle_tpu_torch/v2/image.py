"""v2 image utilities, the port of ``paddle_tpu/v2/image.py`` (reference
python/paddle/v2/image.py): the book image
models' load/augment pipeline — resize_short, center/random crop,
left-right flip, CHW conversion, and the simple_transform composition.
PIL-backed (the reference used cv2); arrays are HWC uint8/float in, the
transform chain ends CHW float32.  PIL is imported inside the functions
that use it, so ``import paddle_tpu_torch.v2`` works without it."""

from __future__ import annotations

import numpy as np


def load_image_bytes(data: bytes, is_color: bool = True) -> np.ndarray:
    """Decode encoded image bytes -> HWC uint8 (H W for grayscale)."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(file_path: str, is_color: bool = True) -> np.ndarray:
    with open(file_path, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Scale so the SHORT side equals `size`, keeping aspect ratio.
    uint8 images resize as images; float images resize per channel in
    float32 (no value truncation)."""
    from PIL import Image

    h, w = im.shape[:2]
    if h > w:
        new_w, new_h = size, int(round(h * size / w))
    else:
        new_w, new_h = int(round(w * size / h)), size
    if np.issubdtype(im.dtype, np.floating):
        chans = im[..., None] if im.ndim == 2 else im
        out = np.stack([
            np.asarray(Image.fromarray(
                chans[:, :, c].astype(np.float32), mode="F"
            ).resize((new_w, new_h)))
            for c in range(chans.shape[2])], axis=-1)
        return out[:, :, 0] if im.ndim == 2 else out
    mode = "RGB" if im.ndim == 3 else "L"
    out = Image.fromarray(im.astype(np.uint8), mode=mode).resize(
        (new_w, new_h))
    return np.asarray(out)


def to_chw(im: np.ndarray, order=(2, 0, 1)) -> np.ndarray:
    """HWC -> CHW (grayscale gains a leading channel axis)."""
    if im.ndim == 2:
        im = im[:, :, None]
    return im.transpose(order)


def center_crop(im: np.ndarray, size: int, is_color: bool = True):
    h, w = im.shape[:2]
    h0 = max((h - size) // 2, 0)
    w0 = max((w - size) // 2, 0)
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im: np.ndarray, size: int, is_color: bool = True, rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    h0 = rng.randint(0, max(h - size, 0) + 1)
    w0 = rng.randint(0, max(w - size, 0) + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im: np.ndarray) -> np.ndarray:
    return im[:, ::-1]


def simple_transform(im: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, is_color: bool = True, mean=None,
                     rng=None) -> np.ndarray:
    """The reference's standard pipeline: resize_short -> crop (random +
    maybe-flip when training, center at eval) -> CHW float32 -> -mean."""
    rng = rng or np.random
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if rng.randint(2) == 0:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    im = to_chw(im).astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1:  # per-channel
            mean = mean[:, None, None]
        im = im - mean
    return im


def load_and_transform(filename: str, resize_size: int, crop_size: int,
                       is_train: bool, is_color: bool = True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file: str, dataset_name: str,
                          img2label: dict, num_per_batch: int = 1024):
    """Pack a tar of images into pickled (data, label) batch files next to
    the tar (reference image.py batch_images_from_tar); returns the
    meta-file path listing the batches."""
    import os
    import pickle
    import tarfile

    out_path = f"{data_file}_{dataset_name}_batch"
    os.makedirs(out_path, exist_ok=True)
    data, labels, paths = [], [], []
    n = 0
    with tarfile.open(data_file) as tf:
        for m in tf.getmembers():
            if not m.isfile() or m.name not in img2label:
                continue
            data.append(tf.extractfile(m).read())
            labels.append(img2label[m.name])
            if len(data) == num_per_batch:
                p = os.path.join(out_path, f"batch_{n}")
                with open(p, "wb") as f:
                    pickle.dump({"data": data, "label": labels}, f)
                paths.append(p)
                data, labels = [], []
                n += 1
    if data:
        p = os.path.join(out_path, f"batch_{n}")
        with open(p, "wb") as f:
            pickle.dump({"data": data, "label": labels}, f)
        paths.append(p)
    meta = os.path.join(out_path, "batches.meta")
    with open(meta, "w") as f:
        f.write("\n".join(paths) + "\n")
    return meta
