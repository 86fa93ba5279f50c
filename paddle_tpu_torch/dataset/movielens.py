"""MovieLens ratings (reference v2/dataset/movielens.py) — recommender book
test: (user, gender, age, job, movie, category, title) -> rating.

Real data is the ml-1m.zip archive (reference movielens.py:24 URL/md5):
users.dat / movies.dat / ratings.dat parsed straight out of the zip with
the reference's field encodings (age mapped to band index, genres to
category ids, 90/10 train/test split by rating index).  Fallbacks: legacy
pkl cache, then the deterministic synthetic surrogate.

The port of ``paddle_tpu/dataset/movielens.py``: the same readers, the same
synthetic samples in the same order, and the same parser, reading
the archive only when it is already in the cache (``common.local``:
the md5-verified original, or a provenance-marked sliver); nothing
is fetched."""

from __future__ import annotations

import re
import zipfile

import numpy as np

from . import common
from .common import DATA_MODE, has_cached, load_cached, synthetic_rng

URL = "https://files.grouplens.org/datasets/movielens/ml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"

USER_COUNT = 6040
MOVIE_COUNT = 3952
CATEGORY_COUNT = 18
AGE_BANDS = 7
JOB_COUNT = 21
TITLE_DICT = 1024

# the ml-1m age codes in order -> band index (reference movielens.py:104)
_AGES = [1, 18, 25, 35, 45, 50, 56]

_CATEGORIES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]

_title_rx = re.compile(r"[a-z0-9']+")


def _title_ids(title: str):
    """Hash title tokens into the fixed TITLE_DICT id space (the reference
    builds a corpus dict; a stable hash keeps the loader single-pass)."""
    import zlib

    toks = _title_rx.findall(title.lower())
    ids = [zlib.crc32(t.encode()) % TITLE_DICT for t in toks] or [0]
    return np.asarray(ids, np.int64)


_parse_cache: dict = {}


def parse_ml1m(path: str):
    """-> list of (user, gender, age_band, job, movie, cats, title_ids,
    rating) samples in a seed-fixed shuffled order (the reference splits
    train/test randomly per rating; a contiguous split would put only
    unseen users in test).  Memoized per path — multi-epoch readers must
    not re-decode the 1M-rating archive every pass."""
    cached = _parse_cache.get(path)
    if cached is not None:
        return cached
    users, movies = {}, {}
    with zipfile.ZipFile(path) as z:
        with z.open("ml-1m/users.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                uid, gender, age, job, _zip = line.strip().split("::")
                users[int(uid)] = (0 if gender == "M" else 1,
                                   _AGES.index(int(age)), int(job))
        with z.open("ml-1m/movies.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                mid, title, genres = line.strip().split("::")
                cats = np.asarray(
                    sorted(_CATEGORIES.index(g) for g in genres.split("|")
                           if g in _CATEGORIES) or [0], np.int64)
                movies[int(mid)] = (cats, _title_ids(title))
        samples = []
        with z.open("ml-1m/ratings.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                uid, mid, rating, _ts = line.strip().split("::")
                uid, mid = int(uid), int(mid)
                if uid not in users or mid not in movies:
                    continue
                gender, age, job = users[uid]
                cats, title = movies[mid]
                samples.append((uid - 1, gender, age, job, mid - 1, cats,
                                title, float(rating)))
    order = np.random.RandomState(0).permutation(len(samples))
    samples = [samples[i] for i in order]
    _parse_cache[path] = samples
    return samples


def max_user_id():
    return USER_COUNT


def max_movie_id():
    return MOVIE_COUNT


def max_job_id():
    return JOB_COUNT - 1


def _reader(n, seed, fname, split):
    def reader():
        path = common.local(URL, "movielens", MD5)
        if path is not None:
            DATA_MODE["movielens"] = "real"
            samples = parse_ml1m(path)
            cut = int(len(samples) * 0.9)  # reference 90/10 split
            part = samples[:cut] if split == "train" else samples[cut:]
            for s in part:
                yield s
            return
        if has_cached("movielens", fname):
            DATA_MODE["movielens"] = "cache"
            for s in load_cached("movielens", fname):
                yield tuple(s)
            return
        DATA_MODE["movielens"] = "synthetic"
        rng = synthetic_rng("movielens", seed)
        # rating correlates with (user+movie) parity band → learnable signal
        for _ in range(n):
            u = rng.randint(0, USER_COUNT)
            m = rng.randint(0, MOVIE_COUNT)
            gender = rng.randint(0, 2)
            age = rng.randint(0, AGE_BANDS)
            job = rng.randint(0, JOB_COUNT)
            ncat = rng.randint(1, 4)
            cats = rng.randint(0, CATEGORY_COUNT, ncat).astype(np.int64)
            tlen = rng.randint(2, 6)
            title = rng.randint(0, TITLE_DICT, tlen).astype(np.int64)
            rating = float((u % 5 + m % 5) % 5 + 1)
            yield (u, gender, age, job, m, cats, title, rating)

    return reader


def train(n=4096):
    return _reader(n, 0, "train.pkl", "train")


def test(n=512):
    return _reader(n, 1, "test.pkl", "test")


def convert(path):
    """Write train/test as RecordIO shards (reference
    v2/dataset/movielens.py:237)."""
    from . import common

    common.convert(path, train(), 1000, "movielens_train")
    common.convert(path, test(), 1000, "movielens_test")
