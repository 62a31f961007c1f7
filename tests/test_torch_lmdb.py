"""The port's LMDB reader, writer and native walker against the JAX package's.

- `write_lmdb` writes the JAX writer's bytes; the port's `LMDBReader` reads
  every tree the JAX reader reads (empty, one leaf, branch levels, overflow
  values) to the same items, keys, point lookups, stat and entry table,
  and refuses garbage and a root past the file's end as it does.
- The native walker's table (every iteration's route in the port) equals
  the pure-Python walk `_walk`, its plain twin.
- `lsun_dataset` against the JAX `lsun_dataset` (TensorFlow) with shuffle
  and flips off, on PNG, JPEG and WebP payloads: within 2e-4/255 of the
  [0, 1] scale (the gap between TF's and `jax.image.resize`'s antialiased
  bicubic). With them on: deterministic by seed, each image once an epoch.
"""

import io

import numpy as np
import pytest
import torch

from dpm_solver_tpu.utils import lmdb as jlmdb
from dpm_solver_tpu_torch.utils.lmdb import LMDBError, LMDBReader, write_lmdb

RESIZE_BOUND = 2e-4 / 255


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the host loops here: the suite runs several
    workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees():
    rng = np.random.default_rng(0)
    return {
        "empty": {},
        "single_leaf": {f"k{i:03d}".encode(): f"value-{i}".encode() for i in range(20)},
        "branch": {f"{i:08d}".encode(): bytes(rng.integers(0, 256, 40, dtype=np.uint8))
                   for i in rng.choice(10 ** 7, 2000, replace=False)},
        "overflow": {b"small": b"x" * 10,
                     b"one-page": bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
                     b"many-pages": bytes(rng.integers(0, 256, 100_000, dtype=np.uint8)),
                     **{f"k{i:05d}".encode(): bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
                        for i, n in enumerate(rng.integers(1, 300, 1500))}},
    }


@pytest.mark.parametrize("tree", ["empty", "single_leaf", "branch", "overflow"])
def test_reader_matches_jax(tree, tmp_path):
    items = _trees()[tree]
    path = write_lmdb(str(tmp_path / "port"), items.items())
    jpath = jlmdb.write_lmdb(str(tmp_path / "jax"), items.items())
    assert open(path, "rb").read() == open(jpath, "rb").read()
    with LMDBReader(path) as r, jlmdb.LMDBReader(path) as j:
        assert len(r) == len(j) == len(items)
        assert r.stat() == j.stat()
        assert r.keys() == j.keys() == sorted(items)
        got = [(bytes(k), bytes(v)) for k, v in r.items()]
        assert got == [(bytes(k), bytes(v)) for k, v in j.items()] == sorted(items.items())
        jt = j.entry_table()
        np.testing.assert_array_equal(r.entry_table(), jt if jt is not None else np.empty((0, 4)))
        # the native table against the plain twin, the pure-Python walk
        root = r._main[7]
        walked = list(r._walk(root)) if root != jlmdb.P_INVALID else []
        assert [(bytes(k), bytes(v)) for k, v in walked] == got
        for k in list(items)[::97] + [b"~~~~", b"missing"]:
            assert r.get(k) == j.get(k)


def test_reader_rejects_garbage(tmp_path):
    p = tmp_path / "junk.mdb"
    p.write_bytes(b"\x00" * 8192)
    with pytest.raises(LMDBError):
        LMDBReader(str(p))
    with pytest.raises(jlmdb.LMDBError):
        jlmdb.LMDBReader(str(p))


def test_native_walk_rejects_corrupt_tree(tmp_path):
    """A root pointing past the file's end raises instead of reading junk."""
    path = write_lmdb(str(tmp_path / "db"), {b"a": b"1"}.items())
    with LMDBReader(path) as r:
        r._main = list(r._main)
        r._main[7] = 10 ** 6
        with pytest.raises(LMDBError, match="corrupt"):
            r.entry_table()
        with pytest.raises(LMDBError):
            list(r.items())


def test_env_directory_and_context_manager(tmp_path):
    env = tmp_path / "lsun_cat_train_lmdb"
    env.mkdir()
    write_lmdb(str(env), {b"k": b"v"}.items())
    assert (env / "data.mdb").exists()
    with LMDBReader(str(env)) as r:
        assert r.get(b"k") == b"v" and b"k" in r and b"x" not in r
    assert r._buf is None
    r.close()  # idempotent


# ------------------------------------------------------------- lsun_dataset


def _encode(arr, fmt):
    from PIL import Image

    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format=fmt, **({"quality": 90} if fmt == "JPEG" else
                                                  {"lossless": True} if fmt == "WEBP" else {}))
    return bio.getvalue()


def _lsun_env(tmp_path, fmt, n=6, seed=2):
    """An LMDB of `fmt` images of random sizes: smooth fields with a sharp
    edge (bicubic overshoots there) and noise."""
    rng = np.random.default_rng(seed)
    items = {}
    for i in range(n):
        h, w = int(rng.integers(40, 80)), int(rng.integers(40, 80))
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 100 * np.sin(xx / 7.0 + i) * np.cos(yy / 5.0)
        base[:, w // 2:] = 255 * (i % 2)
        arr = np.clip(base[..., None] + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
        items[f"img{i}".encode()] = _encode(arr, fmt)
    env = tmp_path / f"bedroom_{fmt.lower()}_lmdb"
    write_lmdb(str(env), items.items())
    return str(env)


@pytest.mark.parametrize("fmt", ["PNG", "JPEG", "WEBP"])
def test_lsun_dataset_matches_jax(fmt, tmp_path):
    """Shuffle and flips off: the JAX pipeline's batches, in order. PNG and
    JPEG payloads go through the port's native decoders (JPEG: the same
    libjpeg output as PIL's here, so the same pixels), WebP through PIL."""
    pytest.importorskip("tensorflow")
    from dpm_solver_tpu.data import lsun_dataset as jlsun
    from dpm_solver_tpu.data import numpy_iterator
    from dpm_solver_tpu_torch.data import lsun_dataset

    env = _lsun_env(tmp_path, fmt)
    kw = dict(resolution=32, batch_size=2, centered=True, random_flip=False, shuffle=False,
              repeat=False)
    want = list(numpy_iterator(jlsun(env, **kw)))
    got = list(lsun_dataset(env, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 32, 32, 3) and g.dtype == np.float32
        # centred: [-1, 1] is twice the [0, 1] scale
        assert np.abs(g - w).max() <= 2 * RESIZE_BOUND


def test_lsun_dataset_shuffle_and_flip_by_seed(tmp_path):
    """Shuffled and flipped: the same seed gives the same batches, another
    seed other ones; within an epoch each image comes once (up to a flip)."""
    from dpm_solver_tpu_torch.data import lsun_dataset

    env = _lsun_env(tmp_path, "PNG", n=8)
    plain = np.concatenate(list(lsun_dataset(env, resolution=16, batch_size=8, random_flip=False,
                                             shuffle=False, repeat=False)))

    def epoch(seed):
        it = lsun_dataset(env, resolution=16, batch_size=4, seed=seed)
        return np.concatenate([next(it) for _ in range(2)])

    a, b, c = epoch(3), epoch(3), epoch(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    seen = sorted(int(np.flatnonzero([np.array_equal(x, p) or np.array_equal(x[:, ::-1], p)
                                      for p in plain])[0]) for x in a)
    assert seen == list(range(8))
