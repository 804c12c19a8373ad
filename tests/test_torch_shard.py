"""The port's packed latent shards (flocoder_torch.data.shard over its own
csrc/fcloader.cpp) against the JAX package's (flocoder_tpu.data.shard).

Files written by either package's ``ShardWriter`` from the same records,
plain and with the inpainting triplet's ``extra_fields``, by ``add`` and by
``add_batch``, are byte-equal; each package reads the other's file exactly;
the port's native gather equals its memmap twin bit for bit (a batch of
repeated indices large enough for the threaded gather); a ``Loader`` over
the port's ``ShardDataset`` gives the JAX ``Loader``'s batches for the same
seed exactly; and the port's library is built under
``flocoder_torch/build/``, never ``native/``. The JAX readers here take
their numpy path, so that no test of this file builds the JAX package's
library.
"""
import os

import numpy as np
import pytest

from flocoder_torch.data import shard as ts
from flocoder_torch.data.datasets import Loader
from flocoder_torch.ops.kernels.build import BUILD_DIR
from flocoder_tpu.data import datasets as jdatasets
from flocoder_tpu.data import shard as js

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, N = (4, 4, 3), 40
EXTRAS = {"source_latents": SHAPE, "mask_pixels": (8, 8, 1)}


@pytest.fixture(autouse=True)
def _jax_reads_with_numpy(monkeypatch):
    """The JAX module builds its library on first use; its numpy path needs
    none."""
    monkeypatch.setattr(js, "_lib", False)


def _records(seed=0, n=N):
    rng = np.random.default_rng(seed)
    recs = rng.normal(size=(n,) + SHAPE).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    extras = {"source_latents": rng.normal(size=(n,) + SHAPE).astype(np.float32),
              "mask_pixels": (rng.random((n, 8, 8, 1)) > 0.5).astype(np.float32)}
    return recs, labels, extras


def _write(mod, path, triplet, seed=0):
    recs, labels, extras = _records(seed)
    w = mod.ShardWriter(str(path), SHAPE, EXTRAS if triplet else None)
    half = N // 2
    w.add_batch(recs[:half], labels[:half],
                {k: v[:half] for k, v in extras.items()} if triplet else None)
    for i in range(half, N):
        w.add(recs[i], int(labels[i]), {k: v[i] for k, v in extras.items()} if triplet else None)
    return w.close()


@pytest.mark.parametrize("triplet", [False, True], ids=["plain", "triplet"])
def test_files_are_byte_equal_across_packages(tmp_path, triplet):
    ours = _write(ts, tmp_path / "ours.fcshard", triplet)
    ref = _write(js, tmp_path / "ref.fcshard", triplet)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(ours + ".payload.tmp")


@pytest.mark.parametrize("triplet", [False, True], ids=["plain", "triplet"])
def test_each_package_reads_the_others_file(tmp_path, triplet):
    recs, labels, extras = _records()
    idx = np.array([5, 0, 39, 5, 17])
    for writer, reader in ((js, ts), (ts, js)):
        path = _write(writer, tmp_path / f"{writer.__name__}.fcshard", triplet)
        fields, got_labels = reader.ShardReader(path).gather(idx)
        np.testing.assert_array_equal(got_labels, labels[idx])
        np.testing.assert_array_equal(fields["target"], recs[idx])
        assert set(fields) == {"target", *(EXTRAS if triplet else ())}
        for k in EXTRAS if triplet else ():
            np.testing.assert_array_equal(fields[k], extras[k][idx])


def test_native_gather_equals_the_memmap_twin(tmp_path):
    path = _write(ts, tmp_path / "s.fcshard", True)
    native, plain = ts.ShardReader(path), ts.ShardReader(path, use_native=False)
    assert native.is_native and not plain.is_native
    idx = np.random.default_rng(1).integers(0, N, 200)       # ≥ 64: the threaded gather
    for n_threads in (1, 4):
        a, la = native.gather(idx, n_threads=n_threads)
        b, lb = plain.gather(idx)
        assert la.tobytes() == lb.tobytes()
        assert all(a[k].tobytes() == b[k].tobytes() for k in b)
    with pytest.raises(IndexError):
        native.gather(np.array([N]))
    native.close()


@pytest.mark.parametrize("triplet", [False, True], ids=["plain", "triplet"])
def test_loader_batches_equal_the_jax_loaders(tmp_path, triplet):
    path = _write(ts, tmp_path / "s.fcshard", triplet)
    ours = Loader(ts.ShardDataset(path, n_classes=5), batch_size=8, num_workers=2, seed=3)
    ref = jdatasets.Loader(js.ShardDataset(path, n_classes=5), batch_size=8, shuffle=True,
                           num_workers=2, seed=3)
    for _ in range(2):                                    # two epochs: seed + epoch
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == N // 8
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    ds = ts.ShardDataset(path)
    item, label = ds.get(7, None)
    recs, labels, _ = _records()
    np.testing.assert_array_equal(item["target_latents"] if triplet else item, recs[7])
    assert label == labels[7]


def test_library_is_built_under_the_ports_build_dir():
    path = os.path.realpath(ts.library_file())
    assert path.startswith(os.path.realpath(BUILD_DIR) + os.sep)
    assert os.path.basename(path).startswith("libfcloader_")
    assert not path.startswith(os.path.realpath(os.path.join(ROOT, "native")))
