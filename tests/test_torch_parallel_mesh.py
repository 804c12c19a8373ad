"""The parallel layer's data axis against the JAX package: the ``Loader``'s
``host_shard`` slices (each rank's contiguous share of the same seeded
shuffle) and the FSDP placement rule (``fsdp_param_shardings``) on the
same U-Net. The mesh itself and its collectives are held on real gloo
worlds in ``test_torch_parallel_ranks.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from flocoder_tpu.data import datasets as jax_datasets
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.parallel.mesh import fsdp_param_shardings as jax_fsdp_shardings
from flocoder_torch.data.datasets import Loader
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.parallel import mesh as pm
from flocoder_torch.training.checkpoint import UNET_PREFIXES, _entries


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Items:
    """Latent-like items whose value is their index: the batches show the
    order each loader serves."""
    n_classes = 0

    def __len__(self):
        return 23

    def get(self, i, rng):
        return np.full((2,), i, np.float32), np.int32(0)


@pytest.mark.parametrize("shuffle", [True, False])
def test_host_shard_matches_jax(shuffle):
    """For 2 hosts, each rank's batches over two epochs are the JAX
    ``Loader``'s with the same ``host_shard``, and together the ranks serve
    disjoint items of one shuffle."""
    seen = []
    for rank in range(2):
        kw = dict(num_workers=2, seed=3, shuffle=shuffle, host_shard=(rank, 2))
        ours, ref = Loader(_Items(), 4, **kw), jax_datasets.Loader(_Items(), 4, prefetch=1, **kw)
        assert len(ours) == len(ref) == 23 // 2 // 4
        for _ in range(2):
            a = [b["target"][:, 0] for b in ours]
            b = [b["target"][:, 0] for b in ref]
            assert len(a) == len(b) == 2
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        seen.append(np.concatenate(a))
    assert not set(seen[0]) & set(seen[1])


def test_fsdp_rule_matches_jax():
    """The port's placement of each U-Net parameter is the JAX rule's on the
    same tensor in flax layout (its largest dim that the rank count divides,
    ``min_size`` lowered so that several shard), mapped to the torch dim."""
    unet = init_params(Unet(dim=8, channels=4, dim_mults=(1, 2), n_classes=3),
                       torch.Generator().manual_seed(0))
    jm = JaxUnet(dim=8, channels=4, dim_mults=(1, 2), n_classes=3)
    cond = {"class_cond": jnp.zeros((1,), jnp.int32), "mask_cond": None}
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                          jnp.zeros((1,)), cond)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    ref = jax_fsdp_shardings(mesh, {"model": tree}, min_size=64)
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): s.spec
                for path, s in jax.tree_util.tree_flatten_with_path(
                    ref, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    ours = pm.fsdp_param_shardings(unet, 2, min_size=64)
    entries = _entries(unet, UNET_PREFIXES)
    perm = {"conv": (2, 3, 1, 0), "dense": (1, 0)}
    n_sharded = 0
    for name, dim in ours.items():
        jkey, kind = entries[name]
        spec = tuple(flat_ref[jkey])
        want = next((i for i, a in enumerate(spec) if a == "data"), None)
        got = None if dim is None else perm.get(kind, tuple(range(8))).index(dim)
        assert got == want, (name, jkey, spec, dim)
        n_sharded += dim is not None
    assert 0 < n_sharded < len(ours)
