"""Sharded serving: the port's ``sampler`` on 2 gloo ranks (each
integrating RK4 with CFG and decoding its 4 rows of a batch of 8 from its
own noise, ``rank_seed``) gathers on every rank exactly what one process
computes when it is given each rank's noise stream and rows: with the
class condition given, and with the 10-column class grid, which is batch
rank 0's draw on every rank. A batch that does not split runs whole.
"""
import numpy as np
import pytest
import torch

from flocoder_torch.evaluation import sampler
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models.layers import init_params
from test_torch_flow_step import C, NC, S, _models
from test_torch_parallel_flow import unet_models
from test_torch_parallel_ranks import run_ranks, serving_rank
from test_torch_vqgan_step import KW

N_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both conditions and the batch of 3, served on 2 ranks in one world."""
    unet, _, _ = _models(seed=61)
    codec = init_params(tcodecs.VQVAE(**KW), torch.Generator().manual_seed(62)).eval()
    models = {**unet_models(unet), "latent_shape": (S, S, C)}
    codec_models = {"codec_cls": tcodecs.VQVAE, "codec_kw": KW, "codec_sd": codec.state_dict()}
    conds = [np.arange(8) % NC, None]
    res = run_ranks(serving_rank, 2, tmp_path_factory.mktemp("serve"), models, codec_models,
                    NC, N_STEPS, conds, 0)
    return dict(unet=unet, codec=codec, conds=conds, res=res)


@pytest.mark.parametrize("given", [True, False], ids=["class_cond", "class_grid"])
def test_two_rank_serving_equals_one_process_per_rank_noise(served, given):
    unet, codec, res = served["unet"], served["codec"], served["res"]
    i = 0 if given else 1
    cond = served["conds"][i]
    runs = [r["runs"][i] for r in res]
    np.testing.assert_array_equal(runs[0]["images"], runs[1]["images"])
    lats, imgs, grid = [], [], None
    for r in range(2):
        g = torch.Generator().manual_seed(res[r]["seed"])
        if not given:
            cols = torch.randint(0, NC, (10,), generator=g)    # each rank draws a grid
            grid = cols.repeat(1)[:8] if r == 0 else grid      # and takes rank 0's
        rows = torch.as_tensor(cond[4 * r:4 * r + 4]) if given else grid[4 * r:4 * r + 4]
        lat, dec, nfe = sampler(unet, codec, g, batch_size=4, n_steps=N_STEPS,
                                cond={"class_cond": rows.long()}, n_classes=NC,
                                latent_shape=(S, S, C))
        lats.append(lat.numpy())
        imgs.append(dec.numpy())
    assert runs[0]["nfe"] == nfe and runs[0]["images"].shape == (8, 32, 32, 3)
    np.testing.assert_array_equal(runs[0]["latents"], np.concatenate(lats))
    np.testing.assert_array_equal(runs[0]["images"], np.concatenate(imgs))
    if not given:
        return
    for r in range(2):              # 3 rows do not split: each rank serves them all
        g = torch.Generator().manual_seed(res[r]["seed"])
        odd = sampler(unet, codec, g, batch_size=3, n_steps=N_STEPS, n_classes=NC,
                      latent_shape=(S, S, C))[1]
        np.testing.assert_array_equal(res[r]["odd"], odd.numpy())
