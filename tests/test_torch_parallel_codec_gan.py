"""Data-parallel codec training, the GAN step: the port's on 2 gloo ranks
against the JAX package's ``_mesh_wrap`` GAN step on a 2-device mesh (the
discriminator's and the codec's gradients, the power-iteration vectors and
the losses ``pmean``ed, the RVQ statistics ``psum``ed), the codec's and
the discriminator's parameters and first moments after the step. Setup,
tolerances and the named mutation (no cross-rank mean) are
``test_torch_parallel_codec.py``'s.
"""
from test_torch_parallel_codec import check_codec_step


def test_two_rank_gan_step_matches_jax_mesh(tmp_path):
    check_codec_step(tmp_path, "gan")
