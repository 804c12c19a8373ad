"""flocoder_torch — the PyTorch/CUDA port of flocoder_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout and names, imports nothing of it (nor
jax), and runs on the CUDA card unless a caller asks for the CPU. The JAX
package stays the reference the port is tested against.
"""
