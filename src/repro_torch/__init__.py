"""repro_torch: the Palgol system ported to PyTorch and CUDA on Hopper.

A second package beside the JAX reference ``repro``: same module layout and
names, torch tensors with an explicit ``device=`` (``"cuda"`` by default),
and hand-written CUDA kernels (``repro_torch/csrc``) where the JAX package
has Pallas TPU kernels. It imports neither ``jax`` nor ``repro``.

    from repro_torch.core import compile_program
    from repro_torch.graph import generators as G
    from repro_torch.pregel import run_bsp
"""
