"""s2t_tpu_torch — the PyTorch/CUDA port of s2t_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``s2t_tpu``: the same file layout
and names, PyTorch idiom inside, and every Pallas kernel on a ported path
replaced by a kernel written by hand for ``sm_90a`` (``csrc/``).  It imports
torch and numpy only, never jax or s2t_tpu.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
