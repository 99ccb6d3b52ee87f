"""terastructure_tpu_torch — the PSD/admixture SVI engine in PyTorch + CUDA.

A port of `terastructure_tpu` (JAX + Pallas) to PyTorch on NVIDIA Hopper.
The JAX package stays the reference; module names here mirror it so each
counterpart is easy to find:

    terastructure_tpu.config            -> terastructure_tpu_torch.config
    terastructure_tpu.models.psd        -> terastructure_tpu_torch.models.psd
    terastructure_tpu.data.*            -> terastructure_tpu_torch.data.*
    terastructure_tpu.ops.stats_dense   -> terastructure_tpu_torch.ops.stats_dense
    terastructure_tpu.ops.gather        -> terastructure_tpu_torch.ops.gather
    terastructure_tpu.ops.stats_pallas  -> terastructure_tpu_torch.ops.stats_packed
    terastructure_tpu.ops.fused_step    -> terastructure_tpu_torch.ops.fused_step
    terastructure_tpu.svi.*             -> terastructure_tpu_torch.svi.*
    terastructure_tpu.native            -> terastructure_tpu_torch.native
    terastructure_tpu.io.*              -> terastructure_tpu_torch.io.*
    terastructure_tpu.utils.*           -> terastructure_tpu_torch.utils.*
    terastructure_tpu.viz               -> terastructure_tpu_torch.viz
    terastructure_tpu.cli               -> terastructure_tpu_torch.cli
                                           (`python -m terastructure_tpu_torch.cli`)

The Pallas kernels on the main path are hand-written CUDA C++ under
`csrc/`, built with nvcc for sm_90a at first use (`_build.py`). Every
kernel wrapper runs a plain PyTorch twin when given CPU tensors. The
host ingest core (`native/bedops.cpp`: the .bed translation and the
streaming sampler's row gather) is built with g++ at first use.

This package imports torch and never jax.
"""

__version__ = "0.1.0"

from terastructure_tpu_torch.config import SVIConfig  # noqa: F401
