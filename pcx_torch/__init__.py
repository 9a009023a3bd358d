"""pcx_torch — the PyTorch / CUDA port of pcx (Photonic Crystals on XLA).

The single-k-point solve of pcx (``KPointSolver.solve``, with every solver
of pcx: the LOBPCG variants, Davidson and Jacobi-Davidson), the band sweep
(``bandgap``), its production runner (``python -m pcx_torch.run_sweep``
under ``pcx_torch.supervisor``), the command-line launcher (``python -m
pcx_torch``) and the eigensolver library (``pcx_torch.solvers``) on one
NVIDIA H100, for every dielectric of pcx:
complex64 iterate, complex128 refine and validation, and the three Pallas
TPU kernels of that path rewritten as CUDA C++ for sm_90a
(``pcx_torch.kernels``).  The JAX package ``pcx`` stays the reference; this
package imports torch and numpy and never ``jax`` or ``pcx``.

Numerics: importing the package turns TF32 off for float32 matmuls and
convolutions and asks for "highest" float32 matmul precision.  A
reduced-precision DFT raises the LOBPCG residual floor about 100x and
breeds phantom Ritz values (see ``pcx/operators/dft.py``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
