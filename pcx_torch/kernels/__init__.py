"""The port's hand-written CUDA kernels (sm_90a), one per Pallas TPU kernel
of ``pcx/operators/pallas_kernels.py`` and four of the port's own:

* K1 ``resid_precond`` — replaces ``fused_resid_precond``;
* K2 ``axis_dft``      — replaces ``axis_dft_pairs`` (an FFT on the card,
  where the TPU contracts with the dense DFT matrix);
* K3 ``gram9``         — replaces ``fused_gram9_pairs`` (``rr_gram="pallas"``);
* K4 ``block_combine`` — replaces no Pallas kernel: the dense algebra's block
  combinations (JAX leaves them to XLA), one pass over blocks where they lie;
* K5 ``op_blocks``     — replaces no Pallas kernel: the operator's curl and
  penalty block multiplies on either side of K2 (JAX leaves them to XLA),
  two entry points ``op_pre`` and ``op_post``, one pass each;
* K6 ``gram_chunks``   — replaces no Pallas kernel: the dense algebra's
  Grams (JAX leaves them to XLA), chunked float32 partials summed in
  complex128, one pass over blocks where they lie;
* K7 ``crossdof_apply`` — replaces no Pallas kernel: the cross-DoF
  eps^{-1} (JAX leaves its rolls to XLA), one pass that reads each field
  once, the stencils' intermediates in shared memory and registers.

Every kernel takes the lanes of the lockstep k-point batch in one launch:
K1, K3 and K6 on a leading lane axis, K2 in its batch B, K4 and K5 on
blocks and symbols with a lane axis, K7 on fields with any leading axes.

Each wrapper counts its launches in a plain integer attribute
(``resid_precond.launches``), incremented only where the kernel launches.
K1's, K3's and K6's counts are lane-launches: one per lane served, so a
launch over L lanes adds L (a reader reckons one lane's bytes per count);
K2's, K4's, K5's and K7's count launches.  K2 also counts them by its batch B
(``axis_dft.launches_by_batch``, 3 m in an operator apply on m columns,
3 L m over L lanes) and adds each launch's resident blocks per SM to the
program counter ``k2.sm_blocks``; K3, K4, K5, K6 and K7 add the bytes of
each launch to the program counters ``k3.bytes``, ``k4.bytes``,
``k5.bytes``, ``gram.bytes`` and ``k7.bytes`` (K7's launches with the
pairs 13 or 23 to ``k7.iaxis_bytes`` too).
``reset_launches`` also resets the program's other counters and span
totals (``pcx_torch.tracing``).
"""

from pcx_torch import tracing
from pcx_torch.kernels.axis_dft import axis_dft
from pcx_torch.kernels.block_combine import block_combine
from pcx_torch.kernels.crossdof import crossdof_apply
from pcx_torch.kernels.gram9 import gram9
from pcx_torch.kernels.gram_chunks import gram_chunks
from pcx_torch.kernels.op_blocks import op_post, op_pre
from pcx_torch.kernels.resid_precond import resid_precond

WRAPPERS = (resid_precond, axis_dft, gram9, block_combine, op_pre, op_post,
            gram_chunks, crossdof_apply)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    axis_dft.launches_by_batch = {}
    tracing.reset()


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def k2_launches_by_batch() -> dict:
    """K2's launches since the last reset, by batch B, in ascending B."""
    return dict(sorted(axis_dft.launches_by_batch.items()))
