"""Several cards: process groups over the k axis and the grid axis, the
pencil-decomposed 3-D FFT with its halo rolls, and the grid-sharded solve
(port of ``pcx/parallel``, on ``torch.distributed``)."""

from pcx_torch.parallel import fft, mesh
from pcx_torch.parallel.fft import pencil_fftn, pencil_ifftn, sharded_roll
from pcx_torch.parallel.mesh import (GRID_AXIS, K_AXIS, gather_shards,
                                     init_distributed, local_shard, make_mesh)
