"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit); the run prints the card's own limit beside
every share of them."""

HBM_BYTES_S = 3.35e12      # device memory, bytes/s
F32_FLOPS = 67e12          # IEEE float32 outside the tensor cores, FLOP/s
