"""Fourier-space Maxwell operator: symbols, block multiplies, DFT,
dielectric and the penalized operator."""
