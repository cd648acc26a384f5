"""Mamba1 selective scan on the card (``ops.mamba_scan``).

The port of the Pallas kernel ``repro/kernels/mamba_scan``; the kernel
is built at its first launch, never at import."""
