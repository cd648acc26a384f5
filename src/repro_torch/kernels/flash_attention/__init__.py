"""Causal / full attention on the card (``ops.flash_attention``).

The port of the Pallas kernel ``repro/kernels/flash_attention``; the
kernel is built at its first launch, never at import."""
