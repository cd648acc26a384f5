"""Paged-attention decode on the card (``ops.paged_attention``).

The port of the Pallas kernel ``repro/kernels/paged_attention``; the
kernel is built at its first launch, never at import."""
