"""Paged KV cache: the Clock2Q+-managed block pool and the sequence manager."""
