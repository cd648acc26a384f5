"""Sharding rules as logical specs and DTensor placements."""
