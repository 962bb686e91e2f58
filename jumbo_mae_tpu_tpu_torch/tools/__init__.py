"""Offline tools over the engine: feature export and the kNN probe."""
