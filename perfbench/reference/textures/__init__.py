"""Procedural textures of the configurations, one module a kind, found by
the name a configuration's texture gives: make(**params) -> (H, W, 3)
float32 linear RGB."""
