"""Procedural meshes of the configurations, one module a kind, found by
the name a configuration's "mesh" gives. Each has make(**params) ->
(v (T, 3, 3), n (T, 3, 3), uv (T, 3, 2)) float32 numpy arrays."""
