"""The benchmark's plain reference: a path tracer in plain PyTorch and
NumPy that imports nothing of the program under test. It rebuilds each
scene from its configuration (meshes, texture, BVH) and follows the
estimator the program is specified to compute (PTSharp's integrator:
Fresnel coin, cone-sampled gloss, cosine-weighted diffuse bounces, NEE to
sphere lights by a disc sample and a coverage factor), drawing its random
numbers from the threefry-2x32 counter scheme of jax.random, so that given
the same keys it takes the same decisions lane by lane."""
