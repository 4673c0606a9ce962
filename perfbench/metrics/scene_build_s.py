"""Seconds of the program's scene build (host mesh, BVH build, tables,
upload), on the host clock around examples.build."""


def read(rec):
    return rec.get("scene_build_s")
