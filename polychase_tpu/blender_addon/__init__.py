"""Polychase — Blender add-on for 3D camera/object match-moving.

A from-scratch rebuild of the reference add-on layer
(/root/reference/blender_addon, P1-P16 in SURVEY.md §2.2) on top of the
JAX ``polychase_core`` engine.  Register via Blender's add-on
mechanism; requires Blender ≥ 4.2.
"""

bl_info = {
    "name": "Polychase",
    "author": "polychase_tpu contributors",
    "description": "Camera and object match-moving (JAX-accelerated core)",
    "blender": (4, 2, 0),
    "version": (0, 1, 0),
    "category": "Tracking",
}


def register():
    from . import addon

    addon.register()


def unregister():
    from . import addon

    addon.unregister()
