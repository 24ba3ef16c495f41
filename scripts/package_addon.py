#!/usr/bin/env python3
"""Package the Blender addon as an installable zip.

Layout follows the Blender 4.2 extension spec (the analogue of the
reference's wheel-in-addon layout, /root/reference/build_wheel.sh):

    blender_manifest.toml     <- at the archive ROOT (Blender's extension
                                 installer only looks there)
    __init__.py               <- generated shim: bl_info + register()
    polychase_tpu/...         <- the full engine package, including
                                 polychase_tpu.blender_addon

The shim puts its own directory on sys.path so ``import polychase_tpu``
resolves to the vendored copy, then delegates to
``polychase_tpu.blender_addon``.

Usage: python scripts/package_addon.py [out.zip]
"""

import pathlib
import sys
import zipfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "polychase_tpu"
SKIP_DIRS = {"__pycache__"}

SHIM = '''\
"""Polychase Blender add-on (generated loader shim)."""

import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
if _here not in sys.path:
    sys.path.insert(0, _here)

from polychase_tpu.blender_addon import bl_info  # noqa: E402,F401
from polychase_tpu.blender_addon import register, unregister  # noqa: E402,F401
'''


def want(path: pathlib.Path) -> bool:
    if any(part in SKIP_DIRS for part in path.parts):
        return False
    return path.suffix in (".py", ".so", ".cc", ".md")


def main() -> int:
    out = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                       else ROOT / "polychase_blender_addon.zip")
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("__init__.py", SHIM)
        manifest = PKG / "blender_addon" / "blender_manifest.toml"
        if manifest.exists():
            zf.write(manifest, "blender_manifest.toml")
        for f in sorted(PKG.rglob("*")):
            if f.is_file() and want(f) and f != manifest:
                zf.write(
                    f,
                    str(pathlib.Path("polychase_tpu") / f.relative_to(PKG)),
                )
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
