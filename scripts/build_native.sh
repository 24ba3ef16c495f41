#!/bin/sh
# Build the native BVH ray caster in place.  The package also builds it
# on first use when g++ is available (polychase_tpu/native/__init__.py);
# this script builds it ahead of time and fails loudly if g++ does.
#
# PORTABLE=1 targets the x86-64-v2 ISA baseline instead of -march=native —
# used by the containerized release build (docker/Dockerfile.linux) so the
# shipped binary runs on any reasonably modern x86-64 host.
set -e
cd "$(dirname "$0")/.."
if [ "${PORTABLE:-0}" = "1" ]; then
    ARCH="-march=x86-64-v2"
else
    ARCH="-march=native"
fi
python -c "from polychase_tpu.native import build_library; print('built', build_library(arch='$ARCH'), '($ARCH)')"
