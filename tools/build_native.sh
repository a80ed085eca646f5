#!/bin/sh
# Build the airdos_native CPython extension in place:
#
#     sh tools/build_native.sh
#
# The result is not committed (.gitignore).  It compiles for the generic
# x86-64 target, so one build runs on any host of that architecture.  It
# links to a temporary name and renames it into place, so concurrent builds
# (parallel test workers) never load a half-written library.
set -e
cd "$(dirname "$0")/.."
PY=${PYTHON:-python}
PY_INC=$($PY -c "import sysconfig; print(sysconfig.get_paths()['include'])")
NP_INC=$($PY -c "import numpy; print(numpy.get_include())")
EXT_SUFFIX=$($PY -c "import sysconfig; print(sysconfig.get_config_var('EXT_SUFFIX'))")
OUT="airdos_tpu/native/airdos_native${EXT_SUFFIX}"
TMP="${OUT}.tmp.$$"
trap 'rm -f "$TMP"' EXIT
g++ -O3 -shared -fPIC -std=c++17 \
    -I"$PY_INC" -I"$NP_INC" \
    airdos_tpu/native/airdos_native.cpp \
    -o "$TMP"
mv -f "$TMP" "$OUT"
echo "built $OUT"
