#!/bin/sh
# Build the native ingest library. AVX2 used when the host supports it.
set -e
cd "$(dirname "$0")"
CXX=${CXX:-g++}
FLAGS="-O3 -shared -fPIC -std=c++17 -Wall"
if ${CXX} -mavx2 -dM -E - </dev/null 2>/dev/null | grep -q __AVX2__; then
    FLAGS="$FLAGS -mavx2"
fi
# compile under a temporary name and rename: a concurrent process never
# loads a half-written library
TMP="libt2ingest.so.$$.tmp"
trap 'rm -f "$TMP"' EXIT
${CXX} ${FLAGS} ingest.cpp -o "$TMP"
mv -f "$TMP" libt2ingest.so
echo "built $(pwd)/libt2ingest.so"
