#!/bin/sh
# Build the native codec library. Called automatically on first use of
# filodb_tpu_torch.memory.native; idempotent. The library is written under a
# temporary name and renamed into place, so concurrent builds never expose
# a half-written file to a process that is loading it.
set -e
cd "$(dirname "$0")"
g++ -O3 -march=native -shared -fPIC -o "libfilodb_codecs.so.$$" codecs.cpp
mv -f "libfilodb_codecs.so.$$" libfilodb_codecs.so
echo "built $(pwd)/libfilodb_codecs.so"
