#!/bin/sh
# Build the native partition-set library. Called automatically on first use
# of filodb_tpu_torch.core.native; idempotent. The library is written under a
# temporary name and renamed into place, so concurrent builds never expose
# a half-written file to a process that is loading it.
set -e
cd "$(dirname "$0")"
g++ -O3 -march=native -shared -fPIC -o "libfilodb_partset.so.$$" partset.cpp
mv -f "libfilodb_partset.so.$$" libfilodb_partset.so
echo "built $(pwd)/libfilodb_partset.so"
